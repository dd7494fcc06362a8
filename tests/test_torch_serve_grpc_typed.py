"""The port's counterpart of ``tests/test_serve_grpc_typed.py`` (3 cases),
through ``ray_tpu_torch.serve`` with the reference's expected values: every
case is carried under its own name, on ``port_regular`` where the reference
takes ``ray_start_regular``. The servicer and the application come from the
port's copy of the reference's module, ``tests/torch_serve_test_app.py``.

The reference's description:

Typed gRPC ingress: user servicer registration via generated-style
``add_XServicer_to_server`` functions (ray parity:
serve.config.gRPCOptions.grpc_servicer_functions + the DummyServicer in
serve/_private/grpc_util.py). Clients call typed stubs with proto
(de)serializers; deployments receive/return message objects."""

import grpc
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from tests.torch_fixtures import port_regular  # noqa: F401
from tests.torch_serve_test_app import TextReply, TextRequest, text_app


@pytest.fixture
def typed_serve(port_regular):
    serve.start(grpc_options={
        "grpc_servicer_functions": [
            "tests.torch_serve_test_app:add_TextServicer_to_server",
        ],
    })
    serve.run(text_app, name="textapp", route_prefix="/")
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    proxies = ray_tpu_torch.get(controller.get_proxies.remote(), timeout=30)
    port = next(iter(proxies.values()))["grpc_port"]
    assert port, "gRPC proxy did not start"
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield channel
    channel.close()
    serve.shutdown()


def test_typed_unary_call(typed_serve):
    stub = typed_serve.unary_unary(
        "/test.TextService/Upper",
        request_serializer=lambda r: r.SerializeToString(),
        response_deserializer=TextReply.FromString,
    )
    reply = stub(TextRequest("hello"), timeout=60,
                 metadata=(("application", "textapp"),))
    assert reply.text == "HELLO"
    assert reply.length == 5


def test_typed_server_streaming(typed_serve):
    stub = typed_serve.unary_stream(
        "/test.TextService/Spell",
        request_serializer=lambda r: r.SerializeToString(),
        response_deserializer=TextReply.FromString,
    )
    out = [r.text for r in stub(TextRequest("abc"), timeout=60,
                                metadata=(("application", "textapp"),))]
    assert out == ["a", "b", "c"]


def test_typed_unknown_app_not_found(typed_serve):
    stub = typed_serve.unary_unary(
        "/test.TextService/Upper",
        request_serializer=lambda r: r.SerializeToString(),
        response_deserializer=TextReply.FromString,
    )
    with pytest.raises(grpc.RpcError) as err:
        stub(TextRequest("x"), timeout=30,
             metadata=(("application", "nope"),))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
