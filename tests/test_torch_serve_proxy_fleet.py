"""The port's counterpart of ``tests/test_serve_proxy_fleet.py`` (2 cases),
through ``ray_tpu_torch.serve`` with the reference's expected values: every
case is carried under its own name, on ``port_cluster`` where the reference
takes ``ray_start_cluster``. The port's generic gRPC service is
``ray_tpu_torch.serve.Ingress``.

The reference's description:

Per-node proxy fleet + gRPC ingress (analog of ray:
serve/_private/proxy_state.py tests + test_grpc proxy tests)."""

import time

import pytest
import requests

import ray_tpu_torch
from ray_tpu_torch import serve

from tests.torch_fixtures import port_cluster  # noqa: F401


def _controller():
    return ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")


def test_proxy_fleet_multi_node_and_grpc(port_cluster):
    cluster = port_cluster
    cluster.add_node(num_cpus=2)  # becomes the head node
    cluster.add_node(num_cpus=2, resources={"nodeB": 1.0})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    serve.start()
    try:
        @serve.deployment(num_replicas=1)
        class Echo:
            def __call__(self, arg):
                if isinstance(arg, serve.Request):
                    return {"path": arg.path}
                return {"echo": arg}

        serve.run(Echo.bind(), name="default", route_prefix="/")

        # One proxy per alive node.
        ctrl = _controller()
        deadline = time.monotonic() + 60
        proxies = {}
        while time.monotonic() < deadline and len(proxies) < 2:
            proxies = ray_tpu_torch.get(ctrl.get_proxies.remote(), timeout=30)
            time.sleep(1.0)
        assert len(proxies) == 2, proxies

        # Requests through EVERY node's proxy reach the app.
        for nid, info in proxies.items():
            r = requests.get(f"http://127.0.0.1:{info['port']}/ping",
                             timeout=30)
            assert r.status_code == 200, (nid, r.text)
            assert r.json()["path"] == "/ping"

        # gRPC ingress on each proxy: pickled (args, kwargs) in, pickled
        # result out, routed by "application" metadata.
        import pickle

        import grpc

        info = next(iter(proxies.values()))
        assert info["grpc_port"], info
        channel = grpc.insecure_channel(f"127.0.0.1:{info['grpc_port']}")
        call = channel.unary_unary(
            "/ray_tpu_torch.serve.Ingress/Call",
            request_serializer=None, response_deserializer=None,
        )
        reply = call(pickle.dumps((("hello-grpc",), {})),
                     metadata=(("application", "default"),), timeout=60)
        assert pickle.loads(reply) == {"echo": "hello-grpc"}
        channel.close()

        # Kill one proxy: the app stays reachable through the OTHER
        # proxy, and the controller restarts the dead one.
        victim_nid, victim = next(iter(proxies.items()))
        other = [v for k, v in proxies.items() if k != victim_nid][0]
        ray_tpu_torch.kill(
            ray_tpu_torch.get_actor(victim["name"], namespace="serve"))
        r = requests.get(f"http://127.0.0.1:{other['port']}/alive",
                         timeout=30)
        assert r.status_code == 200

        deadline = time.monotonic() + 90
        revived = None
        while time.monotonic() < deadline:
            cur = ray_tpu_torch.get(ctrl.get_proxies.remote(), timeout=30)
            ent = cur.get(victim_nid)
            if ent is not None:
                try:
                    r = requests.get(
                        f"http://127.0.0.1:{ent['port']}/back", timeout=10
                    )
                    if r.status_code == 200:
                        revived = ent
                        break
                except Exception:
                    pass
            time.sleep(1.5)
        assert revived is not None, "killed proxy was not restarted"
    finally:
        serve.shutdown()


def test_grpc_streaming(port_cluster):
    """Server-streaming gRPC: a generator deployment's chunks arrive as
    individual messages (not one drained blob)."""
    import pickle

    import grpc

    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)
    serve.start()
    try:
        @serve.deployment(num_replicas=1)
        class Tokens:
            def __call__(self, n):
                for i in range(int(n)):
                    yield f"tok{i}"

        serve.run(Tokens.bind(), name="default", route_prefix="/")
        ctrl = _controller()
        info = next(iter(
            ray_tpu_torch.get(ctrl.get_proxies.remote(), timeout=30).values()
        ))
        channel = grpc.insecure_channel(f"127.0.0.1:{info['grpc_port']}")
        stream = channel.unary_stream(
            "/ray_tpu_torch.serve.Ingress/Stream",
            request_serializer=None, response_deserializer=None,
        )
        chunks = [pickle.loads(m) for m in stream(
            pickle.dumps(((4,), {})),
            metadata=(("application", "default"),), timeout=60,
        )]
        assert chunks == ["tok0", "tok1", "tok2", "tok3"]

        # non-generator target: single message
        @serve.deployment(num_replicas=1)
        class One:
            def __call__(self, x):
                return {"v": x}

        serve.run(One.bind(), name="one", route_prefix="/one")
        chunks = [pickle.loads(m) for m in stream(
            pickle.dumps((("a",), {})),
            metadata=(("application", "one"),), timeout=60,
        )]
        assert chunks == [{"v": "a"}]
        channel.close()
    finally:
        serve.shutdown()
