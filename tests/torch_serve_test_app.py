"""The port's copy of ``tests/serve_test_app.py``: an importable Serve
application for the port's declarative-deploy and typed-gRPC tests (the
`import_path` target, like the reference's test config modules), built on
``ray_tpu_torch.serve`` (the reference's module imports ``ray_tpu``, which
the port's workers never import)."""

from ray_tpu_torch import serve


@serve.deployment
class Echo:
    def __call__(self, request):
        return {"echo": getattr(request, "query", {}).get("m", "none")}


app = Echo.bind()


def app_builder():
    return Echo.options(name="BuiltEcho").bind()


# --- typed gRPC fixtures (stand-ins for protoc-generated code) -----------
# Real deployments pass protoc output; these hand-rolled messages expose
# the same surface the generated code uses (FromString / SerializeToString
# + an add_XServicer_to_server registrar), so the typed-servicer plumbing
# is exercised without a .proto compile step in the image.


class TextRequest:
    def __init__(self, text: str = ""):
        self.text = text

    def SerializeToString(self) -> bytes:
        return self.text.encode()

    @classmethod
    def FromString(cls, data: bytes) -> "TextRequest":
        return cls(data.decode())


class TextReply:
    def __init__(self, text: str = "", length: int = 0):
        self.text = text
        self.length = length

    def SerializeToString(self) -> bytes:
        import json as _j

        return _j.dumps({"text": self.text, "length": self.length}).encode()

    @classmethod
    def FromString(cls, data: bytes) -> "TextReply":
        import json as _j

        d = _j.loads(data.decode())
        return cls(d["text"], d["length"])


def add_TextServicer_to_server(servicer, server):
    """Shape of protoc's generated add_XServicer_to_server."""
    import grpc

    handlers = {
        "Upper": grpc.unary_unary_rpc_method_handler(
            servicer.Upper,
            request_deserializer=TextRequest.FromString,
            response_serializer=lambda r: r.SerializeToString(),
        ),
        "Spell": grpc.unary_stream_rpc_method_handler(
            servicer.Spell,
            request_deserializer=TextRequest.FromString,
            response_serializer=lambda r: r.SerializeToString(),
        ),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("test.TextService", handlers),
    ))


@serve.deployment
class TextService:
    """Typed gRPC deployment: methods named after the service's RPCs,
    receiving/returning the proto messages."""

    def Upper(self, request: TextRequest) -> TextReply:
        return TextReply(request.text.upper(), len(request.text))

    def Spell(self, request: TextRequest):
        for ch in request.text:
            yield TextReply(ch, 1)


text_app = TextService.bind()
