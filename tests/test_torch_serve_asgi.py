"""The port's counterpart of ``tests/test_serve_asgi.py`` (4 cases),
through ``ray_tpu_torch.serve`` with the reference's expected values: every
case is carried under its own name, on ``port_regular`` (the reference's
``serve_cluster`` stands on ``ray_start_regular``).

The reference's description:

ASGI ingress: mounting an existing ASGI application (the FastAPI
shape — routers, path params, lifespan startup, custom status/headers) on
a serve deployment (ray parity: serve.api.ingress +
_private/http_proxy.py:395). fastapi isn't in this image, so the app
under test is a hand-rolled ASGI callable exercising the same protocol
surface FastAPI uses."""

import json

import pytest

from ray_tpu_torch import serve

from tests.torch_fixtures import port_regular  # noqa: F401


def _make_app():
    """Mini ASGI app: /items/{id} with query echo, /state showing lifespan
    startup ran, custom headers, JSON 404 fallback."""
    state = {"started": False}

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    state["started"] = True
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
            return
        assert scope["type"] == "http"
        msg = await receive()
        body = msg.get("body", b"")
        path = scope["path"]
        qs = scope["query_string"].decode()

        async def reply(status, obj, headers=()):
            await send({
                "type": "http.response.start", "status": status,
                "headers": [(b"content-type", b"application/json"),
                            *headers],
            })
            await send({"type": "http.response.body",
                        "body": json.dumps(obj).encode()})

        if path.startswith("/items/") and scope["method"] == "GET":
            item_id = path.split("/")[2]
            await reply(200, {"item_id": item_id, "qs": qs,
                              "root_path": scope.get("root_path", "")},
                        headers=[(b"x-app", b"mini"),
                                 (b"set-cookie", b"session=abc"),
                                 (b"set-cookie", b"csrf=xyz")])
        elif path == "/state":
            await reply(200, {"started": state["started"]})
        elif path == "/echo" and scope["method"] == "POST":
            await reply(201, {"len": len(body)})
        else:
            await reply(404, {"detail": "Not Found"})

    return app


@pytest.fixture
def serve_cluster(port_regular):
    serve.start()
    yield
    serve.shutdown()


def test_asgi_ingress_end_to_end(serve_cluster):
    import urllib.request

    app = _make_app()

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass

    serve.run(Api.bind(), name="api", route_prefix="/api")
    base = f"http://127.0.0.1:{serve.http_port()}"

    # path params + query string + root_path stripping
    with urllib.request.urlopen(base + "/api/items/42?q=hello") as r:
        assert r.status == 200
        assert r.headers["x-app"] == "mini"
        # duplicate headers must BOTH arrive (the multiple-Set-Cookie case)
        cookies = r.headers.get_all("set-cookie")
        assert cookies == ["session=abc", "csrf=xyz"], cookies
        out = json.loads(r.read())
    assert out["item_id"] == "42"
    assert out["qs"] == "q=hello"
    assert out["root_path"] == "/api"

    # lifespan startup hook ran before the first request
    with urllib.request.urlopen(base + "/api/state") as r:
        assert json.loads(r.read()) == {"started": True}

    # request body + non-200 status pass through
    req = urllib.request.Request(base + "/api/echo", data=b"x" * 10,
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        assert r.status == 201
        assert json.loads(r.read()) == {"len": 10}

    # app-level 404 (with the app's body) — not the proxy's 404
    try:
        urllib.request.urlopen(base + "/api/missing")
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404
        assert json.loads(e.read()) == {"detail": "Not Found"}


def test_query_string_fidelity_through_proxy(serve_cluster):
    """ADVICE item: the scope's query_string must be the WIRE form —
    duplicate parameters (?tag=a&tag=b) and percent-encoding previously
    collapsed through the parsed Dict[str, str] + urlencode round trip."""
    import urllib.request
    from urllib.parse import parse_qs

    app = _make_app()

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass

    serve.run(Api.bind(), name="qsapi", route_prefix="/qs")
    base = f"http://127.0.0.1:{serve.http_port()}"

    url = base + "/qs/items/7?tag=a&tag=b&q=a%2Fb%20c&empty="
    with urllib.request.urlopen(url) as r:
        out = json.loads(r.read())
    parsed = parse_qs(out["qs"], keep_blank_values=True)
    # duplicates survive (the dict round trip kept only the last value)
    assert parsed["tag"] == ["a", "b"], out["qs"]
    # percent-encoded reserved chars decode to the original value
    assert parsed["q"] == ["a/b c"], out["qs"]
    assert parsed["empty"] == [""], out["qs"]
    # and the raw string still carries both tag occurrences verbatim
    assert out["qs"].count("tag=") == 2, out["qs"]


def test_asgi_query_string_fallback_without_raw():
    """Hand-built Request envelopes (no proxy) still produce a usable
    query_string from the parsed dict."""
    import asyncio

    from ray_tpu_torch.serve._common import Request
    from ray_tpu_torch.serve.asgi import ASGIAppRunner

    seen = {}

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return
        seen["qs"] = scope["query_string"]
        await receive()
        await send({"type": "http.response.start", "status": 200,
                    "headers": []})
        await send({"type": "http.response.body", "body": b"ok"})

    runner = ASGIAppRunner(app)
    req = Request(method="GET", path="/x", query={"a": "1", "b": "2"})
    assert req.raw_query_string is None  # hand-built: no wire form
    resp = asyncio.run(runner(req))
    assert resp.status == 200
    assert seen["qs"] == b"a=1&b=2"
    # with the wire form present it wins, verbatim
    req2 = Request(method="GET", path="/x", query={"t": "b"},
                   raw_query_string="t=a&t=b")
    asyncio.run(runner(req2))
    assert seen["qs"] == b"t=a&t=b"


def test_asgi_ingress_composes_with_class_state(serve_cluster):
    """The decorated class's own __init__ still runs (the reference
    pattern: FastAPI routes defined on the class via app.get used with
    self-state; here we assert the instance exists alongside the app)."""
    import urllib.request

    inited = []

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            return
        await receive()
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/plain")]})
        await send({"type": "http.response.body", "body": b"ok"})

    @serve.deployment
    @serve.ingress(app)
    class WithState:
        def __init__(self):
            inited.append(True)
            self.x = 7

    serve.run(WithState.bind(), name="ws", route_prefix="/ws")
    base = f"http://127.0.0.1:{serve.http_port()}"
    with urllib.request.urlopen(base + "/ws/") as r:
        assert r.read() == b"ok"
