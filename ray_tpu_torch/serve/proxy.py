"""HTTP ingress proxy.

Reference parity: ray python/ray/serve/_private/http_proxy.py:888
(HTTPProxyActor, ASGI/uvicorn) — here an aiohttp server inside an actor:
requests are matched to the longest route prefix from the controller's
routing table and forwarded to the app's ingress deployment handle; dict/
list/str results render as JSON/text, bytes pass through. Generator
deployments stream chunk-by-chunk over a chunked HTTP response
(http_proxy.py:395), and the route table updates by controller pubsub
push (long_poll.py:186) with a slow poll as the safety net.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time as _time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.serve._common import ROUTES_PUSH_CHANNEL, Request

logger = logging.getLogger(__name__)


class _ProxyMetrics:
    """Per-proxy request metrics (metrics_core.py): latency histogram per
    app + an in-flight gauge the autoscaling ROADMAP item will read."""

    __slots__ = ("latency", "inflight", "_lat")

    def __init__(self):
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        self.latency = reg.histogram(
            "serve_request_latency_seconds",
            "HTTP proxy end-to-end request latency, by app",
            scale=mc.LATENCY)
        self.inflight = reg.gauge(
            "serve_inflight_requests",
            "Requests currently inside this proxy").default
        self._lat: Dict[str, object] = {}

    def lat(self, app: str):
        c = self._lat.get(app)
        if c is None:
            c = self._lat[app] = self.latency.labels(app=app)
        return c


_PROXY_MX: Optional[_ProxyMetrics] = None


def _proxy_metrics() -> _ProxyMetrics:
    global _PROXY_MX
    if _PROXY_MX is None:
        _PROXY_MX = _ProxyMetrics()
    return _PROXY_MX

# with push in place the poll is only a safety net
_ROUTE_POLL_TTL_S = 10.0
_ROUTE_POLL_TTL_UNPUSHED_S = 1.0


class _ForwardingServicer:
    """Stands in for the user's real servicer when a generated
    ``add_XServicer_to_server`` registers methods (ray parity: the
    DummyServicer in serve/_private/grpc_util.py): every method the
    generated code looks up resolves to a forwarder that routes the typed
    request through serve's handle plane."""

    def __init__(self, proxy: "HTTPProxy"):
        self._proxy = proxy

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        proxy = self._proxy

        def forward(request, context):
            import grpc

            meta = dict(context.invocation_metadata() or ())
            try:
                return proxy._grpc_invoke_typed(meta, method_name, request)
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")

        return forward


class HTTPProxy:
    """Per-node ingress actor hosting BOTH protocol servers (ray parity:
    one ProxyActor per node runs the HTTP and gRPC proxies side by side,
    serve/_private/proxy.py): aiohttp for HTTP and a generic grpc server
    for gRPC, sharing one routing table and handle cache."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 grpc_port: Optional[int] = 0,
                 grpc_servicer_functions: Optional[list] = None):
        import concurrent.futures

        self._host = host
        self._port = port
        self._grpc_servicer_functions = list(grpc_servicer_functions or ())
        self._actual_port: Optional[int] = None
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._routes_fetched_at = 0.0
        self._push_subscribed = False
        self._handles = {}
        # dedicated pool: the default asyncio executor is ~32 threads, and
        # every in-flight request blocks one for up to its full timeout
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=256, thread_name_prefix="serve-proxy"
        )
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._grpc_actual_port: Optional[int] = None
        if grpc_port is not None:
            self._start_grpc(host, grpc_port)
        self._subscribe_push()

    def ready(self) -> int:
        self._ready.wait(timeout=30)
        assert self._actual_port is not None, "proxy failed to bind"
        return self._actual_port

    def grpc_port(self) -> Optional[int]:
        return self._grpc_actual_port

    def node_id(self) -> str:
        import ray_tpu_torch

        return ray_tpu_torch.get_runtime_context().get_node_id()

    # ------------------------------------------------------------------
    # gRPC ingress (ray parity: serve/_private/grpc_util.py + the gRPC
    # proxy in serve/_private/proxy.py; drivers.py gRPCIngress). A
    # GENERIC handler serves /ray_tpu_torch.serve.Ingress/Call for any app:
    # request bytes are pickled (args, kwargs) or raw bytes, the target
    # app comes from the "application" metadata key (falling back to the
    # root route), and the reply is the pickled handler result.
    # ------------------------------------------------------------------
    def _start_grpc(self, host: str, port: int):
        try:
            import grpc
        except Exception:
            return  # image without grpcio: HTTP-only proxy
        import concurrent.futures as cf

        outer = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, hcd):
                # claim ONLY the generic ingress service; returning None
                # lets gRPC fall through to the typed servicers the user
                # registered via grpc_servicer_functions
                if not hcd.method.startswith("/ray_tpu_torch.serve.Ingress/"):
                    return None

                def unary(request_bytes, context):
                    meta = dict(context.invocation_metadata() or ())
                    try:
                        return outer._grpc_call(meta, request_bytes)
                    except Exception as e:  # noqa: BLE001
                        context.abort(
                            grpc.StatusCode.INTERNAL,
                            f"{type(e).__name__}: {e}",
                        )

                def streaming(request_bytes, context):
                    meta = dict(context.invocation_metadata() or ())
                    try:
                        yield from outer._grpc_stream(
                            meta, request_bytes
                        )
                    except Exception as e:  # noqa: BLE001
                        context.abort(
                            grpc.StatusCode.INTERNAL,
                            f"{type(e).__name__}: {e}",
                        )

                if hcd.method.endswith("/Stream"):
                    # server streaming: one pickled message per yielded
                    # chunk of a generator deployment
                    return grpc.unary_stream_rpc_method_handler(
                        streaming,
                        request_deserializer=None,
                        response_serializer=None,
                    )
                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,  # raw bytes in
                    response_serializer=None,  # raw bytes out
                )

        server = grpc.server(cf.ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="serve-grpc"
        ))
        server.add_generic_rpc_handlers((_Handler(),))
        # Typed servicers (ray parity: gRPCOptions.grpc_servicer_functions
        # + the DummyServicer in serve/_private/grpc_util.py): each entry
        # is a protoc-generated ``add_XServicer_to_server`` function (or
        # its "module:attr" import path). It registers REAL method
        # handlers with the generated proto (de)serializers around a
        # forwarding servicer, so clients use their generated stubs and
        # replicas receive/return actual proto messages; the RPC method
        # name selects the deployment method of the same name.
        for entry in self._grpc_servicer_functions:
            try:
                add_fn = self._resolve_servicer_fn(entry)
                add_fn(_ForwardingServicer(self), server)
            except Exception:
                logger.exception(
                    "failed to register gRPC servicer %r", entry
                )
        bound = server.add_insecure_port(f"{host}:{port}")
        if bound == 0 and port != 0:
            bound = server.add_insecure_port(f"{host}:0")
        server.start()
        self._grpc_server = server
        self._grpc_actual_port = bound

    @staticmethod
    def _resolve_servicer_fn(entry):
        """A servicer entry is a callable or a 'module:attr' /
        'module.attr' import path (entries cross actor boundaries as
        strings, like the reference's grpc_servicer_functions)."""
        if callable(entry):
            return entry
        import importlib

        s = str(entry)
        if ":" in s:
            mod, attr = s.split(":", 1)
        else:
            mod, _, attr = s.rpartition(".")
        return getattr(importlib.import_module(mod), attr)

    def _grpc_route(self, app_name: Optional[str]):
        """Resolve the target (app, ingress) handle: "application"
        metadata first, else the app mounted at "/"."""

        def find_target():
            if app_name:
                for _prefix, (app, ingress) in self._routes.items():
                    if app == app_name:
                        return (app, ingress)
                return None
            m = self._match("/")
            return m[1] if m else None

        self._refresh_routes_sync()
        target = find_target()
        if target is None:
            # just deployed and the push was lost: force one refresh
            # before failing (mirrors the HTTP handler's 404 path)
            self._refresh_routes_sync(force=True)
            target = find_target()
        if target is None:
            raise KeyError(f"no serve app for {app_name or '/'}")
        handle = self._handles.get(target)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(target[1], target[0])
            self._handles[target] = handle
        return handle

    def _grpc_invoke_typed(self, meta: dict, method_name: str, request):
        """Typed servicer path: the deserialized proto message goes to the
        deployment method NAMED LIKE THE RPC; the return value (a response
        proto) serializes back through the generated serializer. Generator
        deployments surface as an iterator of protos (server streaming)."""
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import STREAM_MARKER

        handle = self._grpc_route(meta.get("application"))
        h = getattr(handle, method_name)
        result = ray_tpu_torch.get(h.remote(request).ref, timeout=60)
        if isinstance(result, dict) and STREAM_MARKER in result:
            return self._iter_stream_items(result[STREAM_MARKER])
        return result

    def _iter_stream_items(self, info: dict):
        """Yield a generator deployment's items as-is (typed gRPC
        streaming: each yielded item is already a response proto)."""
        import ray_tpu_torch

        from ray_tpu_torch.serve._common import SERVE_NAMESPACE

        replica = ray_tpu_torch.get_actor(info["replica"],
                                    namespace=SERVE_NAMESPACE)
        sid = info["stream_id"]
        try:
            while True:
                items, done = ray_tpu_torch.get(
                    replica.next_chunks.remote(sid), timeout=60
                )
                yield from items
                if done:
                    return
        except BaseException:
            try:
                replica.cancel_stream.remote(sid)
            except Exception:
                pass
            raise

    def _grpc_invoke(self, meta: dict, request_bytes: bytes):
        """Shared routing + invocation for both gRPC shapes: returns the
        RAW handler result (a stream-marker dict for generators)."""
        import pickle

        import ray_tpu_torch

        handle = self._grpc_route(meta.get("application"))
        try:
            payload = pickle.loads(request_bytes)
        except Exception:
            payload = ((request_bytes,), {})
        if (isinstance(payload, tuple) and len(payload) == 2
                and isinstance(payload[0], tuple)
                and isinstance(payload[1], dict)):
            args, kwargs = payload
        else:
            args, kwargs = (payload,), {}
        call_method = meta.get("method")
        h = getattr(handle, call_method) if call_method else handle
        return ray_tpu_torch.get(h.remote(*args, **kwargs).ref, timeout=60)

    def _grpc_call(self, meta: dict, request_bytes: bytes):
        import pickle

        from ray_tpu_torch.serve.replica import STREAM_MARKER

        result = self._grpc_invoke(meta, request_bytes)
        if isinstance(result, dict) and STREAM_MARKER in result:
            # generator deployment: unary gRPC drains the whole stream
            # and returns the concatenated output (never the internal
            # stream marker)
            result = self._drain_stream(result[STREAM_MARKER])
        return pickle.dumps(result)

    def _grpc_stream(self, meta: dict, request_bytes: bytes):
        """Server-streaming: one pickled message per yielded chunk of a
        generator deployment, emitted as the replica produces them (ray
        parity: the gRPC proxy's streaming RPCs). Non-generator results
        stream as a single message."""
        import pickle

        import ray_tpu_torch

        from ray_tpu_torch.serve.replica import STREAM_MARKER

        result = self._grpc_invoke(meta, request_bytes)
        if not (isinstance(result, dict) and STREAM_MARKER in result):
            yield pickle.dumps(result)
            return
        for item in self._iter_stream_items(result[STREAM_MARKER]):
            yield pickle.dumps(item)

    def _drain_stream(self, info: dict):
        out = list(self._iter_stream_items(info))
        if out and all(isinstance(i, bytes) for i in out):
            return b"".join(out)
        if out and all(isinstance(i, str) for i in out):
            return "".join(out)
        return out

    def _refresh_routes_sync(self, force: bool = False):
        import time

        import ray_tpu_torch

        self._subscribe_push()
        ttl = _ROUTE_POLL_TTL_S if self._push_subscribed else \
            _ROUTE_POLL_TTL_UNPUSHED_S
        if not force and time.monotonic() - self._routes_fetched_at < ttl:
            return
        from ray_tpu_torch.serve._common import SERVE_NAMESPACE

        controller = ray_tpu_torch.get_actor(
            "SERVE_CONTROLLER", namespace=SERVE_NAMESPACE)
        self._routes = ray_tpu_torch.get(controller.get_routes.remote(), timeout=10)
        self._routes_fetched_at = time.monotonic()

    # ------------------------------------------------------------------
    def _serve(self):
        asyncio.run(self._serve_async())

    async def _serve_async(self):
        from aiohttp import web

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        runner = web.AppRunner(app)
        await runner.setup()
        port = self._port
        site = None
        for attempt in range(20):
            try:
                site = web.TCPSite(runner, self._host, port)
                await site.start()
                break
            except OSError:
                port += 1
                site = None
        assert site is not None, "no free port for serve proxy"
        self._actual_port = port
        self._ready.set()
        while True:
            await asyncio.sleep(3600)

    # ------------------------------------------------------------------
    def _subscribe_push(self):
        """Route-table changes arrive by controller push; the TTL poll
        stays as the fallback (and primary path until connected)."""
        if self._push_subscribed:
            return
        try:
            import time

            from ray_tpu_torch._private.worker import global_worker

            def on_push(msg):
                routes = msg.get("routes")
                if isinstance(routes, dict):
                    self._routes = {
                        k: tuple(v) for k, v in routes.items()
                    }
                    self._routes_fetched_at = time.monotonic()

            global_worker.core_worker.subscribe(ROUTES_PUSH_CHANNEL, on_push)
            self._push_subscribed = True
        except Exception:
            pass

    async def _refresh_routes(self, force: bool = False):
        import time

        import ray_tpu_torch

        self._subscribe_push()
        ttl = _ROUTE_POLL_TTL_S if self._push_subscribed else \
            _ROUTE_POLL_TTL_UNPUSHED_S
        if not force and time.monotonic() - self._routes_fetched_at < ttl:
            return
        loop = asyncio.get_running_loop()

        def fetch():
            from ray_tpu_torch.serve._common import SERVE_NAMESPACE

            controller = ray_tpu_torch.get_actor(
                "SERVE_CONTROLLER", namespace=SERVE_NAMESPACE)
            return ray_tpu_torch.get(controller.get_routes.remote(), timeout=10)

        self._routes = await loop.run_in_executor(self._pool, fetch)
        self._routes_fetched_at = time.monotonic()

    def _match(self, path: str):
        best = None
        for prefix, target in self._routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                norm + ("" if norm == "/" else "/")
            ) or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, target)
        return best

    async def _handle(self, request):
        mx = _proxy_metrics()
        mx.inflight.inc()
        t0 = _time.perf_counter()
        app_name = "?"
        try:
            resp, app_name = await self._handle_inner(request)
            return resp
        finally:
            mx.inflight.dec()
            mx.lat(app_name).record(_time.perf_counter() - t0)

    async def _handle_inner(self, request):
        from aiohttp import web

        from ray_tpu_torch._private import reqtrace
        from ray_tpu_torch.serve.replica import STREAM_MARKER

        # request observatory: mint the id every hop joins on; the
        # ingress span covers route match + body read, and the id is
        # echoed back as x-request-id so clients (and the load harness)
        # can correlate a slow response with its merged trace row
        t_recv = _time.time()
        rid = reqtrace.new_request_id() if reqtrace.is_enabled() else ""
        await self._refresh_routes()
        m = self._match(request.path)
        if m is None:
            # maybe just deployed: force one refresh before 404ing
            await self._refresh_routes(force=True)
            m = self._match(request.path)
        if m is None:
            return web.Response(status=404, text="no app at this route"), "?"
        _prefix, (app_name, ingress) = m
        body = await request.read()
        env = Request(
            method=request.method,
            path=request.path,
            query=dict(request.query),
            headers=dict(request.headers),
            body=body,
            route_prefix="" if _prefix == "/" else _prefix,
            # verbatim wire form: duplicate params + percent-encoding
            # must reach the mounted ASGI app intact
            raw_query_string=request.query_string,
        )
        if rid:
            reqtrace.record_span(rid, "ingress", t_recv, _time.time(),
                                 app=app_name, deployment=ingress)
        key = (app_name, ingress)
        handle = self._handles.get(key)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(ingress, app_name)
            self._handles[key] = handle
        # a cheap per-request derivative (shared router state) carrying
        # the minted id into the handle→replica RPC envelope
        h = handle.options(_request_id=rid) if rid else handle
        loop = asyncio.get_running_loop()

        def call():
            import ray_tpu_torch

            # a replica can die between routing and execution (rolling
            # update, crash) — retry on a freshly-refreshed replica set.
            # Read through .ref, not .result(): the proxy is the one caller
            # that consumes the internal stream marker itself.
            last = None
            for _attempt in range(3):
                try:
                    return ray_tpu_torch.get(h.remote(env).ref, timeout=60)
                except Exception as e:  # noqa: BLE001
                    last = e
                    if "ActorDied" not in str(type(e).__name__) + str(e):
                        raise
                    handle._refresh(force=True)
            raise last

        try:
            result = await loop.run_in_executor(self._pool, call)
        except Exception as e:  # noqa: BLE001 — surface as 500/503
            from ray_tpu_torch.serve._common import is_overloaded_error

            if is_overloaded_error(e):
                # typed load-shed from admission control (LLM engine
                # bounded queue / KV budget): 503 tells the client this
                # is transient backpressure, not a broken handler
                return web.Response(
                    status=503, headers={"Retry-After": "1"},
                    text=f"{type(e).__name__}: {e}"), app_name
            return web.Response(status=500,
                                text=f"{type(e).__name__}: {e}"), app_name
        if isinstance(result, dict) and STREAM_MARKER in result:
            return await self._stream_response(
                request, result[STREAM_MARKER], rid=rid, app=app_name,
                deployment=ingress), app_name
        t_ser = _time.time()
        resp = self._render_response(result)
        if rid:
            resp.headers["x-request-id"] = rid
            reqtrace.record_span(rid, "serialize", t_ser, _time.time(),
                                 app=app_name, deployment=ingress)
        return resp, app_name

    @staticmethod
    def _render_response(result):
        """Handler result -> aiohttp response (the serialize phase)."""
        from aiohttp import web

        from ray_tpu_torch.serve._common import Response as ServeResponse

        if isinstance(result, ServeResponse):
            # full-control response (ASGI ingress): status + headers pass
            # through — as a multidict so duplicate Set-Cookie survive;
            # strip hop-by-hop/length headers aiohttp recomputes
            from multidict import CIMultiDict

            headers = CIMultiDict(
                (k, v) for k, v in result.header_items()
                if k.lower() not in ("content-length", "transfer-encoding")
            )
            return web.Response(status=result.status, headers=headers,
                                body=result.body)
        if isinstance(result, bytes):
            return web.Response(body=result)
        if isinstance(result, str):
            return web.Response(text=result)
        return web.json_response(
            result, dumps=lambda o: json.dumps(o, default=str))

    async def _stream_response(self, request, info, rid: str = "",
                               app: str = "", deployment: str = ""):
        """Chunked transfer of a generator deployment's output: each chunk
        flushes as the replica yields it, so clients read tokens while the
        handler is still running (ray parity: http_proxy.py:395). The
        request observatory marks the first and last byte flushed, making
        streaming TTFT a first-class number."""
        import ray_tpu_torch
        from aiohttp import web

        from ray_tpu_torch._private import reqtrace

        from ray_tpu_torch.serve._common import SERVE_NAMESPACE, \
            is_overloaded_error

        replica = ray_tpu_torch.get_actor(info["replica"],
                                    namespace=SERVE_NAMESPACE)
        sid = info["stream_id"]
        loop = asyncio.get_running_loop()

        def _fetch():
            return ray_tpu_torch.get(replica.next_chunks.remote(sid), timeout=60)

        # first batch BEFORE committing status/headers: a generator that
        # fails before its first yield (admission shed, bad request) must
        # surface as a real 503/500, not a 200 with an error marker
        try:
            items, done = await loop.run_in_executor(self._pool, _fetch)
        except Exception as e:  # noqa: BLE001
            try:
                replica.cancel_stream.remote(sid)
            except Exception:
                pass
            if is_overloaded_error(e):
                return web.Response(status=503,
                                    headers={"Retry-After": "1"},
                                    text=f"{type(e).__name__}: {e}")
            return web.Response(status=500,
                                text=f"{type(e).__name__}: {e}")
        resp = web.StreamResponse()
        resp.headers["Content-Type"] = "text/plain; charset=utf-8"
        if rid:
            resp.headers["x-request-id"] = rid
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        first_byte_sent = False
        try:
            while True:
                for item in items:
                    if isinstance(item, bytes):
                        chunk = item
                    elif isinstance(item, str):
                        chunk = item.encode()
                    else:
                        chunk = (json.dumps(item, default=str) + "\n").encode()
                    await resp.write(chunk)
                    if rid and not first_byte_sent:
                        first_byte_sent = True
                        reqtrace.record_mark(
                            rid, "first_byte", _time.time(), app=app,
                            deployment=deployment,
                            replica=info.get("replica") or "")
                if done:
                    break
                items, done = await loop.run_in_executor(
                    self._pool, _fetch)
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            # headers are gone; best we can do is terminate with a marker
            try:
                await resp.write(f"\n[stream error: {e}]".encode())
            except Exception:
                pass
            try:
                replica.cancel_stream.remote(sid)
            except Exception:
                pass
        await resp.write_eof()
        if rid:
            reqtrace.record_mark(rid, "last_byte", _time.time(), app=app,
                                 deployment=deployment,
                                 replica=info.get("replica") or "")
        return resp
