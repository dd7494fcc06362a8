"""ASGI bridge for ingress deployments.

Reference parity: ray python/ray/serve/api.py ``@serve.ingress(app)`` +
_private/http_proxy.py:395 (ASGIProxy plumbing) — the reference forwards
raw ASGI scope/receive/send from uvicorn to the replica; here the proxy's
``Request`` envelope is converted to one ASGI HTTP cycle against the
user's app (FastAPI, Starlette, or any ASGI callable) inside the replica,
and the app's response travels back as a ``serve.Response``. The replica
owns the app instance, so stateful apps (startup hooks via the lifespan
protocol, app.state) behave like they would under uvicorn.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict
from urllib.parse import quote, urlencode

from ray_tpu_torch.serve._common import Request, Response

logger = logging.getLogger(__name__)


class ASGIAppRunner:
    """Runs one ASGI app: lifespan startup on first request, then one
    plain HTTP cycle per serve Request."""

    def __init__(self, app: Any):
        self.app = app
        self._lifespan_done = False
        self._lifespan_lock = asyncio.Lock()

    async def _startup(self):
        """Drive the ASGI lifespan protocol once (FastAPI @app.on_event
        startup hooks, Starlette lifespan context). Apps that don't speak
        lifespan raise or hang — treated as 'no lifespan', like uvicorn's
        lifespan=auto."""
        receive_q: asyncio.Queue = asyncio.Queue()
        await receive_q.put({"type": "lifespan.startup"})
        complete = asyncio.get_running_loop().create_future()

        async def receive():
            return await receive_q.get()

        async def send(message):
            if message["type"] in ("lifespan.startup.complete",
                                   "lifespan.startup.failed"):
                if not complete.done():
                    complete.set_result(message)

        async def run():
            try:
                await self.app({"type": "lifespan", "asgi": {"version": "3.0"}},
                               receive, send)
            except BaseException:
                # app has no lifespan support: fine, proceed without
                if not complete.done():
                    complete.set_result({"type": "lifespan.startup.complete"})

        task = asyncio.ensure_future(run())
        try:
            msg = await asyncio.wait_for(asyncio.shield(complete), timeout=10)
            if msg["type"] == "lifespan.startup.failed":
                raise RuntimeError(
                    f"ASGI lifespan startup failed: {msg.get('message', '')}"
                )
        except asyncio.TimeoutError:
            task.cancel()
        # the lifespan task keeps running (it waits for shutdown) — that is
        # the protocol; replica teardown drops it with the event loop

    async def __call__(self, request: Request) -> Response:
        if not self._lifespan_done:
            async with self._lifespan_lock:
                if not self._lifespan_done:
                    await self._startup()
                    self._lifespan_done = True

        prefix = (request.route_prefix or "").rstrip("/")
        path = request.path
        if prefix and path.startswith(prefix):
            # uvicorn --root-path convention: the app sees its own paths,
            # root_path records where it is mounted
            path = path[len(prefix):] or "/"
        # raw wire form when the proxy carried it (duplicate params and
        # percent-encoding intact); urlencode of the parsed dict only as
        # the fallback for hand-built envelopes
        raw_qs = getattr(request, "raw_query_string", None)
        query_string = raw_qs.encode() if raw_qs is not None \
            else urlencode(request.query or {}).encode()
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method.upper(),
            "scheme": "http",
            "path": path,
            "raw_path": quote(path).encode(),
            "root_path": prefix,
            "query_string": query_string,
            "headers": [
                (k.lower().encode(), str(v).encode())
                for k, v in (request.headers or {}).items()
            ],
            "client": ("127.0.0.1", 0),
            "server": ("127.0.0.1", 80),
        }

        sent_body = False

        async def receive():
            nonlocal sent_body
            if not sent_body:
                sent_body = True
                return {"type": "http.request", "body": request.body or b"",
                        "more_body": False}
            # a second receive only ever sees disconnect
            return {"type": "http.disconnect"}

        status = 500
        # list of pairs, NOT a dict: duplicate headers (multiple
        # Set-Cookie) must survive the trip back through the proxy
        headers = []
        chunks = []

        async def send(message):
            nonlocal status
            if message["type"] == "http.response.start":
                status = int(message["status"])
                for k, v in message.get("headers", ()) or ():
                    headers.append((bytes(k).decode("latin1"),
                                    bytes(v).decode("latin1")))
            elif message["type"] == "http.response.body":
                body = message.get("body", b"")
                if body:
                    chunks.append(bytes(body))

        await self.app(scope, receive, send)
        return Response(status=status, headers=headers, body=b"".join(chunks))
