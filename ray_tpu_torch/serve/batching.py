"""@serve.batch — coalesce concurrent single calls into one batched call.

Reference parity: ray python/ray/serve/batching.py — an async decorator:
callers await individual results; the wrapper buffers requests until
``max_batch_size`` or ``batch_wait_timeout_s`` and invokes the wrapped
function once with the list, distributing results back per-caller.

Observability: every flush records a per-item ``batch_wait`` span
(submit → flush) into the request observatory under the caller's request
id (read from ``reqtrace.CURRENT`` — set by the replica around user code,
propagated here through the await chain), plus three /metrics histograms
tagged by batch key: ``serve_batch_size``, ``serve_batch_occupancy``
(size / max_batch_size — how full the window ran) and
``serve_batch_wait_seconds`` (per-item window wait).
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Any, Callable, List, Optional


class _BatchMetrics:
    """Lazily-created batch histogram families (metrics_core.py).
    Children are resolved per flush so the deployment/replica identity —
    known only from the request context riding the flush — lands as
    tags next to the batch key."""

    __slots__ = ("size", "occupancy", "wait")

    def __init__(self):
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        self.size = reg.histogram(
            "serve_batch_size",
            "items per flushed @serve.batch batch",
            scale=mc.SIZE)
        self.occupancy = reg.histogram(
            "serve_batch_occupancy",
            "flushed batch size / max_batch_size (0..1)",
            scale=mc.LATENCY)
        self.wait = reg.histogram(
            "serve_batch_wait_seconds",
            "per-item wait from submit to batch flush",
            scale=mc.LATENCY)


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float,
                 key: str = ""):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.key = key
        self.pending: List[tuple] = []  # (item, future, req_ctx, t_enq)
        self.flusher: Optional[asyncio.Task] = None
        self._metrics: Optional[_BatchMetrics] = None
        self._metrics_failed = False

    def _mx(self) -> Optional[_BatchMetrics]:
        if self._metrics is None and not self._metrics_failed:
            try:
                self._metrics = _BatchMetrics()
            except Exception:
                self._metrics_failed = True
        return self._metrics

    async def submit(self, item: Any):
        from ray_tpu_torch._private import reqtrace

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # the replica set CURRENT around user code; it propagated here
        # through the await chain, so the flush can attribute this item's
        # window wait to its request id
        ctx = reqtrace.CURRENT.get() if reqtrace.is_enabled() else None
        self.pending.append((item, fut, ctx, time.time()))
        if len(self.pending) >= self.max_batch_size:
            await self._flush()
        elif self.flusher is None or self.flusher.done():
            self.flusher = loop.create_task(self._delayed_flush())
        return await fut

    async def _delayed_flush(self):
        await asyncio.sleep(self.timeout_s)
        await self._flush()

    def _record_formation(self, batch: List[tuple], t_flush: float):
        """Per-item batch_wait spans + size/occupancy/wait histograms.
        Tags come from the first request context riding the flush (all
        items of one queue share a replica), falling back to bare key
        tags for batches formed outside a serve request."""
        from ray_tpu_torch._private import reqtrace

        mx = self._mx()
        first_ctx = next((b[2] for b in batch if b[2]), None)
        if mx is not None:
            _rid0, app, deployment, replica = first_ctx or \
                ("", "?", "?", "?")
            tags = {"key": self.key, "app": app or "?",
                    "deployment": deployment or "?",
                    "replica": replica or "?"}
            mx.size.labels(**tags).record(len(batch))
            mx.occupancy.labels(**tags).record(
                len(batch) / max(1, self.max_batch_size))
            wait_child = mx.wait.labels(**tags)
        for _item, _fut, ctx, t_enq in batch:
            if mx is not None:
                wait_child.record(max(0.0, t_flush - t_enq))
            if ctx:
                rid, app, deployment, replica = ctx
                reqtrace.record_span(
                    rid, "batch_wait", t_enq, t_flush,
                    app=app, deployment=deployment, replica=replica,
                    detail={"key": self.key, "size": len(batch)})

    async def _flush(self):
        if not self.pending:
            return
        batch, self.pending = self.pending, []
        try:
            self._record_formation(batch, time.time())
        except Exception:
            pass  # telemetry must never fail a batch
        items = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        try:
            out = self.fn(items)
            if asyncio.iscoroutine(out):
                out = await out
            if len(out) != len(items):
                raise ValueError(
                    f"batched function returned {len(out)} results for "
                    f"{len(items)} inputs"
                )
            for f, r in zip(futs, out):
                if not f.done():
                    f.set_result(r)
        except Exception as e:  # noqa: BLE001 — propagate per-caller
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01, **_ignored):
    """ray parity: @serve.batch."""

    def decorate(fn):
        queues = {}  # per (instance or None)
        key = getattr(fn, "__qualname__", None) or getattr(
            fn, "__name__", "batch")

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                inst, item = args
                call = functools.partial(fn, inst)
                qkey = id(inst)
            else:
                (item,) = args
                call = fn
                qkey = None
            q = queues.get(qkey)
            if q is None:
                q = _BatchQueue(call, max_batch_size,
                                batch_wait_timeout_s, key=key)
                queues[qkey] = q
            return await q.submit(item)

        return wrapper

    if _func is not None:
        return decorate(_func)
    return decorate
