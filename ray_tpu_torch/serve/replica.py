"""Replica actor: hosts one instance of a deployment's user class/function.

Reference parity: ray python/ray/serve/_private/replica.py:447
(RayServeReplica) — the replica counts ongoing requests (the router and
autoscaler read this), supports reconfigure(user_config), health checks,
and graceful drain on shutdown. Generator callables stream: the replica
runs the generator and buffers chunks per stream; callers (handle /
HTTP proxy) drain them with ``next_chunks`` (ray parity:
_private/http_proxy.py:395 streaming responses over ObjectRefGenerator —
here a pull protocol over actor calls, which keeps chunk delivery ordered
and backpressured without generator actor tasks).
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

STREAM_MARKER = "__serve_stream__"

# Cap buffered chunks per stream: a producer far ahead of a slow consumer
# must block (backpressure), not buffer the whole response.
_STREAM_BUFFER = 64

# A stream untouched this long (consumer gone without cancel_stream — e.g.
# its process died) is reaped so its producer stops and the ongoing count
# and pool thread are released.
_STREAM_TTL_S = 120.0


class _Stream:
    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=_STREAM_BUFFER)
        self.done = False
        self.done_event = asyncio.Event()
        self.cancelled = False
        self.error: Optional[str] = None
        self.last_touch = time.time()


class Replica:
    def __init__(self, serialized_init: bytes, deployment: str, app: str,
                 user_config: Optional[Any] = None,
                 max_ongoing_requests: int = 100,
                 replica_name: Optional[str] = None):
        import cloudpickle
        import concurrent.futures

        cls_or_fn, init_args, init_kwargs = cloudpickle.loads(serialized_init)
        self._deployment = deployment
        self._app = app
        self._name = replica_name
        self._ongoing = 0
        self._total = 0
        # requests admitted (handle_request entered) but not yet in user
        # code: the pool-queue/backlog depth the queue-depth gauge and
        # the reqtrace "queue" span measure
        self._queued = 0
        # sync user callables run here so concurrent requests don't
        # serialize on the actor's event loop
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(max_ongoing_requests, 32),
            thread_name_prefix="serve-replica",
        )
        self._streams: Dict[int, _Stream] = {}
        self._stream_ids = itertools.count()
        self._streams_lock = threading.Lock()
        if inspect.isclass(cls_or_fn):
            from ray_tpu_torch.serve import _common
            _common.CURRENT_REPLICA_CONTEXT = {
                "app": app, "deployment": deployment,
                "replica": replica_name or "",
            }
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = cls_or_fn
            self._is_function = True
        if user_config is not None:
            self.reconfigure(user_config)
        self._setup_metrics()

    def _setup_metrics(self):
        """Replica-side metrics (metrics_core.py): request latency per
        deployment + an ongoing-requests gauge (the queue-depth signal
        autoscaling reads). The replica runs in its own worker process,
        so the cluster scrape reaches these through its raylet."""
        try:
            from ray_tpu_torch._private import metrics_core as mc

            reg = mc.registry()
            tags = {"app": self._app, "deployment": self._deployment}
            self._m_latency = reg.histogram(
                "serve_replica_request_seconds",
                "Replica request handling latency, by deployment",
                scale=mc.LATENCY).labels(**tags)
            reg.gauge("serve_replica_ongoing_requests",
                      "Requests in flight inside the replica"
                      ).labels(**tags).set_fn(lambda: self._ongoing)
            reg.gauge("serve_replica_queue_depth",
                      "Work queued in the replica: pool backlog, or the "
                      "user callable's own queue (e.g. queued sequences "
                      "on an LLM replica) via __serve_queue_depth__"
                      ).labels(replica=self._name or "?", **tags
                               ).set_fn(lambda: self._queue_depth())
            reg.gauge("serve_replica_total_requests",
                      "Requests handled by the replica (monotonic)"
                      ).labels(**tags).set_fn(lambda: self._total)
        except Exception:
            self._m_latency = None

    # -- control plane --------------------------------------------------
    def reconfigure(self, user_config: Any):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def _queue_depth(self) -> int:
        """Queued work. A callable exposing ``__serve_queue_depth__``
        (the LLM engine does) overrides the HTTP pool backlog: a
        streaming LLM replica holds ~0 unstarted requests while its
        sequence queue is deep — autoscaling and routing must see the
        sequences, not the empty pool."""
        hook = getattr(self._callable, "__serve_queue_depth__", None)
        if hook is not None:
            try:
                return int(hook())
            except Exception:
                pass
        return self._queued

    def get_metrics(self) -> Dict[str, float]:
        out = {"ongoing": self._ongoing, "total": self._total}
        # LLM engine ride-along (sequence load + prefix digest for the
        # affinity router); plain callables return the legacy dict
        # byte-identically
        hook = getattr(self._callable, "__serve_llm_report__", None)
        if hook is not None:
            try:
                report = hook()
                out["llm"] = report
                # sequence load is the meaningful routing/autoscaling
                # signal for an engine replica: streams in flight all
                # look "ongoing" even when the batch is full
                out["ongoing"] = float(
                    report.get("running_seqs", 0)
                    + report.get("queued_seqs", 0)) or out["ongoing"]
            except Exception:
                pass
        return out

    def prepare_shutdown(self, timeout_s: float = 5.0) -> bool:
        """Drain: wait for ongoing requests to finish."""
        deadline = time.time() + timeout_s
        while self._ongoing > 0 and time.time() < deadline:
            time.sleep(0.02)
        return True

    # -- data plane -----------------------------------------------------
    def _target(self, method_name: str):
        if self._is_function:
            return self._callable
        if method_name in ("__call__", None):
            return self._callable
        return getattr(self._callable, method_name)

    async def handle_request(self, method_name: str, args: tuple,
                             kwargs: dict, meta: Optional[dict] = None):
        from ray_tpu_torch._private import reqtrace

        self._reap_stale_streams()
        # request-observatory identity threaded through the RPC envelope
        # by the handle: rid joins this hop's spans with the proxy's, ts
        # is the caller-clock send time the queue-wait span starts at
        rid = (meta or {}).get("rid") or ""
        sent_ts = (meta or {}).get("ts")
        self._ongoing += 1
        self._total += 1
        self._queued += 1
        t0 = time.perf_counter()
        started = [False]
        loop = asyncio.get_running_loop()

        def _dec_queued():
            self._queued -= 1

        def _user_code_starts() -> float:
            """Close the queue-wait interval (send → user code start);
            runs on the loop for async targets, on the pool thread for
            sync ones (ring appends are GIL-atomic; the _queued -= 1 is
            NOT, so it marshals to the loop like _ongoing's stream
            decrement — a pool-thread read-modify-write can lose a
            concurrent admission's += otherwise)."""
            if not started[0]:  # idempotent vs the finally's pairing
                started[0] = True
                loop.call_soon_threadsafe(_dec_queued)
            now = time.time()
            if rid:
                reqtrace.record_span(
                    rid, "queue",
                    sent_ts if sent_ts is not None else now, now,
                    app=self._app, deployment=self._deployment,
                    replica=self._name or "")
            return now

        def _record_execute(t_exec: float):
            if rid:
                reqtrace.record_span(
                    rid, "execute", t_exec, time.time(),
                    app=self._app, deployment=self._deployment,
                    replica=self._name or "")

        # serve.batch flushes (and any nested helper) read the request
        # identity from this contextvar — it propagates through awaits
        ctx_token = reqtrace.CURRENT.set(
            (rid, self._app, self._deployment, self._name or "")
        ) if rid else None
        try:
            target = self._target(method_name)
            unbound = target if self._is_function or method_name not in (
                "__call__", None
            ) else getattr(self._callable, "__call__", target)
            if inspect.isasyncgenfunction(unbound) or \
                    inspect.isgeneratorfunction(unbound):
                t_exec = _user_code_starts()
                out = self._start_stream(target, unbound, args, kwargs)
                _record_execute(t_exec)  # stream setup; bytes stream async
                return out
            if inspect.iscoroutinefunction(target) or (
                not self._is_function
                and method_name in ("__call__", None)
                and inspect.iscoroutinefunction(
                    getattr(self._callable, "__call__", None)
                )
            ):
                t_exec = _user_code_starts()
                try:
                    return await target(*args, **kwargs)
                finally:
                    _record_execute(t_exec)
            loop = asyncio.get_running_loop()

            def run():
                t_exec = _user_code_starts()
                try:
                    return target(*args, **kwargs)
                finally:
                    _record_execute(t_exec)

            out = await loop.run_in_executor(self._pool, run)
            if inspect.iscoroutine(out):
                out = await out
            return out
        finally:
            if not started[0]:  # failed before user code: pair the +=
                started[0] = True
                self._queued -= 1  # on the loop here: direct is safe
            if ctx_token is not None:
                reqtrace.CURRENT.reset(ctx_token)
            self._ongoing -= 1
            if self._m_latency is not None:
                self._m_latency.record(time.perf_counter() - t0)

    # -- streaming ------------------------------------------------------
    def _start_stream(self, target, unbound, args, kwargs) -> dict:
        """Kick off the generator; the caller drains via next_chunks.

        The stream holds an "ongoing" slot until the generator finishes so
        autoscaling sees streaming load.
        """
        with self._streams_lock:
            sid = next(self._stream_ids)
            stream = _Stream()
            self._streams[sid] = stream
        self._ongoing += 1
        loop = asyncio.get_running_loop()

        async def _put(item) -> bool:
            # bounded wait + cancellation check: an abandoned stream's
            # producer must stop, not block on a full queue forever
            while not stream.cancelled:
                try:
                    await asyncio.wait_for(stream.queue.put(item), timeout=0.5)
                    return True
                except asyncio.TimeoutError:
                    continue
            return False

        async def _drive_async():
            try:
                async for item in target(*args, **kwargs):
                    if not await _put(item):
                        break
            except Exception as e:  # noqa: BLE001 — surfaced to the consumer
                stream.error = f"{type(e).__name__}: {e}"
            finally:
                stream.done = True
                stream.done_event.set()
                self._ongoing -= 1

        def _drive_sync():
            try:
                for item in target(*args, **kwargs):
                    fut = asyncio.run_coroutine_threadsafe(_put(item), loop)
                    if not fut.result():
                        break
            except Exception as e:  # noqa: BLE001
                stream.error = f"{type(e).__name__}: {e}"
            finally:
                stream.done = True

                def _finish():
                    # on the loop thread: the += in handle_request and this
                    # -= must not interleave mid-read-modify-write
                    stream.done_event.set()
                    self._ongoing -= 1

                loop.call_soon_threadsafe(_finish)

        if inspect.isasyncgenfunction(unbound):
            from ray_tpu_torch._private.rpcio import spawn

            spawn(_drive_async())  # strong ref until done + error logging
        else:
            self._pool.submit(_drive_sync)
        return {STREAM_MARKER: {"stream_id": sid, "replica": self._name}}

    async def next_chunks(self, stream_id: int, max_items: int = 16,
                          timeout_s: float = 30.0) -> Tuple[List[Any], bool]:
        """Drain up to max_items buffered chunks; block for the first one.

        Returns (items, done). done=True means the stream is exhausted
        (after the returned items) and the id is released. Raises on
        producer error after delivering the chunks that preceded it: a
        call that collected chunks before the error returns them with
        done=False; the follow-up call (now drained) raises.
        """
        self._reap_stale_streams()
        stream = self._streams.get(stream_id)
        if stream is None:
            # raising (not a clean done=True) matters: a TTL-reaped stream
            # must surface as an error, or a slow consumer would see a
            # silently truncated response
            raise RuntimeError(
                f"stream {stream_id} is unknown (expired after "
                f"{_STREAM_TTL_S:.0f}s idle, or already consumed)"
            )
        stream.last_touch = time.time()
        items: List[Any] = []
        try:
            first = await asyncio.wait_for(
                self._get_or_done(stream), timeout=timeout_s
            )
            if first is not _DONE:
                items.append(first)
        except asyncio.TimeoutError:
            return [], False
        while len(items) < max_items:
            try:
                items.append(stream.queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        finished = stream.done and stream.queue.empty()
        if finished and stream.error is not None:
            if items:
                # deliver what the generator produced; keep the stream so
                # the consumer's next call surfaces the error
                return items, False
            with self._streams_lock:
                self._streams.pop(stream_id, None)
            raise RuntimeError(
                f"streaming handler failed: {stream.error}"
            ) from None
        if finished:
            with self._streams_lock:
                self._streams.pop(stream_id, None)
        return items, finished

    async def _get_or_done(self, stream: _Stream):
        """First buffered item, or _DONE once the producer finished and the
        queue is drained. Blocks on the queue/done-event, no spinning."""
        while True:
            try:
                return stream.queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
            if stream.done:
                return _DONE
            get_task = asyncio.ensure_future(stream.queue.get())
            done_task = asyncio.ensure_future(stream.done_event.wait())
            try:
                await asyncio.wait(
                    {get_task, done_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
            finally:
                done_task.cancel()
                if not get_task.done():
                    get_task.cancel()
            if get_task.done() and not get_task.cancelled():
                return get_task.result()
            # done fired; loop: a final item may have raced into the queue

    def _reap_stale_streams(self):
        """Cancel streams whose consumer vanished without cancel_stream
        (client process death): the producer stops at its next put and
        releases its thread and ongoing slot."""
        now = time.time()
        with self._streams_lock:
            stale = [
                (sid, s) for sid, s in self._streams.items()
                if now - s.last_touch > _STREAM_TTL_S
            ]
            for sid, _ in stale:
                self._streams.pop(sid, None)
        for _, s in stale:
            s.cancelled = True

    def cancel_stream(self, stream_id: int) -> bool:
        """Drop a stream a consumer abandoned; its producer notices the
        cancel flag at its next put and stops."""
        with self._streams_lock:
            stream = self._streams.pop(stream_id, None)
        if stream is not None:
            stream.cancelled = True
        return True


class _Done:
    pass


_DONE = _Done()
