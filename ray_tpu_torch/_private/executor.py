"""Worker-side task execution.

Analog of the reference's task execution path
(ray: python/ray/_raylet.pyx:1770 task_execution_handler / :1607 execute_task
plus ray: src/ray/core_worker/transport/actor_scheduling_queue.h): deserialize
args (zero-copy from the shm store), run the user function on an executor
thread (or the user asyncio loop for async actor methods), serialize returns
(small values travel in-band back to the owner; large ones are written
straight into the node's shm store by this process), and enforce per-caller
sequence ordering for actor calls.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import logging
import os
import threading
import time
import traceback
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private import logplane, object_store, profiler, serialization
from ray_tpu_torch._private.common import TaskSpec
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import ObjectID, TaskID

logger = logging.getLogger(__name__)


# --- runtime metrics: per-actor-class queue-wait + run-time ------------
class _ExecMetrics:
    __slots__ = ("run", "wait", "_children")

    def __init__(self):
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        self.run = reg.histogram(
            "worker_task_run_seconds",
            "User-code execution time per task, by actor class "
            "('task' for plain tasks)", scale=mc.LATENCY)
        self.wait = reg.histogram(
            "worker_task_queue_wait_seconds",
            "Executor queue wait: request arrival to user-code start "
            "(includes the actor sequence gate)", scale=mc.LATENCY)
        self._children: Dict[str, tuple] = {}

    def record(self, kind: str, wait_s: float, run_s: float):
        pair = self._children.get(kind)
        if pair is None:
            pair = self._children[kind] = (
                self.wait.labels(kind=kind), self.run.labels(kind=kind))
        pair[0].record(wait_s)
        pair[1].record(run_s)


_MX: Optional[_ExecMetrics] = None


def _exec_metrics() -> _ExecMetrics:
    global _MX
    if _MX is None:
        _MX = _ExecMetrics()
    return _MX


class _CallerQueue:
    """Per-caller sequence gate (ray: sequential_actor_submit_queue.h).

    One future PER SEQUENCE NUMBER, released exactly when its turn
    arrives. A Condition with notify_all here is O(queue) wakeups per
    advance — with 2k pipelined calls that profiled at 3.4M wait cycles
    (the 1:1 async actor bottleneck); this form is O(1) per advance."""

    def __init__(self):
        self.next_seq = 0
        self.waiters: Dict[int, asyncio.Future] = {}


class TaskExecutor:
    def __init__(self, core_worker):
        self.cw = core_worker
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec"
        )
        self.max_concurrency = 1
        # Declared concurrency groups → per-group asyncio.Semaphore
        # ("_default" caps ungrouped methods at max_concurrency). Empty
        # when the actor declares no groups. ray parity:
        # src/ray/core_worker/transport/concurrency_group_manager.h
        self._group_sems: Dict[str, asyncio.Semaphore] = {}
        self.actor_instance: Any = None
        self.actor_spec: Optional[TaskSpec] = None
        self._caller_queues: Dict[bytes, _CallerQueue] = {}
        self._user_loop: Optional[asyncio.AbstractEventLoop] = None
        self._user_loop_started = threading.Event()
        self._async_sem: Optional[asyncio.Semaphore] = None
        self.current_task_id: Optional[bytes] = None
        self.current_job_id: Optional[bytes] = None
        # Publish last: the core worker's IO thread polls `executor` and may
        # dispatch a task the instant it becomes visible.
        core_worker.executor = self

    # ------------------------------------------------------------------
    def _ensure_user_loop(self):
        if self._user_loop is not None:
            return
        def run():
            loop = asyncio.new_event_loop()
            self._user_loop = loop
            asyncio.set_event_loop(loop)
            self._user_loop_started.set()
            loop.run_forever()
        threading.Thread(target=run, name="actor-async", daemon=True).start()
        self._user_loop_started.wait()

    # ------------------------------------------------------------------
    async def become_actor(self, spec: TaskSpec):
        try:
            cls = cloudpickle.loads(spec.func_blob)
            args, kwargs = await self._resolve_args(spec)
            self.max_concurrency = max(1, spec.max_concurrency)
            groups = dict(spec.concurrency_groups or {})
            if groups:
                # Declaring groups makes the actor concurrent: each group
                # gets its own admission semaphore, ungrouped methods share
                # the "_default" group capped at max_concurrency, and the
                # thread pool is sized so no group can starve another.
                self._group_sems = {
                    name: asyncio.Semaphore(cap) for name, cap in groups.items()
                }
                self._group_sems["_default"] = asyncio.Semaphore(
                    self.max_concurrency
                )
                # Total threads = every group saturated at once.
                self.max_concurrency += sum(groups.values())
            if self.max_concurrency > 1:
                self.pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.max_concurrency, thread_name_prefix="actor-exec"
                )
            self.actor_spec = spec
            self.current_job_id = spec.job_id
            loop = asyncio.get_running_loop()
            instance = await loop.run_in_executor(self.pool, lambda: cls(*args, **kwargs))
            self.actor_instance = instance
            return {}
        except Exception as e:
            tb = traceback.format_exc()
            logger.error("actor init failed: %s", tb)
            return {"error": f"{type(e).__name__}: {e}\n{tb}"}

    # ------------------------------------------------------------------
    def _observe_submit_to_run(self, spec: TaskSpec):
        """BENCH_CONTROL_PLANE dispatch stage: wall-clock gap between the
        driver stamping the spec (TaskSpec.submit_time) and this worker
        starting on it — submit RPC + lease/queue wait + dispatch in one
        number (same-box clocks; the bench runs single-host)."""
        dt = time.time() - spec.submit_time
        if dt < 0:
            return
        from ray_tpu_torch._private.worker import _stage_record

        _stage_record("submit_to_run", dt)

    async def execute_task(self, spec: TaskSpec):
        t_in = time.perf_counter()
        if cfg.control_plane_stage_timing:
            self._observe_submit_to_run(spec)
        is_actor_task = spec.actor_id is not None and not spec.actor_creation
        sem = None
        if is_actor_task and (self._group_sems or spec.concurrency_group):
            group = spec.concurrency_group or "_default"
            sem = self._group_sems.get(group)
            if sem is None:
                err = ValueError(
                    f"unknown concurrency group {group!r}; this actor "
                    f"declares {sorted(g for g in self._group_sems if g != '_default')}"
                )
                return self._error_result(
                    serialization.serialize_error(err, spec.name),
                    app_error=False,
                )
        if is_actor_task and self.max_concurrency == 1:
            await self._await_turn(spec.caller_id, spec.seq_no)
        if sem is not None:
            async with sem:
                return await self._execute_gated(spec, is_actor_task, t_in)
        return await self._execute_gated(spec, is_actor_task, t_in)

    # ------------------------------------------------------------------
    def _batchable(self, spec: TaskSpec) -> bool:
        """May this call join a single-thread-hop batch run? Plain sync
        task functions, or strictly sequential (max_concurrency 1,
        ungrouped) SYNC actor methods — exactly the calls whose semantics
        a sequential in-order run cannot change. Dynamic-return and traced
        calls take the per-spec path."""
        if getattr(spec, "tracing_ctx", None) is not None:
            return False
        if spec.num_returns == -1:
            return False
        if spec.actor_id is None:
            fn = self._load_fn(spec.func_blob)
            return not inspect.iscoroutinefunction(fn)
        if spec.actor_creation:
            return False
        if self.actor_instance is None or self.max_concurrency != 1:
            return False
        if self._group_sems or spec.concurrency_group:
            return False
        method = getattr(self.actor_instance, spec.method_name, None)
        return method is not None and not inspect.iscoroutinefunction(method)

    async def execute_task_batch(self, specs, deliver):
        """Batched execution with STREAMED results: ``deliver(spec,
        result)`` is awaited the moment each task's result exists, so an
        early task is never gated on the batch tail (ray.wait semantics).
        Consecutive batchable sync calls share ONE thread-pool submission
        (one SimpleQueue hop + GIL handoff instead of one per call — the
        dominant worker-side cost for short calls); each completion still
        streams out of the run individually, so a slow task inside a run
        delays nobody behind it being DELIVERED, only executed."""
        pending = []
        i, n = 0, len(specs)
        while i < n:
            if self._batchable(specs[i]):
                lead_plain = specs[i].actor_id is None
                k = 1
                while (i + k < n and self._batchable(specs[i + k])
                       and (specs[i + k].actor_id is None) == lead_plain):
                    k += 1
                await self._execute_sync_run(specs[i:i + k], deliver)
            else:
                # Non-batchable (async functions, dynamic returns, traced):
                # dispatch CONCURRENTLY, exactly as separate execute_task
                # requests would have — awaiting inline would serialize
                # async tasks and deadlock co-batched tasks that
                # coordinate with each other.
                k = 1

                async def run_one(s=specs[i]):
                    await deliver(s, await self.execute_task(s))

                pending.append(asyncio.ensure_future(run_one()))
            i += k
        for t in pending:
            await t

    async def _execute_sync_run(self, specs, deliver):
        """Run a contiguous burst of batchable calls in one pool hop,
        streaming each completion back to the loop thread as it happens
        (call_soon_threadsafe -> queue -> package + deliver). For actor
        calls the seq gate is awaited for the FIRST spec only: the burst
        is one caller's contiguous seq range, so once its head may run
        the rest follow in order inside the same pool submission; each
        call's turn advances as its result streams out, so later frames'
        calls unblock without waiting for the run tail. Plain tasks have
        no ordering contract and skip the gate."""
        loop = asyncio.get_running_loop()
        start = time.time()
        t_in = time.perf_counter()
        if cfg.control_plane_stage_timing:
            for s in specs:
                self._observe_submit_to_run(s)
        gated = specs[0].actor_id is not None
        if gated:
            await self._await_turn(specs[0].caller_id, specs[0].seq_no)
        done_q: asyncio.Queue = asyncio.Queue()
        # per-item (start, end) log offsets, written by the pool thread in
        # each item's finally BEFORE its done_q put (happens-before via
        # call_soon_threadsafe), read when packaging that item's result
        log_spans: list = [None] * len(specs)
        log_file = logplane.worker_log_path()
        delivered = 0
        try:
            resolved = []
            for spec in specs:
                try:
                    resolved.append(("ok", await self._resolve_args(spec)))
                except serialization.TaskError as e:
                    # dependency failed: propagate its error as ours
                    resolved.append(("err", serialization.serialize_error(
                        e.cause, spec.name), True))
                except Exception as e:
                    resolved.append(("err", serialization.serialize_error(
                        e, spec.name), False))
            self.current_job_id = specs[0].job_id
            self.cw.job_id = specs[0].job_id

            calls = [
                (getattr(self.actor_instance, spec.method_name)
                 if spec.actor_id is not None
                 else self._load_fn(spec.func_blob))
                for spec in specs
            ]

            kind = self._metric_kind(specs[0])

            def run_all():
                for idx, (spec, r, call) in enumerate(
                    zip(specs, resolved, calls)
                ):
                    if r[0] != "ok":
                        loop.call_soon_threadsafe(
                            done_q.put_nowait, (idx, False, None)
                        )
                        continue
                    args, kwargs = r[1]
                    self.current_task_id = spec.task_id
                    t_start = time.perf_counter()
                    # log attribution: exact byte range of this item's
                    # stdout/stderr in the worker log (stdio flushed on
                    # both edges, so batch neighbors never bleed)
                    log_start = logplane.stdio_offset()
                    try:
                        with profiler.tag_current_thread.for_spec(spec):
                            out = (idx, True, call(*args, **kwargs))
                    except Exception as e:
                        out = (idx, False, e)
                    finally:
                        log_spans[idx] = (log_start, logplane.stdio_offset())
                        self.current_task_id = None
                        # wait = batch arrival at the executor to THIS
                        # item's user-code start (seq gate + arg resolve
                        # + time behind earlier batch items), matching
                        # the non-batch path's arrival-to-start contract
                        _exec_metrics().record(
                            kind, t_start - t_in,
                            time.perf_counter() - t_start)
                    loop.call_soon_threadsafe(done_q.put_nowait, out)

            pool_fut = loop.run_in_executor(self.pool, run_all)
            for _ in range(len(specs)):
                idx, ok, value = await done_q.get()
                spec, r = specs[idx], resolved[idx]
                if r[0] != "ok":
                    result = self._error_result(r[1], app_error=r[2])
                elif ok:
                    result = self._package_returns(spec, value, start)
                else:
                    result = self._error_result(
                        serialization.serialize_error(value, spec.name),
                        app_error=True,
                    )
                span = log_spans[idx]
                if (log_file and span and span[0] is not None
                        and span[1] is not None):
                    result["log_span"] = {
                        "file": os.path.basename(log_file),
                        "start": span[0], "end": max(span[1], span[0]),
                    }
                if gated:
                    await self._advance_turn(spec.caller_id)
                delivered += 1
                await deliver(spec, result)
            await pool_fut
        finally:
            if gated:
                # crash path: later frames' calls must not deadlock on
                # turns the dead run will never advance
                for _ in range(len(specs) - delivered):
                    await self._advance_turn(specs[0].caller_id)

    async def _execute_gated(self, spec: TaskSpec, is_actor_task: bool,
                             t_in: Optional[float] = None):
        try:
            ctx = getattr(spec, "tracing_ctx", None)
            if ctx is not None:
                # A propagated span context means the submitter traces:
                # record this execution as a child span (ray:
                # tracing_helper.py _inject_tracing_into_function).
                # Stateless on purpose — concurrent tasks on this loop must
                # not share thread-local span stacks, and the span must
                # record even when _execute raises.
                from ray_tpu_torch.util import tracing

                # Pre-generate this execution span's id so nested .remote()
                # calls from the task body chain to THIS hop (the user-code
                # thread adopts {trace, exec_span_id} as its context).
                exec_span_id = tracing.new_span_id()
                spec.tracing_ctx = {
                    "trace_id": ctx["trace_id"], "span_id": exec_span_id,
                }
                start = time.time()
                try:
                    return await self._execute(spec, is_actor_task, t_in)
                finally:
                    tracing.record_remote_span(
                        f"task::{spec.name}", start, time.time(), ctx,
                        attributes={"task_id": spec.task_id.hex()[:16]},
                        span_id=exec_span_id,
                    )
            return await self._execute(spec, is_actor_task, t_in)
        finally:
            if is_actor_task and self.max_concurrency == 1:
                await self._advance_turn(spec.caller_id)

    async def _await_turn(self, caller_id: bytes, seq_no: int):
        q = self._caller_queues.get(caller_id)
        if q is None:
            # First task from this caller: adopt its sequence number. After an
            # actor restart the caller's counter keeps increasing, so the gate
            # must re-anchor rather than wait for seq 0 (which already ran in
            # the previous incarnation).
            q = _CallerQueue()
            q.next_seq = seq_no
            self._caller_queues[caller_id] = q
        if q.next_seq >= seq_no:
            return
        fut = q.waiters.get(seq_no)
        if fut is None:
            fut = q.waiters[seq_no] = \
                asyncio.get_running_loop().create_future()
        await fut

    async def _advance_turn(self, caller_id: bytes):
        q = self._caller_queues.setdefault(caller_id, _CallerQueue())
        q.next_seq += 1
        fut = q.waiters.pop(q.next_seq, None)
        if fut is not None and not fut.done():
            fut.set_result(None)

    def _metric_kind(self, spec: TaskSpec) -> str:
        if spec.actor_id is not None and self.actor_spec is not None:
            return self.actor_spec.name or "actor"
        return "task"

    async def _execute(self, spec: TaskSpec, is_actor_task: bool,
                       t_in: Optional[float] = None):
        loop = asyncio.get_running_loop()
        start = time.time()
        self.current_task_id = spec.task_id
        self.current_job_id = spec.job_id
        # Nested submissions from this task belong to the task's job.
        self.cw.job_id = spec.job_id
        try:
            args, kwargs = await self._resolve_args(spec)
        except serialization.TaskError as e:
            # A dependency failed: propagate its error as ours.
            sv = serialization.serialize_error(e.cause, spec.name)
            return self._error_result(sv, app_error=True)
        except Exception as e:
            sv = serialization.serialize_error(e, spec.name)
            return self._error_result(sv, app_error=False)
        t_run = time.perf_counter()
        # log attribution: byte range of this task's output in the worker
        # log (exact; stamped onto the result for the task-event pipeline)
        log_start = logplane.stdio_offset()
        try:
            ctx = getattr(spec, "tracing_ctx", None)
            if is_actor_task:
                method = getattr(self.actor_instance, spec.method_name)
                if inspect.iscoroutinefunction(method):
                    self._ensure_user_loop()
                    cfut = asyncio.run_coroutine_threadsafe(
                        self._run_async_method(method, args, kwargs), self._user_loop
                    )
                    value = await asyncio.wrap_future(cfut)
                else:
                    value = await loop.run_in_executor(
                        self.pool,
                        lambda: self._invoke_user(
                            spec, lambda: method(*args, **kwargs), ctx
                        ),
                    )
            else:
                func = self._load_fn(spec.func_blob)
                if inspect.iscoroutinefunction(func):
                    self._ensure_user_loop()
                    cfut = asyncio.run_coroutine_threadsafe(
                        func(*args, **kwargs), self._user_loop
                    )
                    value = await asyncio.wrap_future(cfut)
                else:
                    value = await loop.run_in_executor(
                        self.pool,
                        lambda: self._invoke_user(
                            spec, lambda: func(*args, **kwargs), ctx
                        ),
                    )
        except Exception as e:
            sv = serialization.serialize_error(e, spec.name)
            return logplane.attach_result_span(
                self._error_result(sv, app_error=True), log_start)
        finally:
            self.current_task_id = None
            _exec_metrics().record(
                self._metric_kind(spec),
                (t_run - t_in) if t_in is not None else 0.0,
                time.perf_counter() - t_run,
            )
        return logplane.attach_result_span(
            self._package_returns(spec, value, start), log_start)

    def _load_fn(self, func_blob: bytes):
        """Deserialize a task function with a digest-keyed cache: a driver
        loop calling the same @remote function thousands of times must not
        pay cloudpickle.loads per execution (ray parity: the function
        table caches by function id in _raylet.pyx)."""
        import hashlib

        key = hashlib.md5(func_blob).digest()
        cache = getattr(self, "_fn_cache", None)
        if cache is None:
            cache = self._fn_cache = {}
        fn = cache.get(key)
        if fn is None:
            fn = cloudpickle.loads(func_blob)
            if len(cache) >= 256:  # bound: long-lived workers, many jobs
                cache.pop(next(iter(cache)))
            cache[key] = fn
        return fn

    def _invoke_user(self, spec, fn, ctx):
        """Run user code on a pool thread with the sampling profiler's
        thread tag set (per-task/actor attribution in CPU profiles) on
        top of the traced invocation."""
        with profiler.tag_current_thread.for_spec(spec):
            return self._invoke_traced(fn, ctx)

    @staticmethod
    def _invoke_traced(fn, ctx):
        """Run user code on a pool thread with the propagated span context
        adopted thread-locally, so nested .remote() submissions stay in the
        submitter's trace (multi-hop). Pool threads run one task function
        at a time, so the thread-local cannot leak across tasks."""
        if ctx is None:
            return fn()
        from ray_tpu_torch.util import tracing

        tracing.set_remote_context(ctx)
        try:
            return fn()
        finally:
            tracing.set_remote_context(None)

    async def _run_async_method(self, method, args, kwargs):
        if self._async_sem is None or self._async_sem._value > self.max_concurrency:
            self._async_sem = asyncio.Semaphore(self.max_concurrency)
        async with self._async_sem:
            return await method(*args, **kwargs)

    # ------------------------------------------------------------------
    async def _resolve_args(self, spec: TaskSpec):
        args = [await self._resolve_one(a) for a in spec.args]
        kwargs = {k: await self._resolve_one(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    async def _resolve_one(self, slot):
        from ray_tpu_torch._private.worker import _deser_container

        kind = slot[0]
        if kind == "v":
            return serialization.deserialize(slot[1], slot[2])
        oid_bytes = slot[1]
        oid = ObjectID(oid_bytes)
        buf = object_store.read_object(self.cw.store_dir, oid)
        if buf is None:
            ok = await self.cw.raylet.request(
                "pull_object",
                {"object_id": oid_bytes,
                 "owner": slot[2] if len(slot) > 2 else None})
            if not ok.get("ok"):
                raise RuntimeError(f"task argument {oid_bytes.hex()[:16]} unavailable")
            buf = object_store.read_object(self.cw.store_dir, oid)
            if buf is None:
                raise RuntimeError(f"task argument {oid_bytes.hex()[:16]} unavailable")
        # Do not release the buffer: returned values may alias the mmap; the
        # mapping stays alive as long as any view does (plasma zero-copy).
        # Refs nested in the value are borrowed *through* this argument
        # object; record the provenance for the borrower handoff.
        with _deser_container(oid_bytes):
            return serialization.deserialize(buf.metadata, buf.data)

    # ------------------------------------------------------------------
    def _package_returns(self, spec: TaskSpec, value: Any, start: float):
        if spec.num_returns == -1:  # num_returns="dynamic"
            return self._package_dynamic_returns(spec, value, start)
        values = (value,) if spec.num_returns == 1 else tuple(value)
        if spec.num_returns > 1 and len(values) != spec.num_returns:
            sv = serialization.serialize_error(
                ValueError(
                    f"task returned {len(values)} values, expected {spec.num_returns}"
                ),
                spec.name,
            )
            return self._error_result(sv, app_error=True)
        results = []
        stored = []
        returns_nested = {}
        return_pins = []
        tid = TaskID(spec.task_id)
        for i, v in enumerate(values):
            try:
                sv = serialization.serialize(v)
            except Exception as e:
                esv = serialization.serialize_error(e, spec.name)
                for t in return_pins:
                    self.cw.unpin_object(t)
                return self._error_result(esv, app_error=True)
            if sv.nested_refs:
                # Refs escaping via a return value: pin them here until the
                # caller has registered as their borrower and acks with
                # release_return_pins (reference_count.h return handoff).
                returns_nested[i] = list(sv.nested_refs)
                for oid_b, owner in sv.nested_refs:
                    return_pins.append(self.cw.pin_object(oid_b, owner))
            if sv.total_data_len <= cfg.max_direct_call_object_size:
                # wire form: large result buffers ride the v2 frame
                # out-of-band, never copied into the pickle stream
                results.append(("v", sv.metadata, sv.to_wire()))
            else:
                oid = ObjectID.from_index(tid, i + 1)
                # slab-arena write (batched accounting); one-file fallback
                self.cw.store_put(oid, sv)
                stored.append(oid.binary())
                results.append(("r", oid.binary()))
        if return_pins:
            with self.cw._lock:
                self.cw._return_pins[spec.task_id] = return_pins
            # Fallback: if the caller dies before acking release_return_pins,
            # expire the pins instead of pinning the objects forever.
            self.cw.io.call_soon(self._expire_return_pins(spec.task_id))
        return {
            "results": results,
            "stored_objects": stored,
            "duration": time.time() - start,
            # Borrower-protocol report (ray: PushTaskReply.borrowed_refs):
            # borrows this worker still holds (e.g. refs stashed in actor
            # state) so the owner can register us before releasing arg pins.
            "exec_addr": self.cw.addr,
            "borrows_kept": self.cw.borrowed_refs_held(),
            "returns_nested": returns_nested or None,
        }

    def _package_dynamic_returns(self, spec: TaskSpec, value: Any,
                                 start: float):
        """num_returns="dynamic" (ray: task_manager.h ObjectRefStream /
        legacy dynamic generators): the task returns an iterable of unknown
        length; each yielded item is stored as its own object (return index
        2, 3, ... — index 1 is the ref-list itself) and the single visible
        return resolves to the list of ObjectRefs. The caller adopts
        ownership of the item objects from the result notification
        (dynamic_return_oids), so lineage reconstruction re-executes this
        task if an item's plasma copy is lost."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        tid = TaskID(spec.task_id)
        item_oids = []
        returns_nested = {}
        return_pins = []
        try:
            for i, item in enumerate(value):
                sv = serialization.serialize(item)
                oid = ObjectID.from_index(tid, i + 2)
                self.cw.store_put(oid, sv)
                item_oids.append(oid.binary())
                if sv.nested_refs:
                    # refs escaping inside a yielded value: same handoff as
                    # plain returns — pinned here until the caller registers
                    # as borrower and acks (keyed so the caller's
                    # from_index(key+1) lands on THIS item, index i+2)
                    returns_nested[i + 1] = list(sv.nested_refs)
                    for oid_b, owner in sv.nested_refs:
                        return_pins.append(self.cw.pin_object(oid_b, owner))
        except Exception as e:
            # a partial run must not orphan the items already written
            # (slab entries are marked dead, fallback files unlinked)
            for oid_b in item_oids:
                try:
                    object_store.discard_local(
                        self.cw.store_dir, ObjectID(oid_b)
                    )
                except OSError:
                    pass
            for t in return_pins:
                self.cw.unpin_object(t)
            esv = serialization.serialize_error(e, spec.name)
            return self._error_result(esv, app_error=True)
        refs = [
            ObjectRef(ObjectID(oid), tuple(spec.owner)) for oid in item_oids
        ]
        sv = serialization.serialize(refs)
        results = [("v", sv.metadata, sv.to_wire())]
        if return_pins:
            with self.cw._lock:
                self.cw._return_pins[spec.task_id] = return_pins
            self.cw.io.call_soon(self._expire_return_pins(spec.task_id))
        return {
            "results": results,
            "stored_objects": list(item_oids),
            "dynamic_return_oids": list(item_oids),
            "duration": time.time() - start,
            "exec_addr": self.cw.addr,
            "borrows_kept": self.cw.borrowed_refs_held(),
            "returns_nested": returns_nested or None,
        }

    async def _expire_return_pins(self, task_id: bytes):
        await asyncio.sleep(cfg.borrower_poll_timeout_s)
        with self.cw._lock:
            pins = self.cw._return_pins.pop(task_id, None)
        for token in pins or ():
            self.cw.unpin_object(token)

    def _error_result(self, sv: serialization.SerializedValue, app_error: bool):
        return {
            "results": None,
            "error": "task raised" if app_error else "task system error",
            "error_value": (sv.metadata, sv.to_wire()),
            "app_error": app_error,
            "retriable": True,
            # Even a failed task may have stashed arg refs (actor state):
            # report them so the owner keeps those objects alive.
            "exec_addr": self.cw.addr,
            "borrows_kept": self.cw.borrowed_refs_held(),
        }
