"""Core worker: the per-process runtime embedded in drivers and workers.

Analog of the reference's CoreWorker (ray: src/ray/core_worker/core_worker.h:284):
task submission with submitter-side dependency resolution
(ray: transport/dependency_resolver.h — owned in-memory args are awaited and
inlined before the lease request; plasma refs are left for the raylet), an
in-process memory store for small objects (ray: memory_store.h:43), the plasma
provider for shm objects (ray: plasma_store_provider.h:88), owner-side retry
bookkeeping (ray: task_manager.h:173), a simplified reference counter
(ray: reference_count.h:61), and per-caller ordered actor submission
(ray: sequential_actor_submit_queue.h).

Sync user code runs on the main/executor threads; all IO rides a dedicated
asyncio loop thread (rpcio.EventLoopThread), mirroring the reference's
io_context-per-process model.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import (faultsim, memview, object_store,
                              serialization, slab_arena)
from ray_tpu_torch._private.common import SchedulingStrategy, TaskSpec, rewrite_resources_for_pg
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import (ActorID, JobID, ObjectID, TaskID,
                                  TaskIDMinter, WorkerID, object_id_binary)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpcio import (Connection, EventLoopThread, RpcServer,
                                    call_with_retries, connect)

logger = logging.getLogger(__name__)

# Thread-local marker for "currently deserializing the value of container X":
# refs rebuilt inside record X as their borrow provenance so the container's
# owner can hand the borrow off when X is released (reference_count.h
# borrowed-through-object tracking).
_DESER_CTX = threading.local()


class _deser_container:
    def __init__(self, container_oid):
        self.oid = container_oid

    def __enter__(self):
        self.prev = getattr(_DESER_CTX, "container", None)
        _DESER_CTX.container = self.oid

    def __exit__(self, *exc):
        _DESER_CTX.container = self.prev


_tracing_mod = None


def _tracing_ctx():
    """Current span context for propagation into outgoing specs (no-op
    None when tracing is off). The tracing module is cached after the
    first call: the per-call import machinery (sys.modules lookup plus
    the from-list binding) is measurable on the submit hot path."""
    global _tracing_mod
    tracing = _tracing_mod
    if tracing is None:
        try:
            from ray_tpu_torch.util import tracing
        except Exception:
            return None
        _tracing_mod = tracing
    try:
        if tracing.is_enabled():
            return tracing.current_context() or tracing.propagation_context()
        # Not locally enabled, but an adopted remote context still rides
        # through (multi-hop task graphs keep their trace).
        return tracing.propagation_context()
    except Exception:
        return None


# --- control-plane stage timing (BENCH_CONTROL_PLANE) ------------------
# Gated on cfg.control_plane_stage_timing: the bench lane (and anyone
# chasing a microsecond) gets per-stage latency histograms on the submit
# path; the default path pays one attribute check per call. Per-stage
# children are cached in a plain dict — same posture as rpcio._RpcMetrics.
_STAGE_HISTS: Dict[str, Any] = {}


def _stage_record(stage: str, seconds: float):
    h = _STAGE_HISTS.get(stage)
    if h is None:
        from ray_tpu_torch._private import metrics_core as mc

        h = _STAGE_HISTS[stage] = mc.registry().histogram(
            "control_plane_stage_seconds",
            "Per-stage control-plane latency (see BENCH_CONTROL_PLANE)",
            scale=mc.LATENCY,
        ).labels(stage=stage)
    h.record(seconds)


class TaskTemplate:
    """Immutable per-callsite submit template (control-plane fast path):
    everything about a ``.remote()`` call that does not vary call to call
    — resources (PG-rewritten once), scheduling, the serialized function,
    retry policy, runtime env — is computed ONCE here, so the per-call
    path only mints a task id and encodes the arguments. The API layer
    caches one template per RemoteFunction / actor method; ``.options()``
    yields a new options set and therefore a new template, and ``worker``
    pins the CoreWorker the template was built against so a reconnect
    invalidates the cache. The resources/scheduling objects are SHARED
    across every spec stamped from the template and must not be mutated
    driver-side (the raylet unpickles its own copies)."""

    __slots__ = ("worker", "name", "func_blob", "method_name",
                 "num_returns", "resources", "scheduling", "max_retries",
                 "retry_exceptions", "runtime_env", "actor_id",
                 "concurrency_group", "minter")


def _log_span_fields(result: dict) -> dict:
    """Task-event fields from an executor result's exact log byte range
    (see logplane.attach_result_span)."""
    span = result.get("log_span")
    if not span:
        return {}
    return {"log_file": span["file"], "log_start": span["start"],
            "log_end": span["end"]}


class GetTimeoutError(TimeoutError):
    pass


class ActorDiedError(RuntimeError):
    pass


class WorkerDiedError(RuntimeError):
    """The worker process executing the task died (crash, OOM kill, node
    loss) — a SYSTEM failure, typed so callers (e.g. serve's replica-death
    retry) can match on class instead of message text. Analog of
    ray.exceptions.WorkerCrashedError."""
    pass


class TaskCancelledError(RuntimeError):
    pass


class CoreWorker:
    def __init__(
        self,
        raylet_host: str,
        raylet_port: int,
        gcs_host: str,
        gcs_port: int,
        is_driver: bool,
        job_id: Optional[bytes] = None,
        namespace: Optional[str] = None,
    ):
        self.client_id = WorkerID.from_random().hex()
        self._caller_id = self.client_id.encode()  # spec-stamp fast path
        # chaos identity (faultsim partition rules match on it): drivers
        # and workers are labeled so raylet-to-raylet partitions miss them
        faultsim.set_self_id(f"worker:{self.client_id[:12]}")
        self.is_driver = is_driver
        self.namespace = namespace or "default"
        self.executor = None  # set by TaskExecutor on worker processes
        self.io = EventLoopThread(name=f"coreworker-io-{self.client_id[:6]}")
        self.raylet: Connection = self.io.run(
            connect(raylet_host, raylet_port, handler=self, name="raylet-conn")
        )
        # workers spawned during a GCS outage must come up once it returns:
        # give non-drivers the same patience as the raylet reconnect loop
        # (a wall-clock budget — connect() retries with exponential backoff
        # until the deadline). Drivers get a SHORT budget instead: an
        # interactive init() against a dead/mistyped address should fail in
        # seconds, not ride 30 capped-backoff attempts for a minute.
        self.gcs: Connection = self.io.run(
            connect(gcs_host, gcs_port, handler=self, name="gcs-conn",
                    total_timeout=10.0 if is_driver
                    else cfg.gcs_client_reconnect_timeout_s)
        )
        self.gcs_addr = (gcs_host, gcs_port)
        if is_driver and job_id is None:
            job_id = self.io.run(
                self.gcs.request("register_job", {"namespace": self.namespace,
                                                  "driver": {"pid": os.getpid()}})
            )["job_id"]
        self.job_id = job_id or JobID.from_int(0).binary()
        self.io.run(
            self.gcs.request(
                "register_client",
                {"client_id": self.client_id, "job_id": self.job_id,
                 "is_driver": is_driver},
            )
        )
        # Workers serve a direct RPC endpoint so drivers holding a lease
        # push tasks straight here, skipping the raylet per task (ray:
        # core worker gRPC server + direct_task_transport.cc).
        self.direct_server: Optional[RpcServer] = None
        direct_port = None
        if not is_driver:
            self.direct_server = RpcServer(
                self, host=os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1"),
                port=0,
            )
            direct_port = self.io.run(self.direct_server.start())
        reply = self.io.run(
            self.raylet.request(
                "register_client",
                {"client_id": self.client_id,
                 "kind": "driver" if is_driver else "worker",
                 "job_id": self.job_id, "pid": os.getpid(),
                 # echo the raylet's spawn key: containerized workers
                 # report a pid the raylet never saw (the engine client's
                 # pid differs from the in-container worker's), so the
                 # raylet matches its _Worker record by this key first
                 "spawn_id": os.environ.get("RAY_TPU_TORCH_WORKER_SPAWN_ID"),
                 "direct_port": direct_port},
            )
        )
        self.node_id: str = reply["node_id"]
        self.store_dir: str = reply["store_dir"]
        self.node_resources: Dict[str, float] = reply.get("resources_total", {})
        self.node_labels: Dict[str, str] = reply.get("labels", {})
        self.addr = (self.node_id, self.client_id)
        # slab-arena write path (slab_arena.py): this client leases write
        # slabs from its raylet and bump-allocates puts/results into the
        # mmap'd segment; accounting is self-reported in batches
        self.arena_enabled = bool(reply.get("arena"))
        self._slab_writer = (
            slab_arena.SlabWriter(self.store_dir) if self.arena_enabled
            else None
        )
        self._slab_lease_lock = threading.Lock()
        self._slab_reports: List[dict] = []
        self._slab_flushing = False
        self._slab_refill_task = None
        self._pending_seals: List[dict] = []
        if is_driver:
            self.task_id = TaskID.for_driver(JobID(self.job_id))
        else:
            self.task_id = TaskID.for_task(JobID(self.job_id))
        # owner-side state
        self._lock = threading.Lock()
        self._futures: Dict[bytes, concurrent.futures.Future] = {}
        self._memory_store: Dict[bytes, Tuple[bytes, bytes]] = {}
        self._pinned_buffers: Dict[bytes, object_store.ObjectBuffer] = {}
        self._specs_inflight: Dict[bytes, TaskSpec] = {}
        self._put_index = 0
        self._local_refs: Dict[bytes, int] = {}
        self._owned: set = set()
        # ownership-based object directory (ray:
        # src/ray/object_manager/ownership_based_object_directory.h +
        # reference_count.h:61): the OWNER is the authority on where its
        # objects have copies; raylets query here first and treat the GCS
        # directory as bootstrap/cache, so a GCS restart mid-transfer
        # doesn't stall pulls on a full location replay.
        self._owned_locations: Dict[bytes, set] = {}
        # Lock-free queue of ref releases deferred from ObjectRef.__del__
        # (GC can fire inside locked sections; see defer_ref_release).
        self._deferred_releases: deque = deque()
        # woken by producers; a timed wait stays as the safety net so a
        # set() lost to a race costs 0.5s, not forever (and the idle drain
        # thread no longer wakes 50x/s on every process)
        self._release_event = threading.Event()
        # tick-batched task submission buffer (see _finish_submit)
        self._submit_buf: List[TaskSpec] = []
        self._submit_flushing = False
        # cross-thread submission inbox (see _enqueue_submit)
        self._submit_inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._inbox_scheduled = False
        # submission-stage breadcrumbs (task_id -> last stage string):
        # costs one dict write per transition and makes a stranded task
        # diagnosable from the get()-stall dump — which stage ate it.
        self._submit_stage: Dict[bytes, str] = {}
        # Strong refs for fire-and-forget io-loop tasks. asyncio's loop
        # holds only WEAK task references: an unreferenced pending task can
        # be garbage-collected mid-await, silently skipping its finally
        # (observed: a GC'd _direct_pump left its key registered forever,
        # stranding every later task of that scheduling class — the
        # round-4 full-suite hang). Every create_task here must land in
        # this set (or another live structure) until done.
        self._bg_tasks: set = set()
        # direct task push over worker leases (ray:
        # direct_task_transport.cc): per-scheduling-class pending queues,
        # one pump task per active class, cached conns to leased workers
        self._direct_q: Dict[tuple, deque] = {}
        # direct-path placement latency (the raylet's histogram only saw
        # raylet-routed tasks): enqueue-on-the-direct-queue -> pushed to a
        # leased worker, recorded as
        # raylet_task_placement_latency_seconds{path="direct"} in THIS
        # driver's registry (drivers ride the cluster scrape). Specs that
        # fall back to raylet routing drop their stamp — the raylet's
        # path="raylet" series takes over from its own ready queue.
        self._direct_ready_at: Dict[bytes, float] = {}
        self._direct_placement_lat = None
        # key -> live pump task; the TASK OBJECT is stored (strong ref, see
        # _bg_tasks note) and checked with .done() so a crashed/GC'd pump
        # self-heals on the next enqueue instead of stranding the class
        self._direct_pumps: Dict[tuple, object] = {}
        self._direct_conns: Dict[tuple, Connection] = {}
        self._direct_events: Dict[tuple, asyncio.Event] = {}
        # direct actor calls: actor_id -> {"q", "running", "conn"}
        self._actor_direct: Dict[bytes, dict] = {}
        # actor_id -> True when calls are STRICTLY sequential (max_concurrency
        # 1, no concurrency groups): only then may the direct sender batch
        # calls into one frame without changing concurrency semantics
        self._actor_sequential: Dict[bytes, bool] = {}
        # worker-side task-event buffer for direct-push executions
        self._tev_buf: List[dict] = []
        self._tev_flushing = False
        # tick-batched object frees (see _maybe_free)
        self._free_buf: List[bytes] = []
        self._free_flushing = False
        threading.Thread(
            target=self._release_drain_loop,
            name=f"ref-release-{self.client_id[:6]}", daemon=True,
        ).start()
        # --- borrower protocol (ray: reference_count.h:61) ----------------
        # Owned oids pinned by outstanding serialized copies (task args in
        # flight, containment handoffs). Count-based; released when the
        # consuming side has registered as a borrower or finished.
        self._escape_pins: Dict[bytes, int] = {}
        # Owned oid -> set of remote worker addrs currently borrowing it.
        # Each entry has an active wait_ref_removed long-poll task.
        self._borrowers: Dict[bytes, set] = {}
        # Owned container oid -> pin tokens for the refs nested inside it,
        # released when the container is freed (ray: AddNestedObjectIds).
        self._contains: Dict[bytes, list] = {}
        # Borrow-side: oid -> {"count", "owner", "waiters"}; count covers
        # live python refs, serialize-out holds, and containment holds.
        self._borrow_state: Dict[bytes, dict] = {}
        # Container oid -> child oids first borrowed while deserializing it
        # (reported to the container's owner on release for handoff).
        self._borrowed_via: Dict[bytes, set] = {}
        # task_id -> pin tokens for refs serialized into its args.
        self._task_arg_pins: Dict[bytes, list] = {}
        # task_id -> pin tokens for refs serialized into returns we executed,
        # held until the caller acks registration (release_return_pins).
        self._return_pins: Dict[bytes, list] = {}
        # actor_id -> pin tokens for actor-creation args (held until the
        # actor is permanently DEAD: restarts replay the creation spec).
        self._actor_creation_pins: Dict[bytes, list] = {}
        self._actor_sub_done = False
        # --- lineage (ray: object_recovery_manager.h:44) ------------------
        # return oid -> producing TaskSpec (finalized args), for re-execution
        # when the plasma copy is lost. FIFO-capped.
        self._lineage: Dict[bytes, TaskSpec] = {}
        self._reconstructing: Dict[bytes, concurrent.futures.Future] = {}
        self._actor_seq: Dict[bytes, int] = {}
        self._pubsub_handlers: Dict[str, list] = {}
        self.connected = True

    # ------------------------------------------------------------------
    # argument encoding / submitter-side dependency resolution
    # ------------------------------------------------------------------
    def _encode_value(self, value: Any, pins: List) -> Tuple:
        sv = serialization.serialize(value)
        for oid, owner in sv.nested_refs:
            # Refs inside an inlined arg value escape this process: pin them
            # until the consuming task resolves and its executor has
            # registered any kept borrows (ray: reference_count.h arg pins).
            pins.append(self.pin_object(oid, owner))
        if sv.total_data_len <= cfg.max_direct_call_object_size:
            # wire form, not a joined copy: large buffers (numpy/jax host
            # arrays) cross the v2 rpc frame out-of-band, by reference
            return ("v", sv.metadata, sv.to_wire())
        ref = self._put_serialized(sv)
        # Keep the implicit put alive until the consuming task finishes.
        pins.append(self.pin_object(ref.binary(), ref.owner))
        return ("r", ref.binary(), ref.owner)

    def _encode_slots(self, args, kwargs, pins: List):
        """Encode values eagerly; refs become ('pending', ref) placeholders."""
        enc_args = [
            ("pending", a) if isinstance(a, ObjectRef) else self._encode_value(a, pins)
            for a in args
        ]
        enc_kwargs = {
            k: (("pending", v) if isinstance(v, ObjectRef)
                else self._encode_value(v, pins))
            for k, v in (kwargs or {}).items()
        }
        pending = [s[1] for s in enc_args if s[0] == "pending"]
        pending += [s[1] for s in enc_kwargs.values() if s[0] == "pending"]
        return enc_args, enc_kwargs, pending

    def _finalize_slot(self, slot, pins: List):
        if slot[0] != "pending":
            return slot
        ref: ObjectRef = slot[1]
        # Pin for the task's lifetime whether owned (escape pin) or borrowed
        # (our borrow must outlive the handoff to the executor).
        pins.append(self.pin_object(ref.binary(), ref.owner))
        with self._lock:
            inline = self._memory_store.get(ref.binary())
        if inline is not None:
            # Inlining the stored bytes: any refs nested in them stay alive
            # through the pin on the containing object (its _contains pins).
            return ("v", inline[0], inline[1])
        return ("r", ref.binary(), ref.owner or self.addr)

    def _spawn(self, coro) -> "asyncio.Task":
        """create_task + keep a strong reference until completion (asyncio
        keeps only weak refs — see _bg_tasks) + surface dropped
        exceptions."""
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)

        def _done(t):
            self._bg_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.error("background io task failed: %r", t.exception(),
                             exc_info=t.exception())

        task.add_done_callback(_done)
        return task

    async def _submit_when_ready(self, spec: TaskSpec, enc_args, enc_kwargs,
                                 pending: List[ObjectRef], pins: List):
        self._submit_stage[spec.task_id] = "deps_wait"
        try:
            for ref in pending:
                fut = self.future_for(ref)
                await asyncio.wait_for(
                    asyncio.wrap_future(fut), cfg.object_pull_timeout_s * 4
                )
        except Exception as e:
            self._fail_returns(spec, f"dependency resolution failed: {e}")
            return
        self._finish_submit(spec, enc_args, enc_kwargs, pins)

    def _finish_submit(self, spec: TaskSpec, enc_args, enc_kwargs,
                       pins: List):
        """Synchronous tail of submission (deps already resolved). Runs
        directly inside the inbox drain for the common no-deps case — no
        per-call coroutine/task — and from _submit_when_ready otherwise.
        Self-guarding: any failure here fails the task's returns so both
        paths surface errors instead of hanging the caller's get()."""
        try:
            self._finish_submit_inner(spec, enc_args, enc_kwargs, pins)
        except Exception as e:
            logger.exception("submission failed for %s", spec.name)
            self._fail_returns(spec, f"task submission failed: {e!r}")

    def _finish_submit_inner(self, spec: TaskSpec, enc_args, enc_kwargs,
                             pins: List):
        self._submit_stage[spec.task_id] = "finalizing"
        spec.args = [self._finalize_slot(s, pins) for s in enc_args]
        spec.kwargs = {k: self._finalize_slot(s, pins) for k, s in enc_kwargs.items()}
        with self._lock:
            self._task_arg_pins[spec.task_id] = pins
        # Plain DEFAULT-strategy tasks go over worker leases: the raylet
        # grants workers once per burst and tasks push straight to them
        # (2 hops/task instead of 4, no raylet CPU in steady state).
        # Placement-sensitive strategies stay raylet-routed.
        if (cfg.direct_task_leases and spec.actor_id is None
                and spec.scheduling.kind == "DEFAULT"):
            self._submit_stage[spec.task_id] = "direct_enqueued"
            self._direct_enqueue(spec)
            return
        # Actor calls push straight to the actor worker's own endpoint
        # (ray: CoreWorkerDirectActorTaskSubmitter); in-order frames plus
        # the executor's per-caller seq gate preserve call order. Falls
        # back to raylet routing when no direct endpoint is known.
        if (cfg.direct_actor_calls and spec.actor_id is not None
                and not spec.actor_creation):
            self._submit_stage[spec.task_id] = "actor_enqueued"
            self._actor_direct_enqueue(spec)
            return
        # Tick-batched submission: a burst of .remote() calls lands on the
        # io loop as one inbox drain; buffer and ship ONE submit_batch
        # frame (same discipline as the GCS pubsub outbox). Actor tasks
        # ride the same buffer: the buffer is FIFO and the raylet enqueues
        # a batch's actor tasks synchronously in spec order, so per-actor
        # call order survives.
        self._submit_stage[spec.task_id] = "batch_buffered"
        self._submit_buf.append(spec)
        if not self._submit_flushing:
            self._submit_flushing = True
            self._spawn(self._flush_submits())

    def _enqueue_submit(self, spec: TaskSpec, enc_args, enc_kwargs,
                        pending: List[ObjectRef], pins: List):
        """Called from the (sync) submitting thread. One loop wakeup per
        burst: run_coroutine_threadsafe costs ~175us per call (Task +
        cross-thread handle + wakeup-fd write); a deque append plus a
        single coalesced call_soon_threadsafe turns a 1000-task burst's
        1000 wakeups into one."""
        self._submit_inbox.append((spec, enc_args, enc_kwargs, pending, pins))
        with self._inbox_lock:
            if self._inbox_scheduled:
                return
            self._inbox_scheduled = True
        try:
            self.io.loop.call_soon_threadsafe(self._drain_submit_inbox)
        except RuntimeError:
            # loop closed (shutdown race): un-latch so later submissions
            # raise here too instead of silently piling into a dead inbox
            with self._inbox_lock:
                self._inbox_scheduled = False
            raise

    def _drain_submit_inbox(self):
        """On the io loop: drain queued submissions in FIFO order. Specs
        with unresolved deps get a waiter task; the rest route
        synchronously (no coroutine at all). Bounded per callback: a
        producer thread submitting at or above the drain rate must not
        starve the loop's other callbacks (socket flushes, result
        delivery), so only the entries present at entry are drained and a
        fresh callback is scheduled for any remainder."""
        with self._inbox_lock:
            self._inbox_scheduled = False
        for _ in range(len(self._submit_inbox)):
            try:
                spec, enc_args, enc_kwargs, pending, pins = \
                    self._submit_inbox.popleft()
            except IndexError:
                break
            try:
                if pending:
                    self._spawn(self._submit_when_ready(
                        spec, enc_args, enc_kwargs, pending, pins
                    ))
                else:
                    self._finish_submit(spec, enc_args, enc_kwargs, pins)
            except Exception as e:
                logger.exception("submission failed for %s", spec.name)
                self._fail_returns(spec, f"task submission failed: {e!r}")
        if self._submit_inbox:
            with self._inbox_lock:
                if self._inbox_scheduled:
                    return
                self._inbox_scheduled = True
            asyncio.get_running_loop().call_soon(self._drain_submit_inbox)

    async def _flush_submits(self):
        await asyncio.sleep(0)  # one tick: let same-burst submissions land
        batch, self._submit_buf = self._submit_buf, []
        self._submit_flushing = False
        if not batch:
            return
        payload = {"specs": batch}
        if cfg.submit_ack_mode == "batch":
            # fire-and-forget lane: the raylet acks frame ACCEPTANCE and
            # schedules in the background; per-task failures surface via
            # the owner's task_result stream + task events, so this await
            # no longer spans per-spec scheduling
            payload["ack"] = "batch"
        try:
            # retried with backoff; the idem token is keyed on the FULL
            # frame (first, last, len): a frame is identified by its exact
            # spec run, so a retry never aliases a different batch that
            # merely shares its head (the old first-spec-only key deduped
            # a grown/regrouped retry frame wrong)
            await call_with_retries(
                lambda: self.raylet, "submit_batch", payload,
                idem=("submit_batch", batch[0].task_id, batch[-1].task_id,
                      len(batch), batch[0].attempt),
            )
            for spec in batch:
                self._submit_stage[spec.task_id] = "raylet_accepted"
        except Exception as e:
            for spec in batch:
                self._fail_returns(spec, f"task submission failed: {e}")

    # -- direct task push over worker leases ---------------------------
    def _observe_direct_placement(self, batch):
        """Stamp ready->push latency for direct-push specs (the direct
        half of the two-path placement-latency histogram)."""
        now = time.perf_counter()
        hist = self._direct_placement_lat
        if hist is None:
            from ray_tpu_torch._private import metrics_core as mc

            hist = self._direct_placement_lat = mc.registry().histogram(
                "raylet_task_placement_latency_seconds",
                "Task ready to dispatched-to-worker, by dispatch path",
                scale=mc.LATENCY,
            ).labels(node=self.node_id[:12], path="direct")
        for spec in batch:
            t0 = self._direct_ready_at.pop(spec.task_id, None)
            if t0 is not None:
                hist.record(now - t0)

    def _drop_direct_stamps(self, batch):
        for spec in batch:
            self._direct_ready_at.pop(spec.task_id, None)

    def _direct_enqueue(self, spec: TaskSpec):
        key = (tuple(sorted(spec.resources.items())), repr(spec.runtime_env))
        self._direct_ready_at[spec.task_id] = time.perf_counter()
        self._direct_q.setdefault(key, deque()).append(spec)
        ev = self._direct_events.get(key)
        if ev is None:
            ev = self._direct_events[key] = asyncio.Event()
        ev.set()
        t = self._direct_pumps.get(key)
        if t is None or t.done():
            self._direct_pumps[key] = self._spawn(self._direct_pump(key))

    async def _direct_pump(self, key: tuple):
        """One pump per scheduling class: lease workers from the raylet,
        fan feeders over the leases, and HOLD the leases across bursts —
        when the class queue drains, the pump keeps its grant warm for
        direct_lease_grace_s (grace-period return) so a sequential
        submit→get loop's next call rides the already-open lease conns
        with zero raylet round trips instead of re-leasing per burst.
        Each burst tops the grant up toward the queue-depth ask (lease
        prefetch: the held leases are already in hand before the lease
        RPC for the delta returns). Zero grants (no local capacity /
        feature off on the raylet) falls back to raylet-routed
        submission, which spills across nodes as usual."""
        q = self._direct_q[key]
        held: List[dict] = []
        try:
            while True:
                if not q:
                    if not held or cfg.direct_lease_grace_s <= 0:
                        break
                    # grace window: keep the grant warm for the next burst
                    ev = self._direct_events[key]
                    ev.clear()
                    if q:  # a spec landed between the check and the clear
                        continue
                    try:
                        await asyncio.wait_for(
                            ev.wait(), cfg.direct_lease_grace_s
                        )
                    except asyncio.TimeoutError:
                        break
                    continue
                spec0 = q[0]
                depth = cfg.direct_lease_pipeline_depth
                want = min(cfg.direct_lease_max,
                           max(1, (len(q) + depth - 1) // depth))
                spillable = False
                if len(held) < want:
                    try:
                        reply = await self.raylet.request(
                            "lease_workers",
                            {"resources": dict(spec0.resources),
                             "runtime_env": spec0.runtime_env,
                             "job_id": self.job_id,
                             "count": want - len(held)},
                        )
                        held.extend(reply.get("leases") or [])
                        spillable = bool(reply.get("spillable"))
                    except Exception:
                        pass
                if not held:
                    batch = list(q)
                    q.clear()
                    self._drop_direct_stamps(batch)
                    try:
                        await self.raylet.request(
                            "submit_batch", {"specs": batch}
                        )
                        for s in batch:
                            self._submit_stage[s.task_id] = "raylet_no_lease"
                    except Exception as e:
                        for s in batch:
                            self._fail_returns(
                                s, f"task submission failed: {e}"
                            )
                    continue
                # Local leases can't absorb an arbitrarily deep queue —
                # but detouring the tail through the raylet only helps
                # when that reaches capacity BEYOND these leases: on a
                # multi-node cluster (reply.spillable) whose local grant
                # is the bottleneck — fewer granted than asked, or the
                # ask itself clamped at direct_lease_max. An unclamped
                # full grant just means the burst outran the ask (the
                # submit drain races the lease round trip), and on a
                # single node the raylet would dispatch to the same
                # workers via the slow path — either way the queue stays
                # on the direct pipelines, where feeders amortize via
                # spec batching and the pump re-leases next iteration.
                cap = len(held) * depth * 8
                local_limit = (len(held) < want
                               or want >= cfg.direct_lease_max)
                if (local_limit and spillable
                        and len(q) > cap):
                    tail = [q.pop() for _ in range(len(q) - cap)]
                    tail.reverse()
                    self._drop_direct_stamps(tail)
                    try:
                        await self.raylet.request(
                            "submit_batch", {"specs": tail}
                        )
                        for s in tail:
                            self._submit_stage[s.task_id] = "raylet_spill"
                    except Exception as e:
                        for s in tail:
                            self._fail_returns(
                                s, f"task submission failed: {e}"
                            )
                ev = self._direct_events[key]
                # one LINGERING feeder per lease; the rest exit on drain.
                # A sync call loop then pays one event wakeup per call
                # instead of a thundering herd of `depth` waiters, while
                # burst capacity (depth in-flight per lease) is restored
                # by the pump respawning the full fan on the next round.
                feeders = [
                    self._spawn(self._direct_feed(lease, q, ev,
                                                  linger=(j == 0)))
                    for lease in held for j in range(depth)
                ]
                # return_exceptions: one crashed feeder must not kill the
                # pump before the leases are returned — a dead pump strands
                # the lease's reserved CPU and every spec still queued.
                for res in await asyncio.gather(
                    *feeders, return_exceptions=True
                ):
                    if isinstance(res, BaseException):
                        logger.error("direct feeder crashed: %r", res,
                                     exc_info=res)
        finally:
            for lease in held:
                try:
                    await self.raylet.notify(
                        "return_lease", {"lease_id": lease["lease_id"]}
                    )
                except Exception:
                    pass
            self._direct_pumps.pop(key, None)
            if q:  # a burst landed during the finally window: restart
                self._direct_pumps[key] = self._spawn(self._direct_pump(key))
            else:
                self._direct_q.pop(key, None)

    async def _direct_conn(self, lease: dict) -> Optional[Connection]:
        ep = (lease["host"], lease["port"])
        conn = self._direct_conns.get(ep)
        if conn is not None and not conn.closed:
            return conn
        try:
            conn = await connect(ep[0], ep[1], handler=self,
                                 name=f"direct:{ep[1]}", retries=2)
        except Exception:
            return None
        self._direct_conns[ep] = conn
        return conn

    async def _direct_feed(self, lease: dict, q: deque, ev: asyncio.Event,
                           linger: bool = True):
        conn = await self._direct_conn(lease)
        # hotpath: begin direct_feed (per-spec stamps are precomputed —
        # no per-call string formatting on the steady-state push path)
        pushed_stage = "pushed:%d" % lease["port"]
        while True:
            if not q:
                if not linger:
                    return  # non-lingering feeder: exit on drain
                # linger: a sequential submit-get loop reuses the standing
                # lease (2 hops/call) instead of re-leasing per call
                ev.clear()
                if q:  # a spec landed between the check and the clear
                    ev.set()
                    continue
                try:
                    await asyncio.wait_for(
                        ev.wait(), cfg.direct_lease_linger_s
                    )
                except asyncio.TimeoutError:
                    return
                continue
            # Adaptive batching: take whatever burst accumulated while the
            # previous round-trip was in flight (one spec when idle — same
            # latency as the unbatched path; a deep queue amortizes the
            # per-message frame/dispatch cost across up to batch_max specs).
            k = min(len(q), cfg.direct_push_batch_max)
            batch = [q.popleft() for _ in range(k)]
            if conn is None or conn.closed:
                # endpoint gone BEFORE anything was sent: the tasks never
                # started, so reroute via the raylet without consuming a
                # retry attempt (at-most-once was never at risk)
                self._drop_direct_stamps(batch)
                try:
                    await self.raylet.request(
                        "submit_batch", {"specs": batch}
                    )
                    for spec in batch:
                        self._submit_stage[spec.task_id] = "raylet_reroute"
                except Exception as e:
                    for spec in batch:
                        self._fail_returns(
                            spec, f"task submission failed: {e}"  # lint: allow-hotpath (reroute error path)
                        )
                return
            for spec in batch:
                self._submit_stage[spec.task_id] = pushed_stage
            self._observe_direct_placement(batch)
            # hotpath: end direct_feed
            try:
                # timeout=0 (unbounded): these awaits span the USER CODE's
                # runtime — a deadline would falsely fail long tasks.
                # Keepalive detects the dead-worker case instead.
                if len(batch) == 1:
                    results = [await conn.request(
                        "execute_task", {"spec": batch[0]}, timeout=0
                    )]
                else:
                    # batch results STREAM back as task_result notifies as
                    # each task finishes (so ray.wait sees early tasks);
                    # the response is only the completion ack
                    await conn.request(
                        "execute_task_batch", {"specs": batch}, timeout=0
                    )
                    results = None
            except Exception:
                for spec in batch:
                    with self._lock:
                        # a streamed result may have landed (and popped the
                        # inflight record) before the connection died —
                        # re-running THAT task would double-execute it
                        still_pending = spec.task_id in self._specs_inflight
                    if not still_pending:
                        continue
                    self._submit_stage[spec.task_id] = "worker_lost"
                    try:
                        await self._direct_worker_lost(spec, lease)
                    except Exception:
                        logger.exception(
                            "direct-push loss handling failed for %s",
                            spec.name,
                        )
                        self._fail_returns_exc(
                            spec, WorkerDiedError("leased worker lost")
                        )
                return
            if results is None:
                continue  # batch path: results already streamed + processed
            # The spec is consumed from the queue: any failure past this
            # point MUST still resolve the task's returns, or the caller's
            # get() blocks forever on an object nobody will produce.
            for spec, result in zip(batch, results):
                self._submit_stage[spec.task_id] = "resulted"
                try:
                    await self._direct_result(spec, result)
                except Exception as e:
                    logger.exception(
                        "direct result processing failed for %s", spec.name
                    )
                    self._fail_returns(
                        spec, f"internal error processing task result: {e!r}"
                    )

    # -- direct actor calls --------------------------------------------
    def _actor_direct_enqueue(self, spec: TaskSpec):
        st = self._actor_direct.setdefault(
            spec.actor_id,
            {"q": deque(), "running": False, "conn": None,
             "fallback": False, "inflight": 0, "relost": [],
             "settled": asyncio.Event(), "wake": asyncio.Event()},
        )
        st["q"].append(spec)
        st["wake"].set()  # rouse a lingering sender
        if not st["running"]:
            st["running"] = True
            self._spawn(self._actor_sender(spec.actor_id, st))

    async def _actor_sender(self, actor_id: bytes, st: dict):
        """Single sender per actor: pipelined in-order request_nowait
        pushes over one connection (wire order = call order; replies are
        awaited concurrently).

        Ordering across failures: once ANY call for this actor has been
        routed via the raylet (direct endpoint unavailable, or a direct
        conn broke mid-burst), the actor goes into STICKY raylet fallback.
        Mixing routes would let a later seq overtake an earlier one in the
        restart window, and the fresh executor's seq gate would anchor on
        the wrong call. Recovery waits for every in-flight direct reply to
        settle, then resubmits the failed calls lowest-seq-first ahead of
        anything still queued."""
        # one tick before draining: under the eager task factory the sender
        # would otherwise run synchronously inside the FIRST enqueue of a
        # burst and see a one-deep queue (no batching, one frame per call)
        await asyncio.sleep(0)
        loop = asyncio.get_running_loop()
        try:
            while True:
                if not (st["q"] or st["relost"]):
                    # linger on drain: a sync call loop reuses this sender
                    # (and its pipelined conn + warm-up tick) instead of
                    # paying a task spawn per call; the enqueue path sets
                    # st["wake"] to rouse it
                    if cfg.actor_sender_linger_s <= 0:
                        return
                    wake = st["wake"]
                    wake.clear()
                    if st["q"] or st["relost"]:
                        continue  # raced an enqueue between check and clear
                    try:
                        await asyncio.wait_for(
                            wake.wait(), cfg.actor_sender_linger_s
                        )
                    except asyncio.TimeoutError:
                        return  # finally respawns if an enqueue raced this
                    continue
                if st["fallback"]:
                    # collect every outcome before rerouting so the raylet
                    # sees the calls in seq order
                    while st["inflight"]:
                        st["settled"].clear()
                        await st["settled"].wait()
                    relost, st["relost"] = st["relost"], []
                    relost.sort(key=lambda s: s.seq_no)
                    batch = relost + list(st["q"])
                    st["q"].clear()
                    if not batch:
                        continue
                    try:
                        await self.raylet.request(
                            "submit_batch", {"specs": batch}
                        )
                    except Exception as e:
                        for s in batch:
                            self._fail_returns(
                                s, f"task submission failed: {e}"
                            )
                    continue
                conn = st["conn"]
                if conn is None or conn.closed:
                    # never dial a new incarnation while old in-flight
                    # calls are unsettled: the new conn could deliver a
                    # later seq before the earlier seq's failure rerouted
                    while st["inflight"]:
                        st["settled"].clear()
                        await st["settled"].wait()
                    if st["fallback"]:
                        continue
                    conn = await self._actor_direct_connect(actor_id)
                    st["conn"] = conn
                    if conn is None:
                        st["fallback"] = True
                        continue
                if self._actor_sequential.get(actor_id):
                    # Strictly sequential actor: a burst may ride ONE
                    # frame/dispatch without changing call semantics. Cap
                    # frames in flight so the NEXT burst accumulates into a
                    # real batch instead of leaving one spec at a time
                    # (a submitting thread slower than this loop would
                    # otherwise never see queue depth > 1).
                    while (st["inflight"] >= cfg.actor_direct_max_inflight
                           and not st["fallback"]
                           and st["conn"] is conn and not conn.closed):
                        st["settled"].clear()
                        await st["settled"].wait()
                    if (st["fallback"] or st["conn"] is not conn
                            or conn.closed):
                        continue  # re-evaluate route from the loop top
                    if not st["q"]:
                        continue
                    k = min(len(st["q"]), cfg.direct_push_batch_max)
                    batch = [st["q"].popleft() for _ in range(k)]
                else:
                    batch = [st["q"].popleft()]
                try:
                    if len(batch) == 1:
                        fut = conn.request_nowait(
                            "execute_task", {"spec": batch[0]}
                        )
                    else:
                        fut = conn.request_nowait(
                            "execute_task_batch", {"specs": batch}
                        )
                except Exception:
                    st["conn"] = None
                    st["fallback"] = True
                    st["relost"].extend(batch)
                    continue
                st["inflight"] += 1
                self._spawn(
                    self._actor_direct_reply(actor_id, st, batch, fut)
                )
        finally:
            st["running"] = False
            if (st["q"] or st["relost"]) and not st["running"]:
                st["running"] = True
                self._spawn(self._actor_sender(actor_id, st))

    async def _actor_direct_connect(self, actor_id: bytes):
        try:
            table = await self.gcs.request(
                "wait_actor_alive",
                {"actor_id": actor_id,
                 "timeout": cfg.actor_route_wait_alive_timeout_s},
            )
        except Exception:
            return None
        if (not table or table.get("state") != "ALIVE"
                or not table.get("direct_addr")):
            return None
        host, port = table["direct_addr"]
        try:
            return await connect(host, port, handler=self,
                                 name=f"actor-direct:{port}", retries=2)
        except Exception:
            return None

    async def _actor_direct_reply(self, actor_id: bytes, st: dict,
                                  batch: List[TaskSpec], fut):
        try:
            results = await fut
            # batch replies are completion acks — the per-call results
            # streamed back as task_result notifies while the batch ran
            results = [results] if len(batch) == 1 else None
        except Exception:
            # Worker died / restarting: flip to sticky raylet fallback. The
            # calls were SENT, so their fate is unknown — at-most-once actor
            # semantics (ray: actor tasks are NOT retried unless
            # max_task_retries is set) forbid blind resubmission: a
            # side-effecting call like `die()` would re-execute against the
            # restarted incarnation and burn its max_restarts budget.
            st["fallback"] = True
            if st.get("conn") is not None and st["conn"].closed:
                st["conn"] = None
            for spec in batch:
                with self._lock:
                    # a streamed result may have landed before the failure;
                    # re-submitting THAT call would break at-most-once
                    still_pending = spec.task_id in self._specs_inflight
                if not still_pending:
                    continue
                if spec.attempt < spec.max_retries:
                    spec.attempt += 1
                    st["relost"].append(spec)
                else:
                    self._fail_returns_exc(spec, ActorDiedError(
                        f"The actor died while this call was in flight; "
                        f"actor tasks run at-most-once and are not retried "
                        f"unless max_task_retries is set "
                        f"(method {spec.name!r})."
                    ))
            st["inflight"] -= 1
            st["settled"].set()
            if not st["running"]:
                st["running"] = True
                self._spawn(self._actor_sender(actor_id, st))
            return
        st["inflight"] -= 1
        st["settled"].set()
        if results is None:
            return  # batch path: results already streamed + processed
        for spec, result in zip(batch, results):
            try:
                await self._direct_result(spec, result)
            except Exception as e:
                logger.exception(
                    "actor-direct result processing failed for %s", spec.name
                )
                self._fail_returns(
                    spec, f"internal error processing task result: {e!r}"
                )

    async def _direct_worker_lost(self, spec: TaskSpec,
                                  lease: Optional[dict] = None):
        """Leased worker died/unreachable mid-push: resolve WHY from the
        raylet (e.g. an OOM kill must surface as such, not as a generic
        connection loss), then feed the standard failure path (it retries
        via the raylet when retriable)."""
        reason = "leased worker lost"
        if lease and lease.get("worker_id"):
            for _ in range(3):
                try:
                    fate = await self.raylet.request(
                        "worker_fate", {"client_id": lease["worker_id"]}
                    )
                except Exception:
                    break
                if fate.get("reason"):
                    reason = fate["reason"]
                    break
                if not fate.get("alive"):
                    break
                # raylet hasn't processed the worker's death yet
                await asyncio.sleep(0.1)
        await self.rpc_task_result(self.raylet, {
            "task_id": spec.task_id, "results": None,
            "error": reason, "system_error": True, "worker_died": True,
            "retriable": True, "attempt": spec.attempt,
        })

    async def _direct_result(self, spec: TaskSpec, result: dict):
        """Adapt the executor's result dict into the task_result payload
        the raylet would have delivered (raylet._deliver_result shape);
        stored-object locations were self-reported by the worker."""
        await self.rpc_task_result(self.raylet, {
            "task_id": spec.task_id,
            "results": result.get("results"),
            "error": result.get("error"),
            "error_value": result.get("error_value"),
            "app_error": result.get("app_error", False),
            "retriable": result.get("retriable", False),
            "attempt": spec.attempt,
            "exec_addr": result.get("exec_addr"),
            "borrows_kept": result.get("borrows_kept"),
            "returns_nested": result.get("returns_nested"),
            "dynamic_return_oids": result.get("dynamic_return_oids"),
        })

    def _release_task_pins(self, task_id: bytes):
        with self._lock:
            pins = self._task_arg_pins.pop(task_id, None)
        for token in pins or ():
            self.unpin_object(token)

    def _fail_returns(self, spec: TaskSpec, message: str):
        self._fail_returns_exc(spec, RuntimeError(message))

    def _fail_returns_exc(self, spec: TaskSpec, exc: Exception):
        sv = serialization.serialize_error(exc, spec.name)
        tid = TaskID(spec.task_id)
        self._submit_stage.pop(spec.task_id, None)
        with self._lock:
            self._specs_inflight.pop(spec.task_id, None)
        for i in range(max(1, spec.num_returns)):
            oid = ObjectID.from_index(tid, i + 1)
            self._resolve_inline(oid.binary(), sv.metadata, sv.to_wire())
        self._fail_dynamic_item_futures(spec, sv)
        self._release_task_pins(spec.task_id)

    def _fail_dynamic_item_futures(self, spec: Optional[TaskSpec], sv):
        """A failed dynamic task must also resolve any ITEM futures parked
        by reconstruction (their indices aren't enumerable from
        num_returns): sweep pending futures keyed by this task's prefix."""
        if spec is None or spec.num_returns != -1:
            return
        prefix = spec.task_id
        with self._lock:
            pending = [
                oid for oid, f in self._futures.items()
                if oid.startswith(prefix) and not f.done()
            ]
        for oid in pending:
            self._resolve_inline(oid, sv.metadata, sv.to_wire())

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def task_template(
        self,
        func=None,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        scheduling: Optional[SchedulingStrategy] = None,
        max_retries: int = 3,
        retry_exceptions: bool = False,
        name: str = "",
        func_blob: Optional[bytes] = None,
        runtime_env: Optional[dict] = None,
    ) -> TaskTemplate:
        """Build the immutable submit template for a plain-task callsite:
        the constant half of submit_task, paid once per (RemoteFunction,
        options, worker) instead of per call."""
        import cloudpickle

        t = TaskTemplate()
        t.worker = self
        scheduling = scheduling or SchedulingStrategy()
        res = dict(resources if resources is not None else {"CPU": 1.0})
        if scheduling.kind == "PLACEMENT_GROUP":
            res = rewrite_resources_for_pg(
                res, scheduling.pg_id, scheduling.pg_bundle_index
            )
        t.resources = res
        t.scheduling = scheduling
        t.name = name or getattr(func, "__name__", "task")
        t.func_blob = (func_blob if func_blob is not None
                       else cloudpickle.dumps(func))
        t.method_name = None
        t.num_returns = num_returns
        t.max_retries = max_retries
        t.retry_exceptions = retry_exceptions
        t.runtime_env = runtime_env
        t.actor_id = None
        t.concurrency_group = None
        t.minter = TaskIDMinter.for_job(JobID(self.job_id))
        return t

    def actor_task_template(
        self,
        actor_id: bytes,
        method_name: str,
        num_returns: int = 1,
        max_task_retries: int = 0,
        concurrency_group: Optional[str] = None,
    ) -> TaskTemplate:
        """Submit template for one actor method callsite (the constant
        half of submit_actor_task)."""
        t = TaskTemplate()
        t.worker = self
        t.name = method_name
        t.method_name = method_name
        t.func_blob = None
        t.num_returns = num_returns
        t.resources = {}
        t.scheduling = None
        t.max_retries = max_task_retries
        t.retry_exceptions = False
        t.runtime_env = None
        t.actor_id = actor_id
        t.concurrency_group = concurrency_group
        t.minter = TaskIDMinter.for_actor(ActorID(actor_id))
        return t

    # hotpath: begin submit (lint_hotpath: no per-call dict( copies or
    # f-string id minting — constant work belongs in the template)
    def submit_from_template(self, tmpl: TaskTemplate, args,
                             kwargs) -> List[ObjectRef]:
        """Per-call half of plain-task submission: mint an id from the
        template's block minter, encode the arguments, stamp the spec."""
        timed = cfg.control_plane_stage_timing
        t0 = time.perf_counter() if timed else 0.0
        task_id = tmpl.minter.next_binary()
        if timed:
            _stage_record("id_mint", time.perf_counter() - t0)
        pins: List = []
        enc_args, enc_kwargs, pending = self._encode_slots(args, kwargs, pins)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            name=tmpl.name,
            func_blob=tmpl.func_blob,
            method_name=None,
            num_returns=tmpl.num_returns,
            resources=tmpl.resources,
            scheduling=tmpl.scheduling,
            owner=self.addr,
            max_retries=tmpl.max_retries,
            retry_exceptions=tmpl.retry_exceptions,
            caller_id=self._caller_id,
            runtime_env=tmpl.runtime_env,
            tracing_ctx=_tracing_ctx(),
        )
        refs = self._register_returns(spec)
        self._enqueue_submit(spec, enc_args, enc_kwargs, pending, pins)
        if timed:
            _stage_record("envelope_build", time.perf_counter() - t0)
        return refs

    def submit_actor_from_template(self, tmpl: TaskTemplate, args,
                                   kwargs) -> List[ObjectRef]:
        """Per-call half of actor-task submission: mint, stamp the seq,
        encode, enqueue."""
        timed = cfg.control_plane_stage_timing
        t0 = time.perf_counter() if timed else 0.0
        task_id = tmpl.minter.next_binary()
        if timed:
            _stage_record("id_mint", time.perf_counter() - t0)
        actor_id = tmpl.actor_id
        with self._lock:
            seq = self._actor_seq.get(actor_id, 0)
            self._actor_seq[actor_id] = seq + 1
        pins: List = []
        enc_args, enc_kwargs, pending = self._encode_slots(args, kwargs, pins)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            name=tmpl.name,
            func_blob=None,
            method_name=tmpl.method_name,
            num_returns=tmpl.num_returns,
            resources=tmpl.resources,
            owner=self.addr,
            actor_id=actor_id,
            max_retries=tmpl.max_retries,
            seq_no=seq,
            caller_id=self._caller_id,
            tracing_ctx=_tracing_ctx(),
            concurrency_group=tmpl.concurrency_group,
        )
        refs = self._register_returns(spec)
        self._enqueue_submit(spec, enc_args, enc_kwargs, pending, pins)
        if timed:
            _stage_record("envelope_build", time.perf_counter() - t0)
        return refs
    # hotpath: end submit

    def submit_task(
        self,
        func,
        args=(),
        kwargs=None,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        scheduling: Optional[SchedulingStrategy] = None,
        max_retries: int = 3,
        retry_exceptions: bool = False,
        name: str = "",
        func_blob: Optional[bytes] = None,
        runtime_env: Optional[dict] = None,
    ) -> List[ObjectRef]:
        """One-shot submission (no callsite cache): builds a throwaway
        template. The API layer's RemoteFunction caches the template and
        calls submit_from_template directly."""
        tmpl = self.task_template(
            func=func, num_returns=num_returns, resources=resources,
            scheduling=scheduling, max_retries=max_retries,
            retry_exceptions=retry_exceptions, name=name,
            func_blob=func_blob, runtime_env=runtime_env,
        )
        return self.submit_from_template(tmpl, args, kwargs)

    # hotpath: begin register_returns
    def _register_returns(self, spec: TaskSpec) -> List[ObjectRef]:
        refs = []
        task_binary = spec.task_id
        addr = self.addr
        # dynamic (-1): one visible return — the ref-list; item objects are
        # adopted at result time (rpc_task_result dynamic_return_oids)
        n = 1 if spec.num_returns == -1 else spec.num_returns
        with self._lock:
            self._specs_inflight[task_binary] = spec
            for i in range(n):
                ob = object_id_binary(task_binary, i + 1)
                fut = concurrent.futures.Future()
                self._futures[ob] = fut
                self._owned.add(ob)
                refs.append(ObjectRef(ObjectID(ob), addr))
        for r in refs:
            self.add_local_ref(r)
        return refs
    # hotpath: end register_returns

    # -- actors ---------------------------------------------------------
    def create_actor(
        self,
        cls,
        args,
        kwargs,
        resources: Dict[str, float],
        scheduling: Optional[SchedulingStrategy] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        concurrency_groups: Optional[Dict[str, int]] = None,
        lifetime: Optional[str] = None,
        name: Optional[str] = None,
        namespace: Optional[str] = None,
        runtime_env: Optional[dict] = None,
    ) -> bytes:
        import cloudpickle

        actor_id = ActorID.of(JobID(self.job_id))
        self._actor_sequential[actor_id.binary()] = (
            max_concurrency == 1 and not concurrency_groups
        )
        resources = dict(resources)
        scheduling = scheduling or SchedulingStrategy()
        if scheduling.kind == "PLACEMENT_GROUP":
            resources = rewrite_resources_for_pg(
                resources, scheduling.pg_id, scheduling.pg_bundle_index
            )
        pins: List = []
        enc_args, enc_kwargs, pending = self._encode_slots(args, kwargs, pins)
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(actor_id).binary(),
            job_id=self.job_id,
            name=getattr(cls, "__name__", "Actor"),
            func_blob=cloudpickle.dumps(cls),
            method_name=None,
            resources=resources,
            scheduling=scheduling,
            owner=self.addr,
            actor_id=actor_id.binary(),
            actor_creation=True,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            concurrency_groups=dict(concurrency_groups or {}),
            lifetime=lifetime,
            name_registered=name,
            namespace=namespace or self.namespace,
            runtime_env=runtime_env,
            caller_id=self.client_id.encode(),
        )
        if not pending:
            spec.args = [self._finalize_slot(s, pins) for s in enc_args]
            spec.kwargs = {k: self._finalize_slot(s, pins)
                           for k, s in enc_kwargs.items()}
            self._hold_actor_creation_pins(actor_id.binary(), pins)
            # side-effectful: the actor_id itself is the idempotency token,
            # so a retried registration can't double-register the actor
            reply = self.io.run(
                call_with_retries(
                    lambda: self.gcs, "register_actor", {"spec": spec},
                    timeout=cfg.gcs_rpc_timeout_s,
                    idem=("register_actor", actor_id.binary()),
                ),
                # outer bound > worst-case inner (attempts x (rpc + backoff))
                timeout=(cfg.gcs_rpc_timeout_s + cfg.rpc_retry_max_delay_s)
                * cfg.rpc_retry_attempts + 5.0,
            )
            if reply.get("error"):
                raise ValueError(reply["error"])
        else:
            self.io.call_soon(
                self._register_actor_when_ready(
                    spec, enc_args, enc_kwargs, pending, pins
                )
            )
        return actor_id.binary()

    async def _register_actor_when_ready(self, spec, enc_args, enc_kwargs,
                                         pending, pins):
        for ref in pending:
            try:
                await asyncio.wait_for(
                    asyncio.wrap_future(self.future_for(ref)),
                    cfg.object_pull_timeout_s * 4,
                )
            except Exception:
                logger.error("actor %s creation dependency failed", spec.name)
        spec.args = [self._finalize_slot(s, pins) for s in enc_args]
        spec.kwargs = {k: self._finalize_slot(s, pins) for k, s in enc_kwargs.items()}
        self._hold_actor_creation_pins(spec.actor_id, pins)
        await call_with_retries(
            lambda: self.gcs, "register_actor", {"spec": spec},
            idem=("register_actor", spec.actor_id),
        )

    def _hold_actor_creation_pins(self, actor_id: bytes, pins: List):
        """Actor-creation args must survive restarts: the GCS replays the
        creation spec on failure, so the pins are held until the actor is
        permanently DEAD (ray: gcs_actor_manager.h lineage of creation spec)."""
        if not pins:
            return
        with self._lock:
            self._actor_creation_pins[actor_id] = pins
        if not self._actor_sub_done:
            self._actor_sub_done = True
            # Register the handler synchronously and schedule the GCS
            # subscribe as a loop task: this may run ON the io loop
            # (_register_actor_when_ready), where a blocking io.run would
            # deadlock the loop against itself.
            self._pubsub_handlers.setdefault("actor", []).append(self._on_actor_event)
            self.io.call_soon(self.gcs.request("subscribe", {"channel": "actor"}))

    def _on_actor_event(self, table: dict):
        if table.get("state") != "DEAD":
            return
        with self._lock:
            pins = self._actor_creation_pins.pop(table.get("actor_id"), None)
        for token in pins or ():
            self.unpin_object(token)

    def submit_actor_task(
        self,
        actor_id: bytes,
        method_name: str,
        args=(),
        kwargs=None,
        num_returns: int = 1,
        max_task_retries: int = 0,
        concurrency_group: Optional[str] = None,
    ) -> List[ObjectRef]:
        """One-shot actor submission (no callsite cache); ActorMethod
        caches a template and calls submit_actor_from_template directly."""
        tmpl = self.actor_task_template(
            actor_id, method_name, num_returns=num_returns,
            max_task_retries=max_task_retries,
            concurrency_group=concurrency_group,
        )
        return self.submit_actor_from_template(tmpl, args, kwargs)

    def get_actor_table(self, actor_id: Optional[bytes] = None,
                        name: Optional[str] = None, namespace: Optional[str] = None):
        return self.io.run(
            self.gcs.request(
                "get_actor",
                {"actor_id": actor_id, "name": name,
                 "namespace": namespace or self.namespace},
            )
        )

    def wait_actor_alive(self, actor_id: bytes, timeout: float = 60.0):
        return self.io.run(
            self.gcs.request("wait_actor_alive",
                             {"actor_id": actor_id, "timeout": timeout})
        )

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self.io.run(
            self.gcs.request("kill_actor", {"actor_id": actor_id, "no_restart": no_restart})
        )

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        task_id = ref.id().task_id()
        self.io.run(
            self.raylet.request("cancel_task", {"task_id": task_id.binary(), "force": force})
        )

    # ------------------------------------------------------------------
    # owner notifications (results arrive here)
    # ------------------------------------------------------------------
    # -- ownership-based object directory ------------------------------
    async def rpc_object_locations(self, conn: Connection, p):
        """Location lookup served by the OWNER (ray:
        ownership_based_object_directory.h) — raylets resolve here first,
        GCS directory second."""
        oid = p["object_id"]
        with self._lock:
            locs = set(self._owned_locations.get(oid, ()))
        if object_store.object_exists(self.store_dir, ObjectID(oid)):
            locs.add(self.node_id)
        return {"locations": list(locs)}

    def rpc_owner_add_location(self, conn: Connection, p):
        """A raylet created/received a copy of an object we own."""
        with self._lock:
            if p["object_id"] in self._owned:
                self._owned_locations.setdefault(
                    p["object_id"], set()
                ).add(p["node_id"])

    def rpc_owner_remove_location(self, conn: Connection, p):
        """A raylet found our recorded copy unreachable/gone: retract it
        so the directory converges (there is no eviction protocol)."""
        with self._lock:
            locs = self._owned_locations.get(p["object_id"])
            if locs is not None:
                locs.discard(p["node_id"])

    def _record_owned_location(self, oid: bytes, node_id: Optional[str]):
        if not node_id:
            return
        with self._lock:
            self._owned_locations.setdefault(oid, set()).add(node_id)

    async def rpc_task_result_batch(self, conn: Connection, payloads):
        """Tick-batched completions from the raylet (one frame per burst;
        see raylet._flush_owner_outbox)."""
        for p in payloads:
            await self.rpc_task_result(conn, p)

    async def rpc_task_result(self, conn: Connection, p):
        t0 = (time.perf_counter()
              if cfg.control_plane_stage_timing else 0.0)
        task_id: bytes = p["task_id"]
        with self._lock:
            spec = self._specs_inflight.get(task_id)
            if spec is not None and p.get("attempt", 0) < spec.attempt:
                return  # stale notification from a superseded attempt
        if p.get("error") is not None:
            await self._handle_task_error(spec, task_id, p)
            return
        results = p["results"] or []
        self._submit_stage.pop(task_id, None)
        with self._lock:
            self._specs_inflight.pop(task_id, None)
        # num_returns="dynamic": adopt ownership of the item objects BEFORE
        # the ref-list materializes (deserializing it registers refs, which
        # must find their oids in _owned), record their lineage so a lost
        # item re-executes this task, and pin each under the ref-list
        # container so dropping the (possibly never-materialized) list
        # frees the items (_maybe_free releases _contains pins).
        dyn_oids = p.get("dynamic_return_oids") or ()
        # Adopt only on the first (spec-bearing) delivery: the spilled-task
        # at-least-once resubmission path can deliver task_result twice, and
        # re-adopting would re-pin items under a ref-list that may already
        # have been freed, leaking escape pins.
        exec_node = (p.get("exec_addr") or (None,))[0]
        if dyn_oids and spec is not None:
            list_oid = object_id_binary(task_id, 1)
            tokens = []
            for oid in dyn_oids:
                with self._lock:
                    self._owned.add(oid)
                    if spec is not None:
                        self._lineage_insert_locked(oid, spec)
                self._record_owned_location(oid, exec_node)
                tokens.append(self.pin_object(oid, self.addr))
                # a reconstruction (or wait) may be parked on this item
                self._resolve_plasma(oid)
            with self._lock:
                self._contains.setdefault(list_oid, []).extend(tokens)
        # hotpath: begin task_result_resolve (raw oid binaries — no ID
        # object churn on the per-result resolve path)
        for i, res in enumerate(results):
            ob = object_id_binary(task_id, i + 1)
            if res[0] == "v":
                self._resolve_inline(ob, res[1], res[2])
            else:
                # the stored return lives on the executing node: record it
                # in the owner directory before anyone asks
                self._record_owned_location(ob, exec_node)
                self._resolve_plasma(ob)
        # hotpath: end task_result_resolve
        if spec is not None and any(r[0] == "r" for r in results):
            self._record_lineage(spec)
        # Borrower handoff, ordered so an object is always pinned somewhere:
        # 1. register borrows the executor kept (it holds arg refs until we
        #    do — our arg pins keep the containers alive meanwhile);
        # 2. register nested refs inside returns with their owners on our
        #    behalf, then ack the executor so it drops its return pins;
        # 3. only then release our own arg pins.
        exec_addr = p.get("exec_addr")
        if exec_addr is not None:
            for oid, owner in p.get("borrows_kept") or ():
                await self._register_borrow_for(oid, owner, tuple(exec_addr))
            nested_map = p.get("returns_nested") or {}
            if nested_map:
                for i, nested in nested_map.items():
                    roid = object_id_binary(task_id, int(i) + 1)
                    await self._adopt_contains(roid, nested)
                await self._owner_call(
                    exec_addr, "release_return_pins", {"task_id": task_id}
                )
        if spec is not None:
            self._release_task_pins(task_id)
        # Returns whose refs were already dropped can be freed now.
        for i in range(len(results)):
            self._maybe_free(object_id_binary(task_id, i + 1))
        if t0:
            _stage_record("result_return", time.perf_counter() - t0)

    async def _register_borrow_for(self, oid: bytes, owner, borrower: tuple):
        """Register ``borrower`` with ``oid``'s owner (us or remote)."""
        if owner is not None and tuple(owner) == self.addr:
            self._register_borrower(oid, borrower)
        elif owner is not None and tuple(owner) != borrower:
            await self._owner_call(
                owner, "borrow_add", {"object_id": oid, "borrower": borrower}
            )

    async def _adopt_contains(self, container_oid: bytes, nested):
        """We now own ``container_oid`` whose value holds ``nested`` refs:
        pin each (borrow-acquire if foreign) and register with its owner.
        Released when the container is freed (ray: AddNestedObjectIds)."""
        tokens = []
        for oid, owner in nested:
            tokens.append(self.pin_object(oid, owner))
            await self._register_borrow_for(oid, owner, self.addr)
        with self._lock:
            if container_oid in self._owned:
                self._contains.setdefault(container_oid, []).extend(tokens)
                tokens = []
        for t in tokens:  # container already freed: drop immediately
            self.unpin_object(t)

    async def _owner_call(self, owner, method: str, payload, timeout=None):
        try:
            return await self.raylet.request(
                "owner_call",
                {"owner": tuple(owner), "method": method, "payload": payload,
                 "timeout": timeout or cfg.gcs_rpc_timeout_s},
                timeout=(timeout or cfg.gcs_rpc_timeout_s) + 10.0,
            )
        except Exception:
            return {"owner_dead": True}

    def _lineage_insert_locked(self, oid: bytes, spec: TaskSpec):
        """Insert under self._lock, enforcing the FIFO cap."""
        self._lineage[oid] = spec
        overflow = len(self._lineage) - cfg.max_lineage_cache_entries
        if overflow > 0:
            for old in list(self._lineage)[:overflow]:
                del self._lineage[old]

    def _record_lineage(self, spec: TaskSpec):
        """Remember the finalized spec so lost plasma returns can be
        re-executed (ray: task_manager.h lineage pinning, FIFO-capped)."""
        tid = TaskID(spec.task_id)
        with self._lock:
            for i in range(max(1, spec.num_returns)):
                self._lineage_insert_locked(
                    ObjectID.from_index(tid, i + 1).binary(), spec
                )

    async def _handle_task_error(self, spec: Optional[TaskSpec], task_id: bytes, p):
        retriable = p.get("retriable", False)
        app_error = p.get("app_error", False)
        if spec is not None and retriable and spec.attempt < spec.max_retries and (
            not app_error or spec.retry_exceptions
        ):
            spec.attempt += 1
            logger.info("retrying task %s (attempt %d)", spec.name, spec.attempt)
            await asyncio.sleep(cfg.task_retry_delay_ms / 1000.0)
            if p.get("lost_object"):
                # A dependency's plasma copy is gone cluster-wide: try lineage
                # reconstruction before the retry (object_recovery_manager.h).
                # The dependency's owner lives in the matching "r" arg slot.
                lost = p["lost_object"]
                lost_owner = None
                if spec is not None:
                    for a in list(spec.args) + list(spec.kwargs.values()):
                        if a[0] == "r" and a[1] == lost and len(a) > 2:
                            lost_owner = a[2]
                            break
                try:
                    await self._ensure_object_available(lost, lost_owner)
                except Exception as e:
                    logger.warning("dependency recovery failed: %s", e)
            try:
                await self.raylet.request("submit_task", {"spec": spec})
                return
            except Exception:
                pass
        self._submit_stage.pop(task_id, None)
        with self._lock:
            self._specs_inflight.pop(task_id, None)
        tid = TaskID(task_id)
        n_returns = max(1, spec.num_returns) if spec else 1
        if p.get("error_value"):
            meta, data = p["error_value"]
        else:
            if p.get("actor_dead"):
                exc = ActorDiedError(p["error"])
            elif p.get("cancelled"):
                exc = TaskCancelledError(p["error"])
            elif p.get("worker_died"):
                exc = WorkerDiedError(p["error"])
            else:
                exc = RuntimeError(p["error"])
            sv = serialization.serialize_error(exc, spec.name if spec else "")
            meta, data = sv.metadata, sv.to_wire()
        for i in range(n_returns):
            oid = ObjectID.from_index(tid, i + 1)
            self._resolve_inline(oid.binary(), meta, data)
        if spec is not None and spec.num_returns == -1:
            # item futures parked by a dynamic reconstruction must see the
            # terminal error too, or gets on them hang forever
            prefix = spec.task_id
            with self._lock:
                pending = [
                    o for o, f in self._futures.items()
                    if o.startswith(prefix) and not f.done()
                ]
            for o in pending:
                self._resolve_inline(o, meta, data)
        if spec is not None:
            # A failed task may still have stashed arg refs (actor state):
            # register those borrows before dropping our arg pins.
            exec_addr = p.get("exec_addr")
            if exec_addr is not None:
                for oid_b, owner in p.get("borrows_kept") or ():
                    await self._register_borrow_for(oid_b, owner, tuple(exec_addr))
            self._release_task_pins(task_id)

    def _resolve_inline(self, oid: bytes, metadata: bytes, data):
        """``data`` is bytes or a serialization.BufferList (the zero-copy
        wire form — deserialize consumes either)."""
        with self._lock:
            self._memory_store[oid] = (metadata, data)
            fut = self._futures.get(oid)
        if fut and not fut.done():
            fut.set_result(("inline", metadata, data))

    def _resolve_plasma(self, oid: bytes):
        with self._lock:
            fut = self._futures.get(oid)
        if fut and not fut.done():
            fut.set_result(("plasma", None, None))

    # serving borrowers fetching owned values
    async def rpc_fetch_owned(self, conn: Connection, p):
        oid = p["object_id"]
        with self._lock:
            inline = self._memory_store.get(oid)
            fut = self._futures.get(oid)
        if inline is not None:
            return {"inline": inline}
        if fut is not None and fut.done():
            return {"plasma": True}
        if fut is not None:
            return {"pending": True}
        return {"unknown": True}

    async def rpc_dump_stacks(self, conn: Connection, p):
        """Thread stack dump of this process (ray parity:
        dashboard/modules/reporter/profile_manager.py py-spy dump — here
        native sys._current_frames, no external profiler needed)."""
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        current = getattr(self, "executor", None)
        task = getattr(current, "current_task_id", None) if current else None
        for ident, frame in sys._current_frames().items():
            stack = "".join(traceback.format_stack(frame))
            out[f"{names.get(ident, '?')}-{ident}"] = stack
        return {
            "pid": os.getpid(),
            "client_id": self.client_id,
            "current_task": task.hex()[:16] if task else None,
            "threads": out,
        }

    # -- on-demand profiling (profiler.py; ray parity: dashboard
    # reporter's py-spy/memray attach, here in-process) ------------------
    def _profiler(self):
        svc = getattr(self, "_profiler_svc", None)
        if svc is None:
            from ray_tpu_torch._private import profiler

            svc = self._profiler_svc = profiler.ProfilerService(
                role="driver" if self.is_driver else "worker"
            )
        return svc

    async def rpc_profile_start(self, conn: Connection, p):
        return self._profiler().start(p or {})

    async def rpc_profile_stop(self, conn: Connection, p):
        return self._annotate_profile(self._profiler().stop(p or {}))

    async def rpc_profile_status(self, conn: Connection, p):
        return self._profiler().status()

    async def rpc_profile_run(self, conn: Connection, p):
        """start -> sleep(duration) -> stop in ONE request: the raylet's
        node fan-out holds no per-worker session state, so a connection
        loss mid-window cannot strand a running profiler (it self-stops
        at the duration)."""
        return self._annotate_profile(await self._profiler().run(p or {}))

    def _annotate_profile(self, out: dict) -> dict:
        out["client_id"] = self.client_id
        out["node_id"] = self.node_id
        ex = getattr(self, "executor", None)
        if ex is not None and getattr(ex, "actor_spec", None) is not None:
            out["actor_id"] = ex.actor_spec.actor_id.hex()
            out["actor_class"] = ex.actor_spec.name
        return out

    # -- metrics plane (metrics_core.py) -------------------------------
    async def rpc_metrics_snapshot(self, conn: Connection, p):
        from ray_tpu_torch._private import metrics_core

        return self._annotate_profile(metrics_core.process_snapshot(
            "driver" if self.is_driver else "worker"))

    # -- step observatory (steptrace.py) -------------------------------
    async def rpc_steptrace_snapshot(self, conn: Connection, p):
        """This process's step-telemetry ring (collective ops, step
        phases, compile events) — the GCS-side merge joins these across
        ranks by (group, seq) into arrival-skew attribution."""
        from ray_tpu_torch._private import steptrace

        return self._annotate_profile(steptrace.process_snapshot())

    # -- request observatory (reqtrace.py) -----------------------------
    async def rpc_reqtrace_snapshot(self, conn: Connection, p):
        """This process's serve request-trace ring (phase spans + stream
        marks) — the GCS-side merge joins these across proxy/replica
        processes by request id into per-request phase breakdowns."""
        from ray_tpu_torch._private import reqtrace

        return self._annotate_profile(reqtrace.process_snapshot())

    # -- memory observatory (memview.py) -------------------------------
    async def rpc_memview_snapshot(self, conn: Connection, p):
        """This process's object-plane view: the owned-object table
        (refcounts, pins, inlined sizes, creation callsites) plus the
        union of every oid it references — what the GCS-side merge joins
        against store ledgers for leak attribution — and the flow ring."""
        return self._annotate_profile(
            memview.process_snapshot(extra=self._memview_tables()))

    def _memview_tables(self) -> dict:
        with self._lock:
            owned = list(self._owned)[:10_000]
            refs = dict(self._local_refs)
            pins = dict(self._escape_pins)
            # inline values are bytes OR the zero-copy wire forms
            # (BufferList / memoryview) — len() is wrong or absent for
            # those; one such entry must not poison the whole snapshot
            inlined = {oid: (v[1].nbytes if hasattr(v[1], "nbytes")
                             else len(v[1]))
                       for oid, v in self._memory_store.items()}
            borrows = [oid for oid, st in self._borrow_state.items()
                       if st.get("count", 0) > 0]
            contains = list(self._contains)
        now = time.time()
        rows = []
        for oid in owned:
            info = memview.put_info(oid)
            row = {
                "object_id": oid.hex(),
                "refs": refs.get(oid, 0),
                "pins": pins.get(oid, 0),
                "inlined": oid in inlined,
            }
            if oid in inlined:
                row["size"] = inlined[oid]
            if info is not None:
                site, ts, nbytes, kind = info
                row["callsite"] = site
                row["age_s"] = round(now - ts, 3)
                row.setdefault("size", nbytes)
                row["kind"] = kind
            rows.append(row)
        referenced = {oid.hex() for oid in refs}
        referenced.update(oid.hex() for oid in borrows)
        referenced.update(oid.hex() for oid in pins)
        referenced.update(oid.hex() for oid in contains)
        referenced.update(oid.hex() for oid in owned)
        # bytes held outside the ObjectRef world (arena KV pages etc.):
        # the holder must appear referenced or live pages read as leaks
        referenced.update(o.hex() for o in memview.external_pins())
        return {"owned": rows, "referenced": sorted(referenced)}

    async def rpc_pubsub(self, conn: Connection, p):
        self._dispatch_pubsub(p["channel"], p["message"])

    async def rpc_pubsub_batch(self, conn: Connection, p):
        # batched delivery (GCS coalesces same-tick publishes per peer)
        for channel, message in p["batch"]:
            self._dispatch_pubsub(channel, message)

    def _dispatch_pubsub(self, channel, message):
        for cb in self._pubsub_handlers.get(channel, ()):
            try:
                cb(message)
            except Exception:
                logger.exception("pubsub callback failed")

    # delegated to the executor on worker processes
    async def _await_executor(self):
        while self.executor is None:
            await asyncio.sleep(0.005)
        return self.executor

    async def rpc_execute_task(self, conn: Connection, p):
        ex = await self._await_executor()
        return await self._execute_one(ex, p["spec"],
                                       direct=conn is not self.raylet)

    async def rpc_execute_task_batch(self, conn: Connection, p):
        """Batched direct push: N specs in ONE request frame, N result
        dicts in ONE response (ray parity: the reference batches its task
        plane at every layer — src/ray/rpc/, task_event_buffer.h:199).
        Specs run SEQUENTIALLY in arrival order: plain tasks serialize on
        the single-thread pool anyway, and skipping the per-task dispatch
        asyncio.Task + request/response frame pair is precisely the
        per-message event-loop cost this path exists to amortize."""
        ex = await self._await_executor()
        direct = conn is not self.raylet
        specs = p["specs"]
        if direct:
            # one provisional log offset for the whole batch (items run
            # sequentially; each FINISHED event carries its exact range)
            from ray_tpu_torch._private import logplane

            open_fields = logplane.open_event_fields()
            for spec in specs:
                self._emit_direct_task_event(spec, "RUNNING", **open_fields)

        buf: list = []
        flush_ref: list = [None]

        async def flush_results():
            # one tick: results completing in the same loop burst share a
            # task_result_batch frame; a lone (slow) result still flushes
            # on the next tick — no added latency
            await asyncio.sleep(0)
            while buf:
                chunk, buf[:] = list(buf), []
                if len(chunk) == 1:
                    await conn.notify("task_result", chunk[0])
                else:
                    await conn.notify("task_result_batch", chunk)

        async def deliver(spec: TaskSpec, result: dict):
            # Stream each result back the moment it lands (same payload
            # shape _direct_result builds on the owner) — the batch
            # RESPONSE is only a completion ack, so ray.wait sees early
            # tasks while the batch tail still runs.
            if direct:
                extra = _log_span_fields(result)
                if result.get("error") is not None:
                    self._emit_direct_task_event(
                        spec, "FAILED",
                        error=str(result.get("error"))[:200], **extra,
                    )
                else:
                    self._emit_direct_task_event(
                        spec, "FINISHED", duration=result.get("duration"),
                        **extra,
                    )
                if result.get("stored_objects"):
                    try:
                        await self.raylet.notify(
                            "register_stored",
                            {"object_ids": list(result["stored_objects"])},
                        )
                    except Exception:
                        pass
            buf.append({
                "task_id": spec.task_id,
                "results": result.get("results"),
                "error": result.get("error"),
                "error_value": result.get("error_value"),
                "app_error": result.get("app_error", False),
                "retriable": result.get("retriable", False),
                "attempt": spec.attempt,
                "exec_addr": result.get("exec_addr"),
                "borrows_kept": result.get("borrows_kept"),
                "returns_nested": result.get("returns_nested"),
                "dynamic_return_oids": result.get("dynamic_return_oids"),
            })
            t = flush_ref[0]
            if t is None or t.done():
                flush_ref[0] = self._spawn(flush_results())

        await ex.execute_task_batch(specs, deliver)
        t = flush_ref[0]
        if t is not None:
            # every result must be on the wire BEFORE the ack: the owner
            # treats acked batches as fully resulted on conn failure
            await asyncio.shield(t)
        return {"done": len(specs)}

    async def _execute_one(self, ex, spec: TaskSpec, direct: bool):
        if direct:
            # the raylet never sees direct-push tasks, so this worker owns
            # their observability record (state API / timeline parity with
            # raylet-routed tasks); log offsets ride along so the raylet's
            # tailer can attribute streamed lines by byte range
            from ray_tpu_torch._private import logplane

            self._emit_direct_task_event(spec, "RUNNING",
                                         **logplane.open_event_fields())
        result = await ex.execute_task(spec)
        if direct:
            extra = _log_span_fields(result)
            if result.get("error") is not None:
                self._emit_direct_task_event(
                    spec, "FAILED",
                    error=str(result.get("error"))[:200], **extra,
                )
            else:
                self._emit_direct_task_event(
                    spec, "FINISHED", duration=result.get("duration"),
                    **extra,
                )
            if result.get("stored_objects"):
                # stored outputs must be self-reported for location tracking
                try:
                    await self.raylet.notify(
                        "register_stored",
                        {"object_ids": list(result["stored_objects"])},
                    )
                except Exception:
                    pass
        return result

    def _emit_direct_task_event(self, spec: TaskSpec, state: str, **extra):
        ev = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "job_id": spec.job_id.hex() if spec.job_id else None,
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
            "attempt": spec.attempt,
            "state": state,
            "ts": time.time(),
            "node_id": self.node_id,
            "pid": os.getpid(),
        }
        ev.update(extra)
        self._tev_buf.append(ev)
        if not self._tev_flushing:
            self._tev_flushing = True
            self._spawn(self._flush_task_events())

    async def _flush_task_events(self):
        # debounced: a sync call loop emits RUNNING + FINISHED per call on
        # separate ticks — flush-per-tick ships ~2 notify frames per call
        # to the raylet. Buffering for the window coalesces a whole run of
        # calls into one frame; the raylet batches onward to the GCS on
        # its own timer, and exit paths (rpc_exit /
        # flush_task_events_sync) still drain immediately.
        dt = cfg.task_events_flush_interval_s
        await asyncio.sleep(dt if dt > 0 else 0)
        buf, self._tev_buf = self._tev_buf, []
        self._tev_flushing = False
        if not buf:
            return
        try:
            await self.raylet.notify("task_events", {"events": buf})
        except Exception:
            pass

    def flush_task_events_sync(self, timeout: float = 2.0):
        """Push any buffered task events to the raylet NOW, from any
        thread. Exit paths call this (worker_main's SIGTERM/atexit hooks)
        so a dying worker's last events — the most interesting ones in a
        chaos lane — are not lost with the process."""
        if not self._tev_buf:
            return
        buf, self._tev_buf = self._tev_buf, []
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self.raylet.notify("task_events", {"events": buf}),
                self.io.loop,
            )
            fut.result(timeout=timeout)
        except Exception:
            pass

    async def rpc_become_actor(self, conn: Connection, p):
        ex = await self._await_executor()
        return await ex.become_actor(p["spec"])

    async def rpc_exit(self, conn: Connection, p):
        # drain observability buffers before dying: buffered task events
        # go to the raylet (we are ON the io loop — notify directly), and
        # stdio flushes so the log tailer's final drain sees everything
        buf, self._tev_buf = self._tev_buf, []
        if buf:
            try:
                await self.raylet.notify("task_events", {"events": buf})
            except Exception:
                pass
        try:
            import sys

            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass
        logging.shutdown()
        os._exit(0)

    def on_disconnect(self, conn: Connection):
        """Client-side connection loss. A dropped GCS conn means the GCS died
        or restarted: reconnect + re-register + resubscribe (reference
        analog: the auto-reconnect GcsClient decorator, _raylet.pyx:2124 +
        pubsub resubscribe on RayletNotifyGCSRestart)."""
        if conn is self.gcs and getattr(self, "connected", False):
            return self._gcs_reconnect_loop()
        return None

    async def _gcs_reconnect_loop(self):
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # interpreter teardown: the io loop is already gone
        deadline = loop.time() + cfg.gcs_client_reconnect_timeout_s
        delay = 0.2
        while getattr(self, "connected", False):
            if loop.time() > deadline:
                logger.error("GCS unreachable for %.0fs; giving up",
                             cfg.gcs_client_reconnect_timeout_s)
                return
            try:
                # short inner dial; the outer loop paces the long outage
                conn = await connect(self.gcs_addr[0], self.gcs_addr[1],
                                     handler=self, name="gcs-conn",
                                     retries=3)
                await conn.request(
                    "register_client",
                    {"client_id": self.client_id, "job_id": self.job_id,
                     "is_driver": self.is_driver},
                )
                for channel in self._pubsub_handlers:
                    await conn.request("subscribe", {"channel": channel})
                self.gcs = conn
                logger.info("reconnected to GCS at %s:%s", *self.gcs_addr)
                return
            except Exception:
                await asyncio.sleep(delay)
                delay = min(delay * 1.5, 2.0)

    def subscribe(self, channel: str, callback):
        self._pubsub_handlers.setdefault(channel, []).append(callback)
        self.io.run(self.gcs.request("subscribe", {"channel": channel}))

    def publish(self, channel: str, message):
        self.io.run(self.gcs.request("publish", {"channel": channel, "message": message}))

    # ------------------------------------------------------------------
    # objects: slab-arena write path (slab_arena.py)
    # ------------------------------------------------------------------
    def store_put(self, oid: ObjectID, sv: serialization.SerializedValue,
                  callsite: Optional[str] = None):
        """Store a serialized value (> inline threshold) into the node
        object plane. Slab arena when this client holds or can lease a
        write slab: bump-allocate + seal + shared-index publish, with
        accounting batched to the raylet (no per-put RPC). One-file
        fallback otherwise — and on the io-loop thread when the slab is
        full (a refill RPC must never block the loop that sends it);
        the refill then runs in the background for the next put.
        ``callsite`` (the creating user line) rides the slab report into
        the store-side ledger so leak verdicts survive this owner's
        death."""
        t0 = time.perf_counter()
        if self._arena_put(oid, sv, callsite):
            mx = object_store._mx()
            mx.put_lat.record(time.perf_counter() - t0)
            mx.put_bytes.record(sv.total_data_len)
            mx.slab_puts.inc()
            return
        object_store.write_object(
            self.store_dir, oid, sv.metadata, sv.buffers, sv.total_data_len
        )
        self._register_put_fallback(oid)

    def _slab_try_put(self, oid: ObjectID,
                      sv: serialization.SerializedValue,
                      callsite: Optional[str] = None) -> bool:
        ent = self._slab_writer.try_put(
            oid.binary(), sv.metadata, sv.buffers, sv.total_data_len
        )
        if ent is None:
            return False
        if callsite:
            ent["c"] = callsite
        self._queue_slab_report(ent)
        return True

    def _arena_put(self, oid: ObjectID,
                   sv: serialization.SerializedValue,
                   callsite: Optional[str] = None) -> bool:
        if self._slab_writer is None:
            return False
        if self._slab_try_put(oid, sv, callsite):
            return True
        need = slab_arena.entry_size(len(sv.metadata), sv.total_data_len)
        if threading.current_thread() is self.io.thread:
            self._kick_slab_refill(need)
            return False
        with self._slab_lease_lock:
            if self._slab_try_put(oid, sv, callsite):
                return True  # a racing refill already won
            try:
                ok = self.io.run(self._slab_refill(need),
                                 timeout=cfg.gcs_rpc_timeout_s * 2)
            except Exception:
                ok = False
            return bool(ok) and self._slab_try_put(oid, sv, callsite)

    async def _slab_refill(self, entry_total: int) -> bool:
        """Serialized refill: at most ONE lease request in flight per
        client — a second caller (e.g. an io-thread result put racing a
        user-thread driver put) joins the in-flight refill instead of
        double-leasing; the loser's attach would otherwise silently
        detach a just-granted segment with no seal, stranding it leased
        (and charged) until disconnect."""
        t = self._slab_refill_task
        if t is None or t.done():
            t = asyncio.get_running_loop().create_task(
                self._do_slab_refill(entry_total)
            )
            self._slab_refill_task = t
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
        try:
            return bool(await asyncio.shield(t))
        except Exception:
            return False

    async def _do_slab_refill(self, entry_total: int) -> bool:
        """Retire the full slab and lease a fresh one (the one lease RPC
        amortized over every put that lands in it)."""
        w = self._slab_writer
        size = w.lease_size_for(entry_total, cfg.slab_size_bytes,
                                cfg.slab_min_lease_bytes)
        seal = w.take_seal()
        seals = ([seal] if seal else []) + self._pending_seals
        try:
            r = await self.raylet.request(
                "lease_slab", {"bytes": size, "seals": seals}
            )
        except Exception:
            # transport failure: the raylet never saw these seals — carry
            # them ALL into the next attempt so the segments get retired
            # (worst case, disconnect reclaim retires them). Never drop
            # any: a dropped seal leaves its segment leased and fully
            # charged (exempt from eviction) until client disconnect,
            # and the list grows by at most one tiny dict per failed
            # refill, so it stays bounded by refill cadence
            self._pending_seals = seals
            return False
        self._pending_seals = []
        if not r.get("ok"):
            return False
        w.attach(r["seg_id"], r["size"])
        return True

    def _kick_slab_refill(self, entry_total: int):
        t = self._slab_refill_task
        if t is not None and not t.done():
            return
        task = asyncio.get_running_loop().create_task(
            self._do_slab_refill(entry_total)
        )
        self._slab_refill_task = task
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def _queue_slab_report(self, ent: dict):
        """Batched accounting: sealed entries ride one slab_report notify
        per io-loop burst instead of one registration RPC per put."""
        with self._lock:
            self._slab_reports.append(ent)
            if self._slab_flushing:
                return
            self._slab_flushing = True
        try:
            self.io.call_soon(self._flush_slab_reports())
        except RuntimeError:  # loop stopped (shutdown): reconcile recovers
            with self._lock:
                self._slab_flushing = False

    async def _flush_slab_reports(self):
        while True:
            await asyncio.sleep(0)  # coalesce the current put burst
            with self._lock:
                batch, self._slab_reports = self._slab_reports, []
                if not batch:
                    self._slab_flushing = False
                    return
            try:
                await self.raylet.notify("slab_report", {"objects": batch})
            except Exception:
                # transient raylet unreachability must not strand the
                # batch (the seal/death reconcile would cover it only at
                # the NEXT refill or disconnect — an idle writer's
                # objects would stay invisible to the directory):
                # requeue bounded and let the next put retrigger a flush
                with self._lock:
                    self._slab_reports = (batch + self._slab_reports)[:10_000]
                    self._slab_flushing = False
                return

    def _register_put_fallback(self, oid: ObjectID):
        """Legacy one-file accounting (register_external + location)."""
        payload = {"object_id": oid.binary()}
        if threading.current_thread() is self.io.thread:
            async def _reg():
                # retried: an unregistered fallback .obj is invisible to
                # the raylet's accounting/eviction — a dropped frame here
                # would leak the file until session teardown
                for delay in (0.0, 0.5, 2.0):
                    if delay:
                        await asyncio.sleep(delay)
                    try:
                        await self.raylet.request("register_put", payload)
                        return
                    except Exception:
                        continue
            t = asyncio.get_running_loop().create_task(_reg())
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
        else:
            self.io.run(self.raylet.request("register_put", payload))

    # ------------------------------------------------------------------
    # objects: put/get/wait
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        sv = serialization.serialize(value)
        return self._put_serialized(sv)

    def _put_serialized(self, sv: serialization.SerializedValue) -> ObjectRef:
        with self._lock:
            self._put_index += 1
            idx = self._put_index
        oid = ObjectID.for_put(self.task_id, idx)
        # memory observatory: stamp the creating user callsite so a
        # leaked put groups by the line that made it (flag-gated; a
        # bounded frame walk, ~1µs against a >=100µs store put). The
        # tag is computed ONCE and also handed to store_put below, which
        # persists it into the store-side ledger — a dead owner's leak
        # verdict then still names the line that made the object
        callsite = memview.callsite_tag() if memview.is_enabled() else None
        memview.record_put(
            oid.binary(), sv.total_data_len,
            "inline" if sv.total_data_len
            <= cfg.max_direct_call_object_size else "put",
            callsite=callsite)
        # Refs nested in the stored value are kept alive by this container
        # until it is freed (ray: reference_count.h AddNestedObjectIds). The
        # nested refs are live python ObjectRefs here, so their borrows are
        # already registered with their owners; the pin extends the lifecycle.
        tokens = [self.pin_object(o, w) for o, w in sv.nested_refs]
        if sv.total_data_len <= cfg.max_direct_call_object_size:
            # to_bytes, not to_wire: put() snapshots — the stored value must
            # not alias the caller's (possibly mutated-later) buffers
            with self._lock:
                self._memory_store[oid.binary()] = (sv.metadata, sv.to_bytes())
                self._owned.add(oid.binary())
                if tokens:
                    self._contains[oid.binary()] = tokens
        else:
            # slab-arena write: bump+seal+index, accounting batched — no
            # blocking per-put registration round trip
            self.store_put(oid, sv, callsite=callsite)
            self._record_owned_location(oid.binary(), self.node_id)
            with self._lock:
                self._owned.add(oid.binary())
                if tokens:
                    self._contains[oid.binary()] = tokens
        ref = ObjectRef(oid, self.addr)
        self.add_local_ref(ref)
        return ref

    def future_for(self, ref: ObjectRef) -> concurrent.futures.Future:
        with self._lock:
            fut = self._futures.get(ref.binary())
            if fut is not None:
                return fut
            if ref.binary() in self._memory_store:
                fut = concurrent.futures.Future()
                fut.set_result(("inline",) + self._memory_store[ref.binary()])
                self._futures[ref.binary()] = fut
                return fut
            fut = concurrent.futures.Future()
            self._futures[ref.binary()] = fut
        if object_store.object_exists(self.store_dir, ref.id()):
            if not fut.done():
                fut.set_result(("plasma", None, None))
            return fut
        if ref.binary() in self._owned or (
            ref.owner is not None and tuple(ref.owner) == self.addr
        ):
            # Owned but not local (e.g. a dynamic return stored on the
            # executing node, or a lost copy): pull, else reconstruct.
            self.io.call_soon(self._resolve_owned_missing(ref, fut))
            return fut
        # Borrowed ref: resolve in background (plasma pull or owner fetch).
        self.io.call_soon(self._resolve_borrowed(ref, fut))
        return fut

    async def _resolve_owned_missing(self, ref: ObjectRef,
                                     fut: concurrent.futures.Future):
        oid = ref.binary()
        try:
            ok = await self.raylet.request(
                "pull_object",
                {"object_id": oid, "timeout": cfg.object_pull_timeout_s,
                 "owner": self.addr},
            )
            if ok.get("ok") and object_store.object_exists(
                self.store_dir, ref.id()
            ):
                if not fut.done():
                    fut.set_result(("plasma", None, None))
                return
        except Exception:
            pass
        try:
            rfut = await self._reconstruct_owned(oid)
        except Exception as e:
            if not fut.done():
                fut.set_exception(e)
            return
        if rfut is fut:
            return  # resolution arrives via the task-result path

        def _copy(rf):
            if fut.done():
                return
            try:
                fut.set_result(rf.result())
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        rfut.add_done_callback(_copy)

    async def _resolve_borrowed(self, ref: ObjectRef, fut: concurrent.futures.Future):
        oid = ref.binary()
        deadline = time.monotonic() + cfg.object_pull_timeout_s
        while time.monotonic() < deadline and not fut.done():
            if object_store.object_exists(self.store_dir, ref.id()):
                if not fut.done():
                    fut.set_result(("plasma", None, None))
                return
            owner = ref.owner
            if owner is not None and tuple(owner) != self.addr:
                try:
                    r = await self.raylet.request(
                        "fetch_owned_routed", {"owner": tuple(owner), "object_id": oid},
                        timeout=10.0,
                    )
                except Exception:
                    r = {}
                if r.get("inline"):
                    meta, data = r["inline"]
                    self._resolve_inline(oid, meta, data)
                    return
                if r.get("plasma"):
                    ok = (await self.raylet.request(
                        "pull_object",
                        {"object_id": oid, "owner": tuple(owner)}))["ok"]
                    if ok and not fut.done():
                        fut.set_result(("plasma", None, None))
                        return
                if r.get("pending"):
                    # Producer still running: keep waiting past the deadline.
                    deadline = time.monotonic() + cfg.object_pull_timeout_s
            else:
                try:
                    ok = (await self.raylet.request(
                        "pull_object",
                        {"object_id": oid,
                         "owner": tuple(owner) if owner else None}))["ok"]
                    if ok and not fut.done():
                        fut.set_result(("plasma", None, None))
                        return
                except Exception:
                    pass
            await asyncio.sleep(0.05)
        if not fut.done():
            fut.set_exception(GetTimeoutError(f"could not resolve {ref}"))

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        futs = [self.future_for(r) for r in refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        values = []
        for r, f in zip(refs, futs):
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                if remaining is None and cfg.get_stall_dump_s > 0:
                    kind, meta, data = self._wait_with_stall_dump(r, f)
                else:
                    kind, meta, data = f.result(remaining)
            except concurrent.futures.TimeoutError:
                raise GetTimeoutError(
                    f"Get timed out: {r} not ready after {timeout}s"
                ) from None
            values.append(self._materialize(r, kind, meta, data))
        return values[0] if single else values

    def _wait_with_stall_dump(self, ref: ObjectRef, f):
        """Untimed get(): wait in stall-sized slices so a result that never
        arrives produces a transport-state diagnostic instead of a silent
        hang (the WARNING is the user-visible symptom; the dump file is for
        postmortems)."""
        stalls = 0
        while True:
            try:
                return f.result(cfg.get_stall_dump_s)
            except concurrent.futures.TimeoutError:
                stalls += 1
                dump = self.debug_transport_state()
                msg = (f"get() blocked {stalls * cfg.get_stall_dump_s:.0f}s "
                       f"on {ref}; transport state: {dump}")
                logger.warning(msg)
                path = os.environ.get("RAY_TPU_TORCH_STALL_DUMP_FILE")
                if path:
                    try:
                        with open(path, "a") as fh:
                            fh.write(msg + "\n")
                            if stalls == 3:
                                # one-shot deep dump: the io loop's pending
                                # task stacks localize a wedged coroutine
                                # that the transport counters can't
                                import io as _io

                                buf = _io.StringIO()
                                try:
                                    from ray_tpu_torch._private.profiling import \
                                        all_asyncio_tasks

                                    for t in all_asyncio_tasks():
                                        if not t.done():
                                            buf.write(f"--- {t!r} ---\n")
                                            t.print_stack(file=buf)
                                except Exception as de:
                                    buf.write(f"(dump failed: {de!r})\n")
                                fh.write(buf.getvalue())
                    except OSError:
                        pass

    def debug_transport_state(self) -> dict:
        """Snapshot of the direct-push machinery, readable without the io
        loop (diagnosis only). Every container is list()-snapshotted before
        iteration and the whole read is exception-guarded: the io thread
        mutates these dicts concurrently, and a diagnostic must never turn
        a healthy (if slow) get() into a RuntimeError."""
        try:
            state: dict = {
                "direct_q": {
                    repr(k): len(q) for k, q in list(self._direct_q.items())
                },
                "pumps": {
                    repr(k): ("done" if t.done() else "live")
                    for k, t in list(self._direct_pumps.items())
                },
                "bg_tasks": len(self._bg_tasks),
                "events_set": {
                    repr(k): ev.is_set()
                    for k, ev in list(self._direct_events.items())
                },
                "direct_conns": {
                    f"{h}:{p}": {
                        "closed": c.closed, "pending": len(c._pending),
                    }
                    for (h, p), c in list(self._direct_conns.items())
                },
                "raylet_pending": len(self.raylet._pending)
                if self.raylet is not None else None,
                "specs_inflight": {
                    tid.hex()[:8]: (s.name, self._submit_stage.get(tid, "?"))
                    for tid, s in list(self._specs_inflight.items())[:16]
                },
                "actor_direct": {
                    aid.hex()[:8]: {
                        "q": len(st["q"]), "running": st["running"],
                        "inflight": st.get("inflight"),
                        "fallback": st.get("fallback", False),
                    }
                    for aid, st in list(self._actor_direct.items())
                },
            }
        except Exception as e:  # torn read mid-mutation: partial is fine
            state = {"error": f"snapshot failed: {e!r}"}
        return state

    def _materialize(self, ref: ObjectRef, kind, meta, data):
        if kind == "inline":
            with _deser_container(ref.binary()):
                return serialization.deserialize(meta, data)
        oid = ref.id()
        buf = object_store.read_object(self.store_dir, oid)
        if buf is None:
            ok = self.io.run(self.raylet.request(
                "pull_object",
                {"object_id": ref.binary(), "owner": ref.owner}))
            if ok.get("ok"):
                buf = object_store.read_object(self.store_dir, oid)
        if buf is None:
            # Plasma copy gone cluster-wide (or the local file was deleted
            # behind a stale store record): invalidate, re-pull, and fall
            # back to lineage reconstruction (object_recovery_manager.h:44).
            buf, inline = self._recover_object(ref)
            if buf is None:
                with _deser_container(ref.binary()):
                    return serialization.deserialize(*inline)
        with self._lock:
            self._pinned_buffers.pop(ref.binary(), None)
            self._pinned_buffers[ref.binary()] = buf
        with _deser_container(ref.binary()):
            return serialization.deserialize(buf.metadata, buf.data)

    def _recover_object(self, ref: ObjectRef):
        """Returns (buffer, None) or (None, (meta, data)) for a value that
        came back inline (e.g. the reconstructed task errored)."""
        oid = ref.id()
        try:
            self.io.run(self.raylet.request(
                "report_lost_object", {"object_id": ref.binary()}))
            # Short probe: if no other node holds a copy, fail fast into
            # reconstruction instead of waiting out the full pull timeout.
            ok = self.io.run(self.raylet.request(
                "pull_object", {"object_id": ref.binary(), "timeout": 2.0}))
            if ok.get("ok"):
                buf = object_store.read_object(self.store_dir, oid)
                if buf is not None:
                    return buf, None
        except Exception:
            pass
        owner = ref.owner
        if owner is not None and tuple(owner) != self.addr:
            # Borrowed: ask the owner to reconstruct, then pull again.
            r = self.io.run(self._owner_call(
                owner, "reconstruct_object", {"object_id": ref.binary()},
                timeout=cfg.object_pull_timeout_s * 2,
            ))
            if r.get("ok"):
                ok = self.io.run(self.raylet.request(
                    "pull_object", {"object_id": ref.binary()}))
                if ok.get("ok"):
                    buf = object_store.read_object(self.store_dir, oid)
                    if buf is not None:
                        return buf, None
            raise GetTimeoutError(f"object {ref} lost; owner could not recover it")
        fut = self.io.run(self._reconstruct_owned(ref.binary()))
        kind, meta, data = fut.result(cfg.object_pull_timeout_s * 2)
        if kind == "inline":
            return None, (meta, data)
        buf = object_store.read_object(self.store_dir, oid)
        if buf is None:
            ok = self.io.run(self.raylet.request(
                "pull_object", {"object_id": ref.binary()}))
            if ok.get("ok"):
                buf = object_store.read_object(self.store_dir, oid)
        if buf is None:
            raise GetTimeoutError(f"object {ref} unavailable after reconstruction")
        return buf, None

    def wait(self, refs: List[ObjectRef], num_returns=1, timeout=None,
             fetch_local=True):
        if not fetch_local:
            return self._wait_no_fetch(refs, num_returns, timeout)
        futs = {self.future_for(r): r for r in refs}
        deadline = None if timeout is None else time.monotonic() + timeout
        done: set = set()
        while len(done) < num_returns:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining < 0:
                break
            d, _ = concurrent.futures.wait(
                [f for f in futs if f not in done], timeout=remaining,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            if not d:
                break
            done |= d
        ready_set = {futs[f] for f in done}
        ordered_ready = [r for r in refs if r in ready_set][:num_returns]
        picked = set(ordered_ready)
        not_ready = [r for r in refs if r not in picked]
        return ordered_ready, not_ready

    def _wait_no_fetch(self, refs, num_returns, timeout):
        """wait(fetch_local=False): readiness without pulling the values to
        this node (ray: wait's fetch_local contract — the reference only
        checks object availability, it does not start a transfer)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: set = set()
        while True:
            for r in refs:
                if r in ready:
                    continue
                if self._is_available_somewhere(r):
                    ready.add(r)
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(cfg.wait_poll_interval_s)
        ordered_ready = [r for r in refs if r in ready][:num_returns]
        picked = set(ordered_ready)
        return ordered_ready, [r for r in refs if r not in picked]

    def _is_available_somewhere(self, ref: ObjectRef) -> bool:
        oid = ref.binary()
        with self._lock:
            if oid in self._memory_store:
                return True
            fut = self._futures.get(oid)
        if fut is not None and fut.done() and fut.exception() is None:
            return True
        if object_store.object_exists(self.store_dir, ref.id()):
            return True
        owner = ref.owner
        if owner is not None and tuple(owner) != self.addr:
            try:
                r = self.io.run(self.raylet.request(
                    "fetch_owned_routed",
                    {"owner": tuple(owner), "object_id": oid}, timeout=5.0,
                ))
            except Exception:
                return False
            return bool(r.get("inline") or r.get("plasma"))
        return False

    # ------------------------------------------------------------------
    # reference counting + borrower protocol (ray: reference_count.h:61)
    #
    # Owner side: an owned object stays alive while it has local python
    # refs, escape pins (serialized copies in flight), or registered remote
    # borrowers. Each registered borrower is long-polled (wait_ref_removed);
    # its reply arrives when the borrower's last reference drops and carries
    # any refs it borrowed *through* the object for handoff.
    #
    # Borrower side: one state per oid counting python refs + serialize-out
    # holds + containment holds; when it hits zero, pending owner polls
    # resolve. Every registration handoff is acknowledged before the pin
    # protecting the object during the handoff is released, so the object is
    # pinned somewhere at every instant.
    # ------------------------------------------------------------------
    def add_local_ref(self, ref: ObjectRef):
        with self._lock:
            self._local_refs[ref.binary()] = self._local_refs.get(ref.binary(), 0) + 1
        ref._counted = True  # __del__ releases this count

    def defer_ref_release(self, ref_binary: bytes):
        """Called from ObjectRef.__del__ (any thread, any GC point):
        deque.append is atomic and lock-free, so this is safe even when the
        interpreter is mid-way through a locked core-worker section. The
        release-drain thread applies the actual decrement."""
        self._deferred_releases.append(ref_binary)
        self._release_event.set()

    def _release_drain_loop(self):
        while getattr(self, "connected", True):
            try:
                oid = self._deferred_releases.popleft()
            except IndexError:
                self._release_event.clear()
                if self._deferred_releases:  # raced a producer's append
                    continue
                self._release_event.wait(timeout=cfg.deferred_release_wait_s)
                continue
            try:
                self.remove_local_ref(oid)
            except Exception:
                logger.exception("deferred ref release failed")

    def remove_local_ref(self, ref_binary: bytes):
        with self._lock:
            if ref_binary in self._borrow_state and ref_binary not in self._owned:
                borrowed = True
            else:
                borrowed = False
                n = self._local_refs.get(ref_binary, 0) - 1
                if n <= 0:
                    self._local_refs.pop(ref_binary, None)
                else:
                    self._local_refs[ref_binary] = n
                    return
        if borrowed:
            self._borrow_release(ref_binary)
        else:
            self._maybe_free(ref_binary)

    def register_borrowed_ref(self, ref: ObjectRef):
        """Called for every deserialized ObjectRef. Owned refs round-tripping
        home count as local refs; foreign refs start/extend a borrow."""
        oid = ref.binary()
        with self._lock:
            if oid in self._owned:
                self._local_refs[oid] = self._local_refs.get(oid, 0) + 1
                ref._counted = True
                return
            st = self._borrow_state.get(oid)
            if st is None:
                st = {"count": 0, "owner": None, "waiters": []}
                self._borrow_state[oid] = st
            st["count"] += 1
            if st["owner"] is None and ref.owner is not None:
                st["owner"] = tuple(ref.owner)
            ref._counted = True
            # Provenance tracking matters only when the container itself is a
            # borrowed object with live state (its owner will poll us and the
            # reply hands these children off). Owned containers pin children
            # via _contains, and executor args report children directly in
            # borrows_kept — recording those here would leak entries forever.
            container = getattr(_DESER_CTX, "container", None)
            if (container is not None and container != oid
                    and container in self._borrow_state):
                self._borrowed_via.setdefault(container, set()).add(oid)

    def pin_object(self, oid: bytes, owner) -> tuple:
        """Take one keep-alive pin: escape pin if owned, borrow hold if not.
        Returns a token for unpin_object."""
        with self._lock:
            if oid in self._owned:
                self._escape_pins[oid] = self._escape_pins.get(oid, 0) + 1
                return ("o", oid)
            st = self._borrow_state.get(oid)
            if st is None:
                st = {"count": 0, "owner": None, "waiters": []}
                self._borrow_state[oid] = st
            st["count"] += 1
            if st["owner"] is None and owner is not None:
                st["owner"] = tuple(owner)
            return ("b", oid)

    def unpin_object(self, token: tuple):
        kind, oid = token
        if kind == "o":
            with self._lock:
                n = self._escape_pins.get(oid, 0) - 1
                if n <= 0:
                    self._escape_pins.pop(oid, None)
                else:
                    self._escape_pins[oid] = n
                    return
            self._maybe_free(oid)
        else:
            self._borrow_release(oid)

    def _borrow_release(self, oid: bytes):
        with self._lock:
            st = self._borrow_state.get(oid)
            if st is None:
                return
            st["count"] -= 1
            if st["count"] > 0:
                return
            self._borrow_state.pop(oid, None)
            waiters = st["waiters"]
            # Children first borrowed while deserializing this object that
            # are still live: hand them off to the container's owner.
            inherited = []
            for child in self._borrowed_via.pop(oid, ()):
                cst = self._borrow_state.get(child)
                if cst is not None and cst.get("owner"):
                    inherited.append((child, cst["owner"]))
        if waiters:
            def _resolve():
                for f in waiters:
                    if not f.done():
                        f.set_result(inherited)
            self.io.loop.call_soon_threadsafe(_resolve)

    def borrowed_refs_held(self):
        """Live borrows of this process: [(oid, owner)] — reported to task
        owners at completion (ray: PushTaskReply.borrowed_refs)."""
        with self._lock:
            return [
                (oid, st["owner"])
                for oid, st in self._borrow_state.items()
                if st["count"] > 0 and st.get("owner")
            ]

    # -- owner-side borrower registry ----------------------------------
    def _register_borrower(self, oid: bytes, borrower: tuple):
        if tuple(borrower) == self.addr:
            return
        with self._lock:
            if oid not in self._owned:
                return
            s = self._borrowers.setdefault(oid, set())
            if tuple(borrower) in s:
                return
            s.add(tuple(borrower))
        self.io.call_soon(self._poll_borrower(oid, tuple(borrower)))

    async def _poll_borrower(self, oid: bytes, borrower: tuple):
        """Long-poll one borrower until it drops the ref (WaitForRefRemoved).
        A dead borrower is pruned after a few failures."""
        failures = 0
        while True:
            with self._lock:
                if oid not in self._owned or borrower not in self._borrowers.get(oid, ()):
                    return
            r = await self._owner_call(
                borrower, "wait_ref_removed", {"object_id": oid},
                timeout=cfg.borrower_poll_timeout_s,
            )
            if r.get("timeout"):
                failures = 0
                continue
            if r.get("removed"):
                for child, child_owner in r.get("inherited", ()):
                    await self._register_borrow_for(child, child_owner, borrower)
                break
            failures += 1
            if failures >= cfg.borrower_poll_retries:
                logger.warning(
                    "borrower %s of %s unreachable; dropping its borrow",
                    borrower, oid.hex()[:16],
                )
                break
            # Exponential backoff: a brief raylet/peer outage must not free
            # an object a live borrower still uses (transient errors and a
            # dead borrower look the same through the routing layer).
            await asyncio.sleep(min(30.0, 2.0 ** failures))
        with self._lock:
            s = self._borrowers.get(oid)
            if s is not None:
                s.discard(borrower)
                if not s:
                    self._borrowers.pop(oid, None)
        self._maybe_free(oid)

    async def rpc_borrow_add(self, conn: Connection, p):
        self._register_borrower(p["object_id"], tuple(p["borrower"]))
        return {"ok": True}

    async def rpc_wait_ref_removed(self, conn: Connection, p):
        oid = p["object_id"]
        with self._lock:
            st = self._borrow_state.get(oid)
            if st is None or st["count"] <= 0:
                inherited = []
                for child in self._borrowed_via.pop(oid, ()):
                    cst = self._borrow_state.get(child)
                    if cst is not None and cst.get("owner"):
                        inherited.append((child, cst["owner"]))
                return {"removed": True, "inherited": inherited}
            fut = asyncio.get_running_loop().create_future()
            st["waiters"].append(fut)
        try:
            inherited = await asyncio.wait_for(
                fut, cfg.borrower_poll_timeout_s * 0.9
            )
            return {"removed": True, "inherited": inherited}
        except asyncio.TimeoutError:
            return {"removed": False}

    async def rpc_release_return_pins(self, conn: Connection, p):
        """Caller has registered the borrows for refs nested in our returned
        value: drop the pins we held across the handoff."""
        with self._lock:
            pins = self._return_pins.pop(p["task_id"], None)
        for token in pins or ():
            self.unpin_object(token)
        return {}

    async def rpc_reconstruct_object(self, conn: Connection, p):
        """A borrower lost the plasma copy of an object we own: re-execute
        the producing task (ray: object_recovery_manager.h:44)."""
        oid = p["object_id"]
        try:
            fut = await self._reconstruct_owned(oid)
            await asyncio.wait_for(
                asyncio.wrap_future(fut), cfg.object_pull_timeout_s * 2
            )
            return {"ok": True}
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # -- lineage reconstruction ----------------------------------------
    async def _reconstruct_owned(self, oid: bytes) -> concurrent.futures.Future:
        """Resubmit the producing task for a lost owned object. Returns the
        (new) result future; dedupes concurrent reconstructions."""
        with self._lock:
            spec = self._lineage.get(oid)
            if spec is None:
                raise GetTimeoutError(
                    f"object {oid.hex()[:16]} lost and has no lineage "
                    "(puts are not reconstructable)"
                )
            if spec.task_id in self._specs_inflight:
                # Reconstruction (or the original run) already in flight.
                fut = self._futures.get(oid)
                if fut is None:
                    fut = concurrent.futures.Future()
                    self._futures[oid] = fut
                return fut
            if spec.reconstructions >= cfg.max_object_reconstructions:
                raise GetTimeoutError(
                    f"object {oid.hex()[:16]} lost too many times "
                    f"({spec.reconstructions})"
                )
            spec.reconstructions += 1
            spec.attempt += 1
            tid = TaskID(spec.task_id)
            for i in range(1 if spec.num_returns == -1 else spec.num_returns):
                roid = ObjectID.from_index(tid, i + 1).binary()
                self._futures[roid] = concurrent.futures.Future()
            # dynamic item oids (return index >= 2) are not enumerated by
            # num_returns: register the requested one explicitly, replacing
            # a stale done future (its "plasma" result predates the loss)
            if oid not in self._futures or self._futures[oid].done():
                self._futures[oid] = concurrent.futures.Future()
            self._specs_inflight[spec.task_id] = spec
            fut = self._futures[oid]
        logger.info("reconstructing %s via task %s (attempt %d)",
                    oid.hex()[:16], spec.name, spec.attempt)
        try:
            await self.raylet.request(
                "report_lost_object", {"object_id": oid})
        except Exception:
            pass
        # Recursively make sure the task's own args are obtainable.
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a[0] == "r":
                try:
                    await self._ensure_object_available(a[1], a[2] if len(a) > 2 else None)
                except Exception as e:
                    logger.warning("arg recovery for reconstruction failed: %s", e)
        await call_with_retries(
            lambda: self.raylet, "submit_task", {"spec": spec},
            idem=("submit", spec.task_id, spec.attempt),
        )
        return fut

    async def _ensure_object_available(self, oid: bytes, owner=None):
        """Make sure some live node holds oid, reconstructing if needed."""
        locs = []
        try:
            locs = await self.gcs.request(
                "get_object_locations", {"object_id": oid})
        except Exception:
            pass
        if locs:
            return
        if object_store.object_exists(self.store_dir, ObjectID(oid)):
            return
        with self._lock:
            owned = oid in self._owned
        if owned:
            fut = await self._reconstruct_owned(oid)
            await asyncio.wait_for(
                asyncio.wrap_future(fut), cfg.object_pull_timeout_s * 2
            )
        elif owner is not None:
            r = await self._owner_call(
                owner, "reconstruct_object", {"object_id": oid},
                timeout=cfg.object_pull_timeout_s * 2,
            )
            if not r.get("ok"):
                raise GetTimeoutError(
                    f"owner could not recover {oid.hex()[:16]}: {r.get('error')}"
                )

    def _maybe_free(self, oid: bytes):
        with self._lock:
            if oid not in self._owned:
                return
            if self._local_refs.get(oid) or self._escape_pins.get(oid) \
                    or self._borrowers.get(oid):
                return
            tid = ObjectID(oid).task_id().binary()
            if tid in self._specs_inflight:
                return  # producing task still running
            self._owned.discard(oid)
            self._owned_locations.pop(oid, None)
            self._memory_store.pop(oid, None)
            self._futures.pop(oid, None)
            # Lineage is deliberately NOT popped here: a downstream object's
            # reconstruction may need to re-execute this object's producing
            # task too (multi-hop recovery). The FIFO cap in _record_lineage
            # bounds the memory (ray: lineage pinned while reachable).
            contains = self._contains.pop(oid, None)
            buf = self._pinned_buffers.pop(oid, None)
        if buf is not None:
            try:
                buf.release()
            except Exception:
                pass
        for token in contains or ():
            self.unpin_object(token)
        memview.forget_put(oid)  # a freed object is no leak candidate
        # tick-batched frees: ref churn (a put-per-iteration loop) would
        # otherwise fire one RPC + io-loop wakeup per dropped object
        self._free_buf.append(oid)
        if not self._free_flushing:
            self._free_flushing = True
            try:
                self.io.call_soon(self._flush_frees())
            except Exception:
                self._free_flushing = False

    async def _flush_frees(self):
        # debounced: a sequential get loop drops one ref per call, and a
        # flush-per-tick turns that into a free_objects chain (driver ->
        # raylet -> GCS) per call competing with the calls themselves for
        # CPU; the window batches them into one frame. Frees are refcount
        # GC — nothing awaits them — so the only cost is pages staying
        # pinned for the window.
        dt = cfg.free_flush_interval_s
        await asyncio.sleep(dt if dt > 0 else 0)
        buf, self._free_buf = self._free_buf, []
        self._free_flushing = False
        if not buf:
            return
        try:
            await self.raylet.notify("free_objects", {"object_ids": buf})
        except Exception:
            pass

    # ------------------------------------------------------------------
    def node_stats(self):
        return self.io.run(self.raylet.request("node_stats", {}))

    def get_nodes(self):
        return self.io.run(self.gcs.request("get_nodes", {}))

    def disconnect(self):
        self.connected = False
        try:
            for conn in list(self._direct_conns.values()):
                self.io.run(conn.close(), timeout=2)
            for st in list(self._actor_direct.values()):
                if st.get("conn") is not None:
                    self.io.run(st["conn"].close(), timeout=2)
            self.io.run(self.raylet.close(), timeout=2)
            self.io.run(self.gcs.close(), timeout=2)
        except Exception:
            pass
        # release this session's arena state (writer slab mapping, cached
        # reader mappings + flock fds, index mmap) — a long-lived process
        # cycling init()/shutdown() must not pin dead sessions' shm pages
        try:
            if self._slab_writer is not None:
                self._slab_writer.close()
            slab_arena.drop_view(self.store_dir)
        except Exception:
            pass
        self.io.stop()


class Worker:
    """Process-global holder (analog of ray: python/ray/_private/worker.py:410)."""

    def __init__(self):
        self.core_worker: Optional[CoreWorker] = None
        self.node = None  # head Node if we started one
        self.mode: Optional[str] = None

    @property
    def connected(self):
        return self.core_worker is not None and self.core_worker.connected

    def check_connected(self):
        if not self.connected:
            raise RuntimeError("ray_tpu_torch.init() must be called before using the API")


global_worker = Worker()
