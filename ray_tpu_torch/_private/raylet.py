"""Raylet: per-node agent — scheduling, worker pool, object management.

Analog of the reference's raylet (ray: src/ray/raylet/node_manager.h:119):

- ClusterTaskManager (ray: scheduling/cluster_task_manager.h:33-42): pick a
  feasible node from the GCS-synced cluster view (hybrid pack/spread policy),
  spill to a peer raylet or queue locally.
- LocalTaskManager (ray: local_task_manager.h:58): dependency-gated dispatch —
  pull plasma args local, acquire resources, bind an idle worker, push task.
- WorkerPool (ray: worker_pool.h:156): spawn/cache Python worker processes
  keyed by job; dedicated workers for actors.
- Object manager (ray: src/ray/object_manager/object_manager.h:117): chunked
  peer-to-peer object transfer into the node-local shm store, pull admission.
- Placement-group bundle resources via 2-phase prepare/commit
  (ray: placement_group_resource_manager.h).

Device delta vs the reference: node resources advertise CUDA cards as
"GPU" (ray_tpu advertises "TPU" chips); like ray_tpu there is no
CUDA_VISIBLE_DEVICES narrowing by lease — a worker sees every local card.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
import os
import pickle
import subprocess
import sys
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import object_store
from ray_tpu_torch._private.common import (
    NodeInfo,
    TaskSpec,
    pick_node,
    res_add,
    res_fits,
    res_sub,
)
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private import faultsim, logplane
from ray_tpu_torch._private.rpcio import (Connection, Finalized, RpcError,
                                    RpcServer, call_with_retries, connect,
                                    spawn)

logger = logging.getLogger(__name__)


def runtime_env_hash(runtime_env: Optional[dict]) -> str:
    """Stable hash of a runtime env; workers are pooled per hash
    (ray: worker_pool.h keyed by runtime-env hash)."""
    if not runtime_env:
        return ""
    import json

    return json.dumps(runtime_env, sort_keys=True)


class _Worker:
    def __init__(self, proc: subprocess.Popen, job_id: Optional[bytes],
                 env_hash: str = "", log_path: Optional[str] = None,
                 cidfile: Optional[str] = None, engine: Optional[str] = None,
                 spawn_id: Optional[str] = None):
        self.proc = proc
        self.job_id = job_id
        self.env_hash = env_hash
        # spawn key the worker echoes back in register_client: under a
        # real container engine the in-container worker's os.getpid()
        # differs from proc.pid (the engine CLIENT's pid), so pid-keyed
        # matching can never resolve — the spawn id is the identity
        self.spawn_id = spawn_id
        # container bookkeeping: SIGKILL on the engine client never
        # reaches the container — kill paths must also `engine rm -f`
        self.cidfile = cidfile
        self.engine = engine
        self.conn: Optional[Connection] = None
        self.client_id: Optional[str] = None
        self.busy_with: Optional[bytes] = None  # task_id
        self.actor_id: Optional[bytes] = None
        # direct task push (ray: direct_task_transport.cc worker leases):
        # the worker's own RPC port drivers push to, and the lease id
        # while a driver holds this worker
        self.direct_port: Optional[int] = None
        self.lease_id: Optional[str] = None
        self.registered = asyncio.get_running_loop().create_future()
        self.started_at = time.monotonic()
        self.oom_killed = False
        # log streaming (ray: _private/log_monitor.py): the raylet tails
        # this file and publishes new lines to drivers
        self.log_path = log_path
        self.log_offset = 0
        self.log_partial = b""
        # byte-range -> task-name attribution for streamed lines, fed
        # from the task events flowing through this raylet (logplane.py)
        self.log_spans = logplane.SpanTable(cfg.log_span_history)
        # fallback prefix name for lines outside any task span (set to
        # the actor class once this worker becomes an actor)
        self.log_name: Optional[str] = None
        # unattributed lines held for ONE tail tick so a racing RUNNING
        # event can land and win attribution over the fallback prefix
        self.log_held: list = []  # [(absolute_offset, raw_line), ...]

    def kill_process(self):
        """Kill the worker AND its container, if any: a plain kill only
        reaches the container-engine client process (SIGKILL is never
        proxied inside), which would leak a live container holding its
        ports and store mappings."""
        try:
            self.proc.kill()
        except OSError:
            pass
        if self.cidfile and self.engine:
            try:
                with open(self.cidfile) as f:
                    cid = f.read().strip()
                if cid:
                    subprocess.Popen(
                        [self.engine, "rm", "-f", cid],
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL,
                    )
            except OSError:
                pass


def _tail_worker_log(w: _Worker, final: bool = False):
    """Read newly appended bytes of one worker's log and attribute each
    line to its task by byte offset (w.log_spans). Returns
    ``(entry, stats)`` — entry is a batch record ``{pid, job_id, segs}``
    with ``segs`` = consecutive-line groups ``[task_name_or_None,
    [lines...]]``, or None when nothing new. ``final`` drains to EOF and
    flushes the partial line (worker exiting — its last write IS the
    traceback). Chunk bytes are split into fresh ``bytes`` objects before
    anything retains them: relay paths must never hold exported
    memoryviews of reused buffers (see the documented GC tp_clear
    hazard)."""
    stats = {"lines": 0, "bytes": 0, "truncated": 0}
    if not w.log_path:
        return None, stats
    lines_out = []  # (absolute_start_offset, raw_line)
    pos = w.log_offset - len(w.log_partial)
    budget = cfg.log_publish_max_bytes  # per-tick cap: keeps a chatty
    # worker from monopolizing the tick without letting it lag unboundedly
    try:
        with open(w.log_path, "rb") as f:
            f.seek(w.log_offset)
            while True:
                chunk = f.read(65536)
                if not chunk:
                    break
                w.log_offset += len(chunk)
                data = w.log_partial + chunk
                *lines, w.log_partial = data.split(b"\n")
                for ln in lines:
                    lines_out.append((pos, ln))
                    pos += len(ln) + 1
                budget -= len(chunk)
                if not final and budget <= 0:
                    break  # bounded per tick; the next tick continues
    except OSError:
        return None, stats
    if final and w.log_partial:
        lines_out.append((pos, w.log_partial))
        w.log_partial = b""
    # One-tick hold for unattributed lines (closes a cosmetic race that
    # debounced task events widened): a line printed before its task's
    # RUNNING/FINISHED event reached this raylet used to publish with
    # the fallback prefix immediately. Worker-side task events are now
    # debounced (task_events_flush_interval_s, 20ms default), so the
    # window where log bytes exist but their span does not is real for
    # EVERY worker, not just actors — fresh lines that resolve to no
    # span are carried to the next tick (the tail interval, 0.3s,
    # comfortably exceeds the debounce window, so the span has landed
    # by the second look). Order-preserving (everything after the first
    # held line holds with it); carried lines always publish on their
    # second look (resolved, or the fallback for genuinely task-less
    # output), so the delay is bounded at one log_tail_interval_s.
    held = getattr(w, "log_held", None) or []
    w.log_held = []
    n_held = len(held)
    all_lines = held + lines_out
    segs: list = []  # [[task_name_or_None, [text...]], ...]
    for i, (off, raw) in enumerate(all_lines):
        if not raw:
            continue
        name = w.log_spans.resolve(off)
        if name is None and not final and i >= n_held:
            w.log_held = [ln for ln in all_lines[i:] if ln[1]]
            break
        name = name or w.log_name
        raw, truncated = logplane.truncate_line(raw, cfg.log_max_line_bytes)
        stats["truncated"] += truncated
        stats["lines"] += 1
        stats["bytes"] += len(raw)
        text = raw.decode("utf-8", "replace")
        if segs and segs[-1][0] == name:
            segs[-1][1].append(text)
        else:
            segs.append([name, [text]])
    # never prune spans still ahead of a held line's second look
    w.log_spans.prune(w.log_held[0][0] if w.log_held
                      else w.log_offset - len(w.log_partial))
    if not segs:
        return None, stats
    return {
        "pid": w.proc.pid,
        "job_id": w.job_id.hex() if w.job_id else None,
        "segs": segs,
    }, stats


def _feed_log_span(w: _Worker, ev: dict):
    """Fold one task event's log fields into the worker's span table
    (direct-push workers self-report events through rpc_task_events;
    raylet-routed tasks stamp events in _run_on_worker)."""
    if ev.get("log_end") is not None and ev.get("log_start") is not None:
        w.log_spans.close_span(ev["task_id"], ev.get("name"),
                               ev["log_start"], ev["log_end"])
    elif ev.get("log_start") is not None:
        w.log_spans.open_span(ev["task_id"], ev.get("name"), ev["log_start"])


# Pull priorities (ray: pull_manager.h:31-38 BundlePriority — Get before
# Wait before TaskArgs).
PULL_PRIO_GET = 0
PULL_PRIO_WAIT = 1
PULL_PRIO_TASK_ARGS = 2


class _PullGate:
    """Pull admission control (ray: pull_manager.h:56 PullManager).

    Limits concurrent inbound transfers by slot count and by an in-flight
    byte budget, granting waiters in (priority, FIFO) order. A pull learns
    its size from the first chunk and then ``charge``s the budget; the sole
    active pull may always overshoot so a single huge object still
    transfers (the reference's "admit at least one bundle" rule)."""

    def __init__(self, max_concurrent: int, byte_budget: int):
        self.max_concurrent = max_concurrent
        self.byte_budget = byte_budget
        self._active = 0
        self._bytes = 0
        self._seq = 0
        self._waiters: List[tuple] = []  # heap of (priority, seq, future)

    async def acquire(self, priority: int):
        if self._active < self.max_concurrent and not self._waiters:
            self._active += 1
            return
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        heapq.heappush(self._waiters, (priority, self._seq, fut))
        await fut

    async def charge(self, nbytes: int):
        """Reserve transfer bytes; waits while the budget is exhausted by
        OTHER active transfers (never blocks the only charged pull)."""
        while self._bytes > 0 and self._bytes + nbytes > self.byte_budget:
            await asyncio.sleep(0.02)
        self._bytes += nbytes

    def uncharge(self, nbytes: int):
        self._bytes -= nbytes

    def release_slot(self):
        self._active -= 1
        while self._waiters and self._active < self.max_concurrent:
            _, _, fut = heapq.heappop(self._waiters)
            if not fut.done():
                self._active += 1
                fut.set_result(None)


class _ReadyQueues:
    """Dispatchable tasks, FIFO per scheduling class (ray:
    cluster_task_manager.cc keys queues by SchedulingClass). The dispatch
    loop skips a whole blocked class in O(1) instead of churning every
    queued task through a flat deque each wakeup."""

    __slots__ = ("by_cls", "_n")

    def __init__(self):
        self.by_cls: Dict[tuple, deque] = {}
        self._n = 0

    def append(self, qt: "_QueuedTask"):
        self.by_cls.setdefault(qt.sched_cls, deque()).append(qt)
        self._n += 1

    def push_front(self, qt: "_QueuedTask"):
        self.by_cls.setdefault(qt.sched_cls, deque()).appendleft(qt)
        self._n += 1

    def pop_head(self, cls: tuple) -> "_QueuedTask":
        q = self.by_cls[cls]
        qt = q.popleft()
        if not q:
            del self.by_cls[cls]
        self._n -= 1
        return qt

    def remove_task(self, task_id: bytes) -> Optional["_QueuedTask"]:
        for cls, q in self.by_cls.items():
            for i, qt in enumerate(q):
                if qt.spec.task_id == task_id:
                    del q[i]
                    if not q:
                        del self.by_cls[cls]
                    self._n -= 1
                    return qt
        return None

    def __len__(self):
        return self._n

    def __iter__(self):
        for q in self.by_cls.values():
            yield from q


class _QueuedTask:
    __slots__ = ("spec", "resources", "pending_deps", "worker", "sched_cls",
                 "ready_at")

    def __init__(self, spec: TaskSpec, resources: Dict[str, float]):
        self.spec = spec
        self.resources = resources
        self.pending_deps: Set[bytes] = set()
        self.worker: Optional[_Worker] = None
        # computed once: the dispatch loop touches it every pass, and
        # recomputing (a sort) per pass profiled at ~90 calls per task
        self.sched_cls = spec.scheduling_class()
        # stamped when the task enters the ready queue (placement-latency
        # histogram measures ready -> dispatched-to-worker); requeues
        # (push_front) keep the original stamp on purpose
        self.ready_at = 0.0


class Raylet:
    def __init__(
        self,
        gcs_host: str,
        gcs_port: int,
        session_dir: str,
        resources: Dict[str, float],
        labels: Dict[str, str] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        node_id: Optional[str] = None,
    ):
        self.node_id = node_id or NodeID.from_random().hex()
        # chaos identity: partition rules target "<node_id>><peer_addr>"
        faultsim.set_self_id(self.node_id)
        self.gcs_host, self.gcs_port = gcs_host, gcs_port
        self.session_dir = session_dir
        self.host = host
        self.server = RpcServer(self, host, port)
        self.store_dir = os.path.join(session_dir, f"store_{self.node_id[:12]}")
        # Spill target lives on real disk, NOT /dev/shm: spilling must
        # actually relieve memory (ray: object_spilling_config external
        # storage). A non-file URI (s3://, custom scheme) passes through
        # UN-scoped: spill keys are object ids, so a restarted raylet can
        # restore its predecessor's externally-spilled objects.
        from ray_tpu_torch._private.external_storage import is_local_spill_uri

        if cfg.external_storage_setup_module:
            # plugin hook: the module registers custom spill schemes via
            # register_external_storage_scheme before the store is built
            import importlib

            importlib.import_module(cfg.external_storage_setup_module)
        if cfg.object_spill_dir and not is_local_spill_uri(
                cfg.object_spill_dir):
            self.spill_dir = cfg.object_spill_dir
        else:
            spill_root = cfg.object_spill_dir or os.path.join(
                tempfile.gettempdir(), "ray_tpu_torch_spill"
            )
            self.spill_dir = os.path.join(
                spill_root, f"spill_{self.node_id[:12]}"
            )
        self.store = object_store.make_local_store(
            self.store_dir, cfg.object_store_memory, self.spill_dir
        )
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.labels = labels or {}
        # Advertise this node's torus coordinate to the gang scheduler
        # (topology.py reads these labels off the GCS node table). Config-
        # synthesized for now, like the reference's TPU slice env vars;
        # explicit labels win over the config flags.
        if cfg.torus_coord:
            self.labels.setdefault("torus-coord", cfg.torus_coord)
        if cfg.torus_dims:
            self.labels.setdefault("torus-dims", cfg.torus_dims)
        self.gcs: Optional[Connection] = None
        self.cluster_view: Dict[str, NodeInfo] = {}
        self.peers: Dict[str, Connection] = {}
        # Client registry: client_id -> Connection (drivers + workers on node)
        self.clients: Dict[str, Connection] = {}
        # Worker pool (idle queues keyed by runtime-env hash)
        self.idle_workers: Dict[str, deque] = {}
        self.all_workers: Dict[int, _Worker] = {}  # pid -> worker
        # spawn_id -> worker: the registration key that survives pid
        # translation through container engines (see _Worker.spawn_id)
        self._workers_by_spawn: Dict[str, _Worker] = {}
        self.workers_by_client: Dict[str, _Worker] = {}
        self.local_actors: Dict[bytes, _Worker] = {}
        self.actor_addr_cache: Dict[bytes, tuple] = {}
        # Task queues
        self.waiting: Dict[bytes, _QueuedTask] = {}  # waiting on deps
        self.ready = _ReadyQueues()
        self.running: Dict[bytes, _QueuedTask] = {}
        # Tasks no cluster node can currently fit (ray: infeasible queue);
        # reported as autoscaler demand, retried as capacity appears.
        self.infeasible: Dict[bytes, _QueuedTask] = {}
        self.dep_waiters: Dict[bytes, List[bytes]] = {}  # object -> task_ids
        self.dep_owners: Dict[bytes, tuple] = {}  # object -> owner addr
        self.pg_bundles: Dict[Tuple[str, int], Dict[str, float]] = {}
        # per-actor FIFO routing (ordered delivery; see rpc_submit_task)
        self._actor_route_queues: Dict[bytes, deque] = {}
        self._actor_routers: set = set()
        # tick-batched task_result delivery: owner -> payload list (one
        # notify frame per owner per tick instead of one per task)
        self._owner_outbox: Dict[tuple, list] = {}
        self._owner_flushing = False
        # worker leases for direct task push (ray: lease_policy.h +
        # direct_task_transport.cc): lease_id -> {worker, resources,
        # client_id}. Leased workers hold their resources and are out of
        # the idle pool until returned/reclaimed.
        self._leases: Dict[str, dict] = {}
        # recently-dead workers (client_id -> reason), so lease holders
        # can resolve why a direct connection dropped
        self._worker_fates: Dict[str, str] = {}
        self._pulls_inflight: Dict[bytes, asyncio.Future] = {}
        # push plane (ray: push_manager.h): (oid, node) dedup + per-peer
        # chunk pipelines + receiver-side assembly buffers
        self._pushes_inflight: Dict[tuple, asyncio.Future] = {}
        self._push_peer_sems: Dict[str, asyncio.Semaphore] = {}
        # in-flight actor creations: a retried create_actor (caller
        # deadline raced a slow worker spawn) joins the pending future
        # instead of spawning a second worker for the same actor_id
        self._actors_creating: Dict[bytes, asyncio.Future] = {}
        # in-flight worker spawns per env hash + wakeup for waiters
        # (requests wait on a booting same-env worker instead of racing
        # another spawn against it)
        self._workers_starting: Dict[str, int] = {}
        self._spawn_waiters: Dict[str, int] = {}
        self._worker_started = asyncio.Event()
        self._push_rx: Dict[bytes, dict] = {}
        self._pull_gate = _PullGate(
            cfg.max_concurrent_pulls,
            int(cfg.object_store_memory * cfg.pull_manager_memory_fraction),
        )
        self._rr = [0]
        # tasks we spilled elsewhere and must resubmit if that node dies:
        # target_node_id -> {task_id: spec}
        self._spilled_away: Dict[str, Dict[bytes, TaskSpec]] = {}
        # spill_done notices that raced ahead of our own bookkeeping (a
        # chained re-spill can settle before our spill_submit await
        # resumes); matched and removed in _schedule_or_queue
        self._spill_released: set = set()
        # strong refs to fire-and-forget loop tasks (the event loop holds
        # tasks weakly; a GC'd pending task would silently drop its work)
        self._bg_tasks: set = set()
        self._tasks: List[asyncio.Task] = []
        self._dispatch_event = asyncio.Event()
        self._stopping = False
        self.port = None
        # metrics
        self.counters = {"tasks_dispatched": 0, "tasks_spilled": 0,
                         "objects_pulled": 0, "log_lines_published": 0,
                         "log_bytes_published": 0, "log_lines_truncated": 0}
        # log plane: "logs"-channel subscriber count piggybacked on the
        # heartbeat reply (-1 = unknown yet -> tail); tailer CPU seconds
        # accumulate for the BENCH_LOG_OVERHEAD self-measured share
        self._log_subscribers = -1
        self._log_tail_cpu_s = 0.0
        self._setup_metrics()
        # Task state-transition buffer, flushed in batches to the GCS
        # (ray: src/ray/core_worker/task_event_buffer.h:199 — we buffer at
        # the raylet, the chokepoint that sees queue/dispatch/finish for
        # every normal task on this node).
        self._task_events: List[dict] = []

    def _setup_metrics(self):
        """Register this raylet's runtime gauges (metrics_core.py).
        Every gauge is a snapshot-time callback — scheduler/pool hot
        paths pay nothing — tagged with the node id so the cluster merge
        keeps one series per node (ray parity: src/ray/stats/metric_defs.h
        scheduler/worker-pool gauges)."""
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        tags = {"node": self.node_id[:12]}

        def gauge(name, desc, fn):
            reg.gauge(name, desc).labels(**tags).set_fn(fn)

        gauge("raylet_ready_queue_depth",
              "Tasks ready for dispatch on this node",
              lambda: len(self.ready))
        gauge("raylet_waiting_tasks",
              "Tasks parked waiting on argument fetches",
              lambda: len(self.waiting))
        gauge("raylet_infeasible_tasks",
              "Tasks no cluster node can currently fit",
              lambda: len(self.infeasible))
        gauge("raylet_running_tasks", "Tasks executing on this node",
              lambda: len(self.running))
        gauge("raylet_worker_pool_size", "Live worker processes",
              lambda: len(self.all_workers))
        gauge("raylet_idle_workers", "Idle pooled workers",
              lambda: sum(len(q) for q in self.idle_workers.values()))
        gauge("raylet_store_used_bytes", "Local object store usage",
              self.store.used_bytes)
        # *_total series must expose TYPE counter (rate() and openmetrics
        # lint assume it); the raylet already keeps the tallies, so these
        # are snapshot-time counter callbacks
        reg.counter("raylet_tasks_dispatched_total",
                    "Tasks handed to workers").labels(**tags).set_fn(
            lambda: self.counters["tasks_dispatched"])
        reg.counter("raylet_tasks_spilled_total",
                    "Tasks spilled to peer nodes").labels(**tags).set_fn(
            lambda: self.counters["tasks_spilled"])
        gauge("raylet_store_spilled_objects",
              "Objects currently spilled out of shm",
              lambda: self.store.spilled_stats()["spilled_objects"])
        # memory observatory (memview.py): arena occupancy gauges on the
        # cluster scrape — dead bytes inside live segments are the
        # hole-punch reclamation candidates, and a pooled segment pinned
        # by a reader's SHARED flock is a stuck-view leak. Guarded: the
        # native store (slab_arena=0) has no arena ledger.
        st = self.store
        if hasattr(st, "arena_dead_bytes"):
            gauge("slab_arena_dead_bytes",
                  "Dead (hole-punch-reclaimable) bytes inside live slab "
                  "segments", st.arena_dead_bytes)
            gauge("slab_arena_live_bytes",
                  "Live object bytes resident in slab segments",
                  st.arena_live_bytes)
            gauge("slab_arena_fragmentation_ratio",
                  "dead / (live + dead) resident slab bytes",
                  st.arena_fragmentation)
        if hasattr(st, "arena_punched_bytes"):
            # cumulative punch-pass yield: *_total counter semantics so
            # rate() shows reclamation activity on the cluster scrape
            reg.counter(
                "slab_arena_punched_dead_bytes_total",
                "Dead bytes retired from live segments by the "
                "hole-punch reclamation pass",
            ).labels(**tags).set_fn(st.arena_punched_bytes)
        if hasattr(st, "pool_pinned"):
            # TTL-cached: a flock probe per pooled file per scrape is
            # cheap, but metrics scrapes can arrive from several pollers
            reg.gauge(
                "slab_segments_pinned",
                "Recycling-pool segments kept alive only by a reader's "
                "SHARED flock",
            ).labels(**dict(tags, reason="reader_flock")).set_fn(
                lambda: len(st.pool_pinned(max_age_s=5.0)))
        # log plane self-measurement (channel-tagged: the "logs" pubsub
        # channel is the only one carrying log records today)
        ltags = dict(tags, channel="logs")
        reg.counter("raylet_log_lines_published_total",
                    "Worker log lines published to the logs channel"
                    ).labels(**ltags).set_fn(
            lambda: self.counters["log_lines_published"])
        reg.counter("raylet_log_bytes_published_total",
                    "Worker log bytes published to the logs channel"
                    ).labels(**ltags).set_fn(
            lambda: self.counters["log_bytes_published"])
        reg.counter("raylet_log_lines_truncated_total",
                    "Log lines cut at log_max_line_bytes before publish"
                    ).labels(**ltags).set_fn(
            lambda: self.counters["log_lines_truncated"])
        reg.counter("raylet_log_tail_cpu_seconds_total",
                    "CPU seconds spent tailing+attributing worker logs"
                    ).labels(**ltags).set_fn(lambda: self._log_tail_cpu_s)
        # path="raylet": ready-queue entry -> worker dispatch on this
        # node. The driver-side direct-lease pump records the same family
        # with path="direct" (enqueue -> push to a leased worker), so the
        # live histogram schedsim calibrates against covers BOTH dispatch
        # paths (plain driver tasks bypass the raylet ready queue).
        self._placement_lat = reg.histogram(
            "raylet_task_placement_latency_seconds",
            "Task ready to dispatched-to-worker, by dispatch path",
            scale=mc.LATENCY,
        ).labels(**dict(tags, path="raylet"))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self):
        self.port = await self.server.start()
        self.gcs = await connect(self.gcs_host, self.gcs_port, handler=self, name="gcs-conn")
        reply = await self.gcs.request(
            "register_node", self._register_payload(), timeout=cfg.gcs_rpc_timeout_s
        )
        self._on_view(reply["nodes"])
        self._tasks.append(spawn(self._heartbeat_loop()))
        self._tasks.append(spawn(self._dispatch_loop()))
        self._tasks.append(
            spawn(self._memory_monitor_loop())
        )
        self._tasks.append(
            spawn(self._task_event_flush_loop())
        )
        self._tasks.append(
            spawn(self._infeasible_retry_loop())
        )
        self._tasks.append(
            spawn(self._log_tailer_loop())
        )
        if hasattr(self.store, "punch_holes"):
            self._tasks.append(spawn(self._punch_loop()))
        if cfg.enable_node_agent:
            spawn(self._start_agent())
        if cfg.worker_prestart > 0:
            spawn(self._prestart_workers())
        logger.info("raylet %s listening on %s", self.node_id[:8], self.port)
        return self.port

    async def _prestart_workers(self):
        """Warm the idle pool at boot (ray: worker_pool.cc PrestartWorkers
        / prestart_worker_first_driver): a worker process costs several
        seconds of interpreter+import time, and paying it during startup
        overlaps with driver setup instead of the first task's latency."""
        n = min(int(cfg.worker_prestart),
                max(1, int(self.resources_total.get("CPU", 1))))
        for _ in range(n):
            if len(self.all_workers) >= cfg.num_workers_soft_limit:
                return
            try:
                w = await self._start_worker(None, None)
                if w is not None and w.lease_id is None \
                        and w.busy_with is None:
                    self._return_worker(w)
            except Exception:
                logger.debug("worker prestart failed", exc_info=True)
                return

    async def _start_agent(self):
        """Spawn this node's dashboard agent (ray: agent_manager.h — a
        per-node agent process serving node-local HTTP: stats, logs,
        stacks). Its port registers in the GCS KV so the head/operators
        can find it; failure is non-fatal (agents are observability)."""

        from ray_tpu_torch._private.node import control_plane_env

        port_file = os.path.join(
            self.session_dir, f"agent_port_{self.node_id[:8]}"
        )
        try:
            self.agent_proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.dashboard.agent",
                 "--raylet-port", str(self.port),
                 "--session-dir", self.session_dir,
                 "--port-file", port_file],
                env=control_plane_env(),
                stdout=open(os.path.join(
                    self.session_dir, "logs", f"agent_{self.node_id[:8]}.out"
                ), "ab"),
                stderr=subprocess.STDOUT,
            )
            for _ in range(100):  # aiohttp import can take a moment
                if os.path.exists(port_file):
                    break
                await asyncio.sleep(0.1)
            with open(port_file) as f:
                self.agent_port = int(f.read().strip())
            await call_with_retries(
                lambda: self.gcs, "kv_put", {
                    "ns": b"node_agents", "key": self.node_id.encode(),
                    "value": str(self.agent_port).encode(),
                })
        except Exception:
            logger.warning("node agent failed to start", exc_info=True)

    # ------------------------------------------------------------------
    # worker-log streaming (ray: _private/log_monitor.py — the per-node
    # monitor tails worker log files and publishes attributed lines on
    # the GCS "logs" pubsub channel so subscribed drivers can print them)
    # ------------------------------------------------------------------
    async def _publish_worker_logs(self, batch):
        if not batch:
            return
        try:
            # rides the GCS's batched pubsub outbox (gcs._publish): a
            # burst of per-worker entries costs one frame per subscriber
            await self.gcs.request("publish", {
                "channel": "logs",
                "message": {"node_id": self.node_id, "workers": batch},
            })
        except Exception:
            pass

    def _log_resume_bounded(self):
        """A subscriber appeared after a zero-subscriber window in which
        tailing was skipped entirely. Resume from where the tailer
        stopped — NOT from EOF: the subscriber count is heartbeat-lagged
        (up to heartbeat_interval_s stale), so a task that printed right
        after the driver subscribed would have its lines silently
        skipped by an EOF jump. Instead cap the backlog at one tick
        budget; the driver's job filter drops foreign-job history
        anyway."""
        for w in self.all_workers.values():
            if not w.log_path:
                continue
            try:
                size = os.path.getsize(w.log_path)
            except OSError:
                continue
            floor = max(0, size - cfg.log_publish_max_bytes)
            if w.log_offset < floor:
                w.log_offset = floor
                w.log_partial = b""

    async def _log_tailer_loop(self):
        while True:
            await asyncio.sleep(cfg.log_tail_interval_s)
            if self._log_subscribers == 0:
                # nobody is listening (heartbeat-reported subscriber
                # count): skip even the file reads — an unwatched
                # cluster pays nothing for the log plane
                continue
            # thread_time, not perf_counter: the counter advertises CPU
            # seconds, and on a busy raylet wall time inside this loop is
            # mostly GIL/scheduler waits — it would overstate the share
            # the BENCH_LOG_OVERHEAD lane gates by several x
            t0 = time.thread_time()
            batch = []
            for w in list(self.all_workers.values()):
                entry, stats = _tail_worker_log(w)
                self._log_account(stats)
                if entry:
                    batch.append(entry)
            self._log_tail_cpu_s += time.thread_time() - t0
            await self._publish_worker_logs(batch)

    def _log_account(self, stats):
        if stats is None:
            return
        self.counters["log_lines_published"] += stats["lines"]
        self.counters["log_bytes_published"] += stats["bytes"]
        self.counters["log_lines_truncated"] += stats["truncated"]

    # ------------------------------------------------------------------
    # task events (observability; ray: task_event_buffer.h:199)
    # ------------------------------------------------------------------
    def _emit_task_event(self, spec: TaskSpec, state: str, **extra):
        ev = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "job_id": spec.job_id.hex() if spec.job_id else None,
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
            "attempt": spec.attempt,
            "state": state,
            "ts": time.time(),
            "node_id": self.node_id,
        }
        ev.update(extra)
        self._task_events.append(ev)

    async def _task_event_flush_loop(self):
        while True:
            await asyncio.sleep(cfg.metrics_report_interval_s)
            if not self._task_events:
                continue
            batch, self._task_events = self._task_events, []
            try:
                await self.gcs.request("add_task_events", {"events": batch})
            except Exception:
                # GCS unreachable: requeue a bounded amount.
                batch.extend(self._task_events)
                self._task_events = batch[-cfg.task_events_buffer_size:]

    # ------------------------------------------------------------------
    # OOM defense (ray: common/memory_monitor.h:52 MemoryMonitor +
    # raylet/worker_killing_policy.h)
    # ------------------------------------------------------------------
    def _memory_usage_fraction(self) -> float:
        if cfg.memory_monitor_test_path:
            try:
                with open(cfg.memory_monitor_test_path) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return 0.0
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", total)
            if total <= 0:
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    def _pick_oom_victim(self) -> Optional[_Worker]:
        """Worker-killing policy: prefer workers running retriable normal
        tasks, newest-first (their lost progress is smallest and the task
        resubmits); then non-actor busy workers; never idle pool workers
        (killing them frees little) and actors only as a last resort —
        matching the spirit of ray: worker_killing_policy_group_by_owner.h."""
        busy = [w for w in self.all_workers.values()
                if w.busy_with is not None or w.lease_id is not None]
        if not busy:
            return None

        def retriable(w: _Worker) -> bool:
            if w.lease_id is not None:
                # leased to a driver for direct push: the owner retries on
                # conn loss, so treat like a retriable normal task
                return True
            qt = self.running.get(w.busy_with)
            return qt is not None and qt.spec.max_retries != 0

        tiers = (
            [w for w in busy if w.actor_id is None and retriable(w)],
            [w for w in busy if w.actor_id is None],
            busy,
        )
        for tier in tiers:
            if tier:
                return max(tier, key=lambda w: w.started_at)
        return None

    async def _memory_monitor_loop(self):
        while True:
            await asyncio.sleep(cfg.memory_monitor_refresh_ms / 1000.0)
            usage = self._memory_usage_fraction()
            if usage <= cfg.memory_usage_threshold:
                continue
            victim = self._pick_oom_victim()
            if victim is None:
                continue
            logger.warning(
                "memory usage %.2f over threshold %.2f: killing worker "
                "pid=%s (task=%s)", usage, cfg.memory_usage_threshold,
                victim.proc.pid,
                victim.busy_with.hex()[:16] if victim.busy_with else None,
            )
            victim.oom_killed = True
            self.counters["workers_oom_killed"] = (
                self.counters.get("workers_oom_killed", 0) + 1
            )
            try:
                await self.gcs.request("add_event", {
                    "severity": "WARNING", "source": "raylet",
                    "label": "WORKER_OOM_KILLED",
                    "message": (
                        f"memory usage {usage:.2f} over threshold "
                        f"{cfg.memory_usage_threshold:.2f}: killed worker "
                        f"pid={victim.proc.pid}"
                    ),
                    "fields": {"node_id": self.node_id,
                               "pid": victim.proc.pid},
                })
            except Exception:
                pass
            try:
                victim.kill_process()
            except Exception:
                pass

    def _register_payload(self) -> dict:
        """Node registration incl. a report of what this raylet is actually
        running, so a restarted GCS reconciles its replayed tables
        (reference analog: node_manager.proto:358 NotifyGCSRestart +
        RayletNotifyGCSRestart, core_worker.proto:417)."""
        return {
            "node_id": self.node_id,
            "host": self.host,
            "port": self.port,
            "store_dir": self.store_dir,
            "resources_total": self.resources_total,
            "labels": self.labels,
            "state": {
                "actors_running": {
                    aid: w.client_id for aid, w in self.local_actors.items()
                    if w.client_id
                },
                "objects": list(self.store.object_ids()),
                "pg_bundles": [[pg_id, idx] for (pg_id, idx) in self.pg_bundles],
            },
        }

    async def _gcs_reconnect_loop(self):
        """The GCS connection dropped (GCS died or restarted): keep retrying
        until it accepts us again, then re-register with our live state
        (ray: gcs_rpc_server_reconnect_timeout_s — but we retry until the
        raylet itself is stopped; the GCS owns deciding we are dead)."""
        delay = 0.2
        while not self._stopping:
            try:
                # few retries per cycle: the OUTER loop owns long-horizon
                # pacing, and a short inner dial keeps post-recovery
                # reconnect latency low (connect()'s full 30-attempt
                # backoff could leave us sleeping seconds after the GCS
                # is already back)
                conn = await connect(self.gcs_host, self.gcs_port, handler=self,
                                     name="gcs-conn", retries=3)
                reply = await conn.request(
                    "register_node", self._register_payload(),
                    timeout=cfg.gcs_rpc_timeout_s,
                )
                self.gcs = conn
                self._on_view(reply["nodes"])
                logger.info("raylet %s reconnected to GCS", self.node_id[:8])
                return
            except Exception:
                await asyncio.sleep(delay)
                delay = min(delay * 1.5, 2.0)

    async def stop(self):
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for w in list(self.all_workers.values()):
            try:
                w.proc.terminate()
            except Exception:
                pass
        agent = getattr(self, "agent_proc", None)
        if agent is not None:
            try:
                agent.kill()
            except Exception:
                pass
        await self.server.stop()
        if self.gcs:
            await self.gcs.close()

    def _pending_demand(self) -> List[Dict[str, float]]:
        """Resource demand of queued tasks (infeasible + ready +
        dep-waiting), aggregated by shape with counts so a unique shape is
        never truncated away (ray: ResourceLoad aggregates by scheduling
        class before capping)."""
        shapes: Dict[tuple, dict] = {}
        for qt in (list(self.infeasible.values()) + list(self.ready)
                   + list(self.waiting.values())):
            res = qt.spec.resources
            if not res:
                continue
            key = tuple(sorted(res.items()))
            entry = shapes.get(key)
            if entry is None:
                shapes[key] = {"bundle": dict(res), "count": 1}
            else:
                entry["count"] += 1
        return list(shapes.values())[:100]  # cap on DISTINCT shapes

    def _is_idle(self) -> bool:
        """Safe-to-terminate idle: nothing queued or running, no actors,
        all resources returned, and no objects in the local store (a
        primary copy here may be the only copy in the cluster)."""
        return (
            not self.running and not self.ready and not self.waiting
            and not self.infeasible and not self.local_actors
            and self.resources_available == self.resources_total
            and not self.store.object_ids()
        )

    async def _heartbeat_loop(self):
        while True:
            try:
                reply = await self.gcs.request(
                    "heartbeat",
                    {
                        "node_id": self.node_id,
                        "resources_available": dict(self.resources_available),
                        # totals change at runtime (PG prepare adds named
                        # bundle resources); without this, other raylets
                        # judge _pg_* demand infeasible cluster-wide and
                        # bundle-scheduled work parks forever
                        "resources_total": dict(self.resources_total),
                        "pending_demand": self._pending_demand(),
                        "idle": self._is_idle(),
                    },
                    timeout=cfg.gcs_rpc_timeout_s,
                )
                if reply.get("reregister"):
                    # GCS restarted without dropping our conn (or evicted
                    # us): re-register with our live state.
                    reply = await self.gcs.request(
                        "register_node", self._register_payload(),
                        timeout=cfg.gcs_rpc_timeout_s,
                    )
                    self._on_view(reply["nodes"])
                subs = reply.get("log_subscribers")
                if subs is not None:
                    if self._log_subscribers == 0 and subs > 0:
                        self._log_resume_bounded()
                    self._log_subscribers = subs
            except (RpcError, OSError):
                # transient (RpcError covers ConnectionLost/RpcTimeoutError):
                # the reconnect loop (on_disconnect) owns recovery; the next
                # tick re-reports our state. Counted so chaos tests can see
                # the unhealthy window.
                self.counters["gcs_rpc_failures"] = (
                    self.counters.get("gcs_rpc_failures", 0) + 1
                )
            except Exception:
                logger.exception("heartbeat failed (non-transport)")
            # reclaim byte charges of push sessions whose sender died
            # (waiting for the next inbound push to sweep could wedge the
            # shared transfer budget indefinitely)
            try:
                self._expire_push_rx(time.monotonic())
            except Exception:
                pass
            await asyncio.sleep(cfg.heartbeat_interval_s)

    async def _punch_loop(self):
        """Periodic hole-punch reclamation: walk the arena's dead entry
        ranges (the memory observatory's ``dead_ranges`` are the
        measurement basis, this pass consumes it) and
        fallocate(PUNCH_HOLE|KEEP_SIZE) page-aligned interiors of
        fragmented sealed segments, returning tmpfs pages without
        waiting for whole-segment emptiness. Runs on an executor thread:
        the pass holds the store lock over flock probes + file ops."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(cfg.slab_punch_interval_s)
            if not cfg.slab_punch_enabled:
                continue
            try:
                out = await loop.run_in_executor(None,
                                                 self.store.punch_holes)
                if out.get("dead_bytes_retired"):
                    logger.info(
                        "hole-punch pass reclaimed %d dead bytes "
                        "(%d ranges in %d segment(s), %d punched; "
                        "%d pinned segment(s) skipped)",
                        out["dead_bytes_retired"], out["punched_ranges"],
                        out["segments"], out["punched_bytes"],
                        out["skipped_pinned"],
                    )
            except Exception:
                logger.exception("hole-punch pass failed")

    # ------------------------------------------------------------------
    # cluster view sync
    # ------------------------------------------------------------------
    def rpc_cluster_view(self, conn, view):
        self._on_view(view)

    def _on_view(self, view):
        died = []
        for n in view:
            prev = self.cluster_view.get(n["node_id"])
            info = NodeInfo(
                node_id=n["node_id"], host=n["host"], port=n["port"],
                store_dir=n["store_dir"], resources_total=n["resources_total"],
                labels=n.get("labels", {}),
            )
            info.resources_available = n["resources_available"]
            info.alive = n["alive"]
            self.cluster_view[n["node_id"]] = info
            if prev is not None and prev.alive and not info.alive:
                died.append(n["node_id"])
        # Keep our own availability authoritative locally.
        me = self.cluster_view.get(self.node_id)
        if me:
            me.resources_available = self.resources_available
            me.resources_total = self.resources_total
        for node_id in died:
            self._resubmit_spilled_to(node_id)
            self._push_peer_sems.pop(node_id, None)
        self._dispatch_event.set()

    def _resubmit_spilled_to(self, node_id: str):
        """A node we spilled tasks to died before reporting them settled:
        schedule them again from here (at-least-once for tasks caught
        mid-flight by a node failure — the reference re-executes such tasks
        through the owner's lease-failure retry path)."""
        stranded = self._spilled_away.pop(node_id, None)
        if not stranded:
            return
        logger.warning(
            "node %s died with %d task(s) we spilled there; resubmitting",
            node_id[:12], len(stranded),
        )
        loop = asyncio.get_running_loop()
        for spec in stranded.values():
            spec.origin_node = None
            t = spawn(self._schedule_or_queue(spec))
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)

    async def _peer(self, node_id: str) -> Optional[Connection]:
        conn = self.peers.get(node_id)
        if conn and not conn.closed:
            return conn
        info = self.cluster_view.get(node_id)
        if info is None or not info.alive:
            return None
        try:
            conn = await connect(info.host, info.port, handler=self,
                                 name=f"peer:{node_id[:8]}", retries=5)
        except Exception:
            # visible chaos window: partition tests assert on this count
            self.counters["peer_dial_failures"] = (
                self.counters.get("peer_dial_failures", 0) + 1
            )
            return None
        await conn.request("register_peer", {"node_id": self.node_id})
        # stamp the dial side too: faultsim partition rules and disconnect
        # bookkeeping can then identify the peer by node id, matching what
        # register_peer records on the accepting side
        conn.meta.update(kind="peer", node_id=node_id)
        self.peers[node_id] = conn
        return conn

    async def rpc_register_peer(self, conn: Connection, p):
        conn.meta.update(kind="peer", node_id=p["node_id"])
        return {}

    # ------------------------------------------------------------------
    # client (core worker) registry
    # ------------------------------------------------------------------
    async def rpc_register_client(self, conn: Connection, p):
        conn.meta.update(kind=p["kind"], client_id=p["client_id"], pid=p.get("pid"),
                         job_id=p.get("job_id"))
        self.clients[p["client_id"]] = conn
        if p["kind"] == "worker":
            # Spawn-id first: a containerized worker reports its
            # IN-CONTAINER pid, which differs from the engine-client pid
            # all_workers is keyed by (conmon/containerd-shim reparenting
            # — even --pid=host doesn't preserve it). Pid matching stays
            # as the fallback for pre-fix workers mid rolling upgrade.
            w = None
            if p.get("spawn_id"):
                w = self._workers_by_spawn.get(p["spawn_id"])
            if w is None:
                w = self.all_workers.get(p.get("pid"))
            if w is not None:
                w.conn = conn
                w.client_id = p["client_id"]
                w.direct_port = p.get("direct_port")
                self.workers_by_client[p["client_id"]] = w
                if not w.registered.done():
                    w.registered.set_result(w)
        return {"node_id": self.node_id, "store_dir": self.store_dir,
                "resources_total": self.resources_total, "labels": self.labels,
                # clients with a lease-capable store use the slab-arena
                # put path; others fall back to one-file writes
                "arena": bool(getattr(self.store, "arena_enabled", False))}

    def on_disconnect(self, conn: Connection):
        if conn is self.gcs:
            if not self._stopping:
                logger.warning("raylet %s lost GCS connection; reconnecting",
                               self.node_id[:8])
                return self._gcs_reconnect_loop()
            return None
        kind = conn.meta.get("kind")
        if kind in ("driver", "worker"):
            cid = conn.meta.get("client_id")
            self.clients.pop(cid, None)
            self._reclaim_client_slabs(cid)
            if kind == "driver":
                self._reclaim_client_leases(cid)
            if kind == "worker":
                return self._on_worker_conn_lost(cid)
        elif kind == "peer":
            peer_id = conn.meta.get("node_id")
            self.peers.pop(peer_id, None)
            self.counters["peer_conns_lost"] = (
                self.counters.get("peer_conns_lost", 0) + 1
            )
            # drop the per-peer push pipeline with the peer (elastic
            # clusters churn nodes; semaphores must not accumulate)
            self._push_peer_sems.pop(peer_id, None)

    async def _on_worker_conn_lost(self, client_id: str):
        w = self.workers_by_client.pop(client_id, None)
        if w is None:
            return
        self.all_workers.pop(w.proc.pid, None)
        if w.spawn_id:
            self._workers_by_spawn.pop(w.spawn_id, None)
        # record the fate so lease holders can ask WHY their direct conn
        # dropped (e.g. surface the OOM kill instead of a generic loss)
        if w.oom_killed:
            fate = (f"worker killed by the memory monitor under memory "
                    f"pressure (pid={w.proc.pid}); the task will be "
                    f"retried if retriable")
        else:
            fate = f"worker died while executing (pid={w.proc.pid})"
        self._worker_fates[client_id] = fate
        while len(self._worker_fates) > 256:
            self._worker_fates.pop(next(iter(self._worker_fates)))
        # final log drain: the crash traceback lands in the file right as
        # the process exits, after the tailer's last tick — deliver it.
        # Skipped entirely at zero subscribers: the tailer has been
        # skipping too, so this read would synchronously chew through the
        # whole untailed backlog on the event loop just to discard it
        # (and count never-published lines in the published counters).
        entry = None
        if self._log_subscribers != 0:
            entry, stats = _tail_worker_log(w, final=True)
            self._log_account(stats)
        if entry:
            t = spawn(
                self._publish_worker_logs([entry])
            )
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)
        pool = self.idle_workers.get(w.env_hash)
        if pool is not None:
            try:
                pool.remove(w)
            except ValueError:
                pass
        if w.lease_id is not None:
            # leased worker died: free its reservation; the lease holder
            # sees its direct connection drop and retries via the raylet
            self._release_lease(w.lease_id, worker_alive=False)
        if w.actor_id is not None:
            self.local_actors.pop(w.actor_id, None)
            try:
                await self.gcs.request(
                    "actor_died",
                    {"actor_id": w.actor_id, "intended": getattr(w, "kill_intended", False),
                     "reason": f"actor worker exited (pid={w.proc.pid})"},
                )
            except Exception:
                pass
        if w.busy_with is not None:
            qt = self.running.pop(w.busy_with, None)
            if qt is not None:
                res_add(self.resources_available, qt.resources)
                if w.oom_killed:
                    reason = (
                        f"worker killed by the memory monitor under memory "
                        f"pressure (pid={w.proc.pid}); the task will be "
                        f"retried if retriable"
                    )
                else:
                    reason = f"worker died while executing (pid={w.proc.pid})"
                await self._send_task_failure(qt.spec, reason, retriable=True,
                                              worker_died=True)
        self._dispatch_event.set()

    # ------------------------------------------------------------------
    # task submission path (ClusterTaskManager)
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # worker leases (direct task push)
    # ------------------------------------------------------------------
    async def rpc_lease_workers(self, conn: Connection, p):
        """Grant up to ``count`` local workers to the calling driver for
        direct task push (ray: raylet grants worker leases and the core
        worker pushes tasks straight to the leased worker,
        src/ray/core_worker/transport/direct_task_transport.cc). Each
        lease reserves ``resources`` exactly like a running task."""
        import uuid

        resources = dict(p["resources"])
        count = max(1, int(p.get("count", 1)))
        job_id = p.get("job_id") or conn.meta.get("job_id")
        client_id = conn.meta.get("client_id")
        granted = []
        for _ in range(count):
            if not res_fits(resources, self.resources_available):
                break
            w = await self._pop_worker_for(job_id, p.get("runtime_env"))
            if w is None:
                break
            # the await above can change availability; re-check before
            # reserving, and never lease a worker without a direct port
            if (w.direct_port is None
                    or not res_fits(resources, self.resources_available)):
                self._return_worker(w)
                break
            lease_id = uuid.uuid4().hex
            res_sub(self.resources_available, resources)
            w.lease_id = lease_id
            self._leases[lease_id] = {
                "worker": w, "resources": resources, "client_id": client_id,
            }
            granted.append({
                "lease_id": lease_id, "host": self.host,
                "port": w.direct_port, "worker_id": w.client_id,
            })
        # spillable: whether routing overflow through the raylet can reach
        # capacity BEYOND these leases — i.e. LIVE peer nodes exist (the
        # view retains dead nodes). On a single-node cluster a
        # constrained grant just means the local workers are the
        # bottleneck — the driver keeps the queue on its direct
        # pipelines instead of detouring it through us.
        peers_alive = sum(
            1 for nid, n in self.cluster_view.items()
            if n.alive and nid != self.node_id
        )
        return {"leases": granted, "spillable": peers_alive > 0}

    def rpc_task_events(self, conn: Connection, p):
        """Events from workers executing direct-push tasks; ride the
        raylet's batched flush to the GCS. Events carrying log offsets
        also feed the sender's span table, so the tailer can attribute
        streamed lines to task names."""
        w = self.workers_by_client.get(conn.meta.get("client_id"))
        if w is not None:
            for ev in p["events"]:
                _feed_log_span(w, ev)
        self._task_events.extend(p["events"])

    async def rpc_worker_fate(self, conn: Connection, p):
        cid = p["client_id"]
        if cid in self.workers_by_client:
            return {"alive": True, "reason": None}
        return {"alive": False, "reason": self._worker_fates.get(cid)}

    async def rpc_return_lease(self, conn: Connection, p):
        self._release_lease(p["lease_id"])
        return {}

    async def rpc_register_stored(self, conn: Connection, p):
        """A worker stored direct-task results into the node store: adopt
        them into this raylet's store view and publish locations (the
        raylet-routed path does this in _deliver_result; for direct push
        the executing worker self-reports, batched per tick)."""
        await self._register_stored_objects(p["object_ids"])
        return {}

    async def _register_stored_objects(self, oids):
        for oid in oids:
            # slab-resident results are accounted via slab_report; this
            # charges only one-file fallback writes (no-op otherwise)
            self.store.register_external(ObjectID(oid))
        if oids:
            await self._publish_locations(list(oids))

    def _release_lease(self, lease_id: str, worker_alive: bool = True):
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        w = lease["worker"]
        res_add(self.resources_available, lease["resources"])
        w.lease_id = None
        if (worker_alive and w.conn is not None and not w.conn.closed
                and self.workers_by_client.get(w.client_id) is w):
            self._return_worker(w)
        self._dispatch_event.set()

    def _reclaim_client_leases(self, client_id: str):
        """A driver died: return every lease it held."""
        for lease_id, lease in list(self._leases.items()):
            if lease["client_id"] == client_id:
                self._release_lease(lease_id)

    def _enqueue_actor_task(self, spec: TaskSpec, actor_addr):
        """Per-actor FIFO routing: enqueue SYNCHRONOUSLY (no awaits on any
        path to here) so queue order equals frame-arrival order, and drain
        with one router task per actor. Routing each task in its own
        dispatch task reorders them — concurrent wait_actor_alive awaits
        wake in arbitrary order, and the executor's seq gate then anchors
        on the wrong first arrival."""
        q = self._actor_route_queues.setdefault(spec.actor_id, deque())
        q.append((spec, actor_addr))
        if spec.actor_id not in self._actor_routers:
            self._actor_routers.add(spec.actor_id)
            spawn(
                self._actor_router(spec.actor_id)
            )

    async def rpc_submit_task(self, conn: Connection, p):
        spec: TaskSpec = p["spec"]
        if spec.actor_id is not None and not spec.actor_creation:
            self._enqueue_actor_task(spec, p.get("actor_addr"))
            return {}
        await self._schedule_or_queue(spec, depth=p.get("depth", 0))
        return {}

    async def rpc_submit_batch(self, conn: Connection, p):
        """Tick-batched submission: a driver flushing a burst sends ONE
        frame with N specs instead of N request round trips (ray parity:
        the core worker's task submission pipelining).

        Actor tasks are enqueued synchronously BEFORE the first await:
        a mid-batch await would let the next batch frame's handler run
        and enqueue its actor tasks first, reordering a single actor's
        calls across frames.

        ack="batch" (fire-and-forget lane): the reply acks frame
        ACCEPTANCE — scheduling proceeds in the background and the
        driver's await no longer spans per-spec placement. Failures past
        the ack surface exactly like failures past the legacy reply: via
        the owner-routed task_result stream and the task-event plane."""
        rest = []
        for spec in p["specs"]:
            if spec.actor_id is not None and not spec.actor_creation:
                self._enqueue_actor_task(spec, None)
            else:
                rest.append(spec)
        if p.get("ack") == "batch":
            if rest:
                t = asyncio.get_running_loop().create_task(
                    self._schedule_batch(rest)
                )
                self._bg_tasks.add(t)
                t.add_done_callback(self._bg_tasks.discard)
            return {"accepted": len(p["specs"])}
        for spec in rest:
            await self._schedule_or_queue(spec)
        return {}

    async def _schedule_batch(self, specs):
        """Background half of the batched-ack lane. The submitter already
        holds its ack, so a swallowed scheduling failure would hang its
        get() forever — every per-spec error is converted into an
        owner-routed task failure instead of a reply-path exception."""
        for spec in specs:
            try:
                await self._schedule_or_queue(spec)
            except Exception as e:  # noqa: BLE001
                logger.exception(
                    "background scheduling failed for %s",
                    spec.task_id.hex()[:16],
                )
                try:
                    await self._send_task_failure(
                        spec, f"task scheduling failed: {e!r}",
                        retriable=False,
                    )
                except Exception:
                    logger.exception(
                        "failed to surface scheduling failure for %s",
                        spec.task_id.hex()[:16],
                    )

    async def _actor_router(self, actor_id: bytes):
        """Drain one actor's routing queue sequentially (delivery order =
        submission order; execution concurrency is the executor's business,
        ray: CoreWorkerDirectActorTaskSubmitter's per-actor send queue)."""
        q = self._actor_route_queues[actor_id]
        try:
            while q:
                spec, actor_addr = q.popleft()
                try:
                    await self._route_actor_task(spec, actor_addr)
                except Exception as e:  # noqa: BLE001
                    # The submitter already got its {} reply: a swallowed
                    # routing failure would hang its ray.get forever.
                    logger.exception(
                        "routing actor task %s failed",
                        spec.task_id.hex()[:16],
                    )
                    try:
                        await self._send_task_failure(
                            spec, f"actor task routing failed: {e}",
                            retriable=True,
                        )
                    except Exception:
                        pass
        finally:
            self._actor_routers.discard(actor_id)
            if q:  # a task slipped in during the finally window
                if actor_id not in self._actor_routers:
                    self._actor_routers.add(actor_id)
                    spawn(
                        self._actor_router(actor_id)
                    )
            else:
                # drop the empty deque: actors churn, the dict must not
                # grow one entry per actor ever contacted
                self._actor_route_queues.pop(actor_id, None)

    async def rpc_spill_submit(self, conn: Connection, p):
        await self._schedule_or_queue(p["spec"], depth=p.get("depth", 0))
        return {}

    def rpc_spill_done(self, conn: Connection, p):
        """The node we spilled a task to reports it finished (or moved on):
        drop our resubmission liability."""
        key = (p["node_id"], p["task_id"])
        tracked = self._spilled_away.get(p["node_id"])
        if tracked and tracked.pop(p["task_id"], None) is not None:
            return
        # raced ahead of our own spill bookkeeping (chained re-spill can
        # settle before our spill_submit await resumes): tombstone it
        self._spill_released.add(key)
        if len(self._spill_released) > 10_000:  # bound pathological leaks
            self._spill_released.pop()

    async def _notify_spill_origin(self, spec: TaskSpec):
        """Tell the tracking node this task's fate is settled here."""
        origin = getattr(spec, "origin_node", None)
        if not origin or origin == self.node_id or spec.actor_id:
            return
        peer = await self._peer(origin)
        if peer is not None:
            try:
                await peer.notify(
                    "spill_done",
                    {"node_id": self.node_id, "task_id": spec.task_id},
                )
            except Exception:
                pass

    async def _schedule_or_queue(self, spec: TaskSpec, depth: int = 0):
        demand = spec.resources
        nodes = list(self.cluster_view.values())
        target = pick_node(nodes, demand, spec.scheduling, self.node_id, self._rr,
                           cfg.scheduler_spread_threshold)
        if target is None:
            # Infeasible now: queue locally, retried by dispatch loop.
            target = self.node_id
        if target != self.node_id and depth < cfg.max_spillback_depth:
            peer = await self._peer(target)
            if peer is not None:
                prev_origin = getattr(spec, "origin_node", None)
                spec.origin_node = self.node_id
                try:
                    # NO idem token here, deliberately: the handler itself
                    # chains spill_submit RPCs, and a task ping-ponging
                    # A->B->A->B reuses the same (task, attempt, sender)
                    # identity — dedup would make the second arrival await
                    # the first's still-running handler, a distributed
                    # deadlock. Wire-duplicate frames are already dropped
                    # by per-connection msg-id dedup, and this path never
                    # retries blindly (_spilled_away owns resubmission).
                    await peer.request(
                        "spill_submit", {"spec": spec, "depth": depth + 1}
                    )
                    self.counters["tasks_spilled"] += 1
                    # We now carry the resubmission liability for this task
                    # (normal tasks only: actor restarts are GCS-driven);
                    # the previous tracker is off the hook.
                    if not spec.actor_id:
                        key = (target, spec.task_id)
                        if key in self._spill_released:
                            # its fate settled before our await resumed
                            self._spill_released.discard(key)
                        else:
                            self._spilled_away.setdefault(target, {})[
                                spec.task_id
                            ] = spec
                        if prev_origin and prev_origin != self.node_id:
                            prev = await self._peer(prev_origin)
                            if prev is not None:
                                try:
                                    await prev.notify(
                                        "spill_done",
                                        {"node_id": self.node_id,
                                         "task_id": spec.task_id},
                                    )
                                except Exception:
                                    pass
                    return
                except Exception:
                    spec.origin_node = prev_origin
        self._queue_local(spec)

    def _queue_local(self, spec: TaskSpec):
        qt = _QueuedTask(spec, dict(spec.resources))
        missing = self._missing_deps(spec)
        if missing:
            qt.pending_deps = set(missing)
            self.waiting[spec.task_id] = qt
            self._emit_task_event(spec, "PENDING_ARGS_FETCH",
                                  missing=len(missing))
            for oid in missing:
                self.dep_waiters.setdefault(oid, []).append(spec.task_id)
                spawn(self._pull_for_dep(oid))
        else:
            qt.ready_at = time.perf_counter()
            self.ready.append(qt)
            self._emit_task_event(spec, "PENDING_NODE_ASSIGNMENT")
            self._dispatch_event.set()

    def _missing_deps(self, spec: TaskSpec) -> List[bytes]:
        missing = []
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a[0] == "r":
                oid = a[1]
                if not self.store.contains(ObjectID(oid)):
                    missing.append(oid)
                    # remember the owner for the owner-first pull
                    if len(a) > 2 and a[2] is not None:
                        self.dep_owners.setdefault(oid, tuple(a[2]))
        return missing

    async def _pull_for_dep(self, oid: bytes):
        ok = await self._ensure_local(oid, priority=PULL_PRIO_TASK_ARGS,
                                      owner=self.dep_owners.pop(oid, None))
        waiters = self.dep_waiters.pop(oid, [])
        for tid in waiters:
            qt = self.waiting.get(tid)
            if qt is None:
                continue
            if not ok:
                del self.waiting[tid]
                await self._send_task_failure(
                    qt.spec, f"failed to fetch dependency {oid.hex()[:16]}",
                    retriable=True, lost_object=oid,
                )
                continue
            qt.pending_deps.discard(oid)
            if not qt.pending_deps:
                del self.waiting[tid]
                qt.ready_at = time.perf_counter()
                self.ready.append(qt)
                self._dispatch_event.set()

    # ------------------------------------------------------------------
    # dispatch loop (LocalTaskManager)
    # ------------------------------------------------------------------
    async def _dispatch_loop(self):
        """Per-wakeup cost is O(classes + dispatched), NOT O(queue):
        the ready structure keys FIFOs by scheduling class (ray:
        cluster_task_manager.cc keys its queues by SchedulingClass), so
        when a class's head task doesn't fit, the entire class is skipped
        in O(1). A flat deque scanned with a blocked-set still cost
        O(queue) pop/append churn per wakeup — profiled at 3.7M deque ops
        for a 3k-task burst."""
        while True:
            await self._dispatch_event.wait()
            self._dispatch_event.clear()
            retry = False
            pool_exhausted = False
            for cls in list(self.ready.by_cls.keys()):
                while not pool_exhausted:
                    q = self.ready.by_cls.get(cls)
                    if not q:
                        break
                    qt = self.ready.pop_head(cls)
                    if not res_fits(qt.resources, self.resources_available):
                        # Infeasible on this node entirely: park it in the
                        # explicit infeasible queue — visible to the demand
                        # report (autoscaler scale-up) and retried when the
                        # cluster gains capacity (ray: ClusterTaskManager's
                        # infeasible queue, reported to GCS). Else this
                        # class waits for local resources to free up.
                        if not res_fits(qt.resources, self.resources_total):
                            self.infeasible[qt.spec.task_id] = qt
                            continue
                        self.ready.push_front(qt)
                        retry = True
                        break
                    w = await self._pop_worker(qt.spec)
                    if w is None:
                        # worker-pool soft limit: a global condition — no
                        # class gets a worker this pass
                        self.ready.push_front(qt)
                        retry = True
                        pool_exhausted = True
                        break
                    if not res_fits(qt.resources, self.resources_available):
                        # a concurrent lease grant (rpc_lease_workers) may
                        # have reserved these resources during the await
                        self._return_worker(w)
                        self.ready.push_front(qt)
                        retry = True
                        break
                    res_sub(self.resources_available, qt.resources)
                    qt.worker = w
                    w.busy_with = qt.spec.task_id
                    self.running[qt.spec.task_id] = qt
                    self.counters["tasks_dispatched"] += 1
                    if qt.ready_at:
                        self._placement_lat.record(
                            time.perf_counter() - qt.ready_at)
                    spawn(
                        self._run_on_worker(qt, w)
                    )
            if retry:
                # Re-arm WITHOUT blocking this loop: a completing task sets
                # the event and must be dispatched to immediately — sleeping
                # inline here capped throughput at workers/interval
                # (~400 tasks/s at 4 workers x 10ms). The timer is only the
                # fallback for conditions no completion will signal.
                asyncio.get_running_loop().call_later(
                    cfg.dispatch_retry_interval_s, self._dispatch_event.set
                )

    async def _infeasible_retry_loop(self):
        """Re-run cluster scheduling for parked infeasible tasks once some
        node's total capacity could fit them (a new node joined, a PG
        bundle committed). A reschedule failure re-parks the task — one
        dying peer must not kill the loop or drop the task."""
        while True:
            await asyncio.sleep(cfg.infeasible_retry_interval_s)
            if not self.infeasible:
                continue
            for tid, qt in list(self.infeasible.items()):
                if not any(
                    n.alive and res_fits(qt.resources, n.resources_total)
                    for n in self.cluster_view.values()
                ):
                    continue
                del self.infeasible[tid]
                try:
                    await self._schedule_or_queue(qt.spec, depth=0)
                except Exception:
                    logger.exception(
                        "rescheduling infeasible task %s failed; re-parking",
                        tid.hex()[:16],
                    )
                    self.infeasible.setdefault(tid, qt)

    async def _run_on_worker(self, qt: _QueuedTask, w: _Worker):
        # provisional open span at the file's current end: the worker
        # measures the exact range (its buffers flushed) and reports it
        # with the result — closed spans override this for attribution
        extra = {}
        if w.log_path:
            try:
                start = os.path.getsize(w.log_path)
            except OSError:
                start = None
            if start is not None:
                extra = {"log_file": os.path.basename(w.log_path),
                         "log_start": start}
                w.log_spans.open_span(qt.spec.task_id.hex(), qt.spec.name,
                                      start)
        self._emit_task_event(qt.spec, "RUNNING", pid=w.proc.pid, **extra)
        try:
            # timeout=0 (unbounded): this await spans the USER CODE's whole
            # runtime — a deadline here would falsely kill long tasks and
            # double-execute them on retry. Keepalive covers the dead-peer
            # case the default deadline exists for.
            result = await w.conn.request("execute_task", {"spec": qt.spec},
                                          timeout=0)
        except Exception as e:
            result = None
            logger.warning("dispatch to worker failed: %s", e)
        # If the worker died, _on_worker_conn_lost already popped the task and
        # returned its resources — only release them if we pop it ourselves.
        popped = self.running.pop(qt.spec.task_id, None)
        if popped is not None:
            res_add(self.resources_available, qt.resources)
        w.busy_with = None
        if result is None:
            # worker died; _on_worker_conn_lost handles failure notification.
            self._dispatch_event.set()
            return
        if w.actor_id is None and not w.conn.closed:
            self._return_worker(w)
        span = result.get("log_span")
        if span:
            extra = {"log_file": span["file"], "log_start": span["start"],
                     "log_end": span["end"]}
            w.log_spans.close_span(qt.spec.task_id.hex(), qt.spec.name,
                                   span["start"], span["end"])
        else:
            extra = {}
            w.log_spans.discard(qt.spec.task_id.hex())
        if result.get("error") is not None:
            self._emit_task_event(qt.spec, "FAILED", pid=w.proc.pid,
                                  error=str(result.get("error"))[:200],
                                  **extra)
        else:
            self._emit_task_event(qt.spec, "FINISHED", pid=w.proc.pid,
                                  duration=result.get("duration"), **extra)
        await self._deliver_result(qt.spec, result)
        self._dispatch_event.set()

    async def _deliver_result(self, spec: TaskSpec, result: dict):
        """Route a completed task's result notification to the owner."""
        await self._register_stored_objects(result.get("stored_objects", ()))
        payload = {
            "task_id": spec.task_id,
            "results": result.get("results"),
            "error": result.get("error"),
            "error_value": result.get("error_value"),
            "app_error": result.get("app_error", False),
            "retriable": result.get("retriable", False),
            "attempt": spec.attempt,
            # borrower-protocol fields (ray: reference_count.h borrowed_refs
            # reported in PushTaskReply)
            "exec_addr": result.get("exec_addr"),
            "borrows_kept": result.get("borrows_kept"),
            "returns_nested": result.get("returns_nested"),
            # num_returns="dynamic": item objects the owner must adopt
            "dynamic_return_oids": result.get("dynamic_return_oids"),
        }
        await self._route_to_owner(spec.owner, "task_result", payload)
        await self._notify_spill_origin(spec)

    async def _route_to_owner(self, owner: tuple, method: str, payload):
        node_id, client_id = owner
        if method == "task_result":
            # tick-batch: a burst of completions becomes ONE frame per
            # owner (same discipline as submit_batch on the way in)
            self._owner_outbox.setdefault((node_id, client_id), []).append(
                payload
            )
            if not self._owner_flushing:
                self._owner_flushing = True
                spawn(
                    self._flush_owner_outbox()
                )
            return
        await self._send_to_owner(node_id, client_id, method, payload)

    async def _flush_owner_outbox(self):
        await asyncio.sleep(0)  # one tick: let same-burst completions land
        outbox, self._owner_outbox = self._owner_outbox, {}
        self._owner_flushing = False
        for (node_id, client_id), payloads in outbox.items():
            if len(payloads) == 1:
                await self._send_to_owner(
                    node_id, client_id, "task_result", payloads[0]
                )
            else:
                await self._send_to_owner(
                    node_id, client_id, "task_result_batch", payloads
                )

    async def _send_to_owner(self, node_id, client_id, method: str, payload):
        if node_id == self.node_id:
            conn = self.clients.get(client_id)
            if conn is not None and not conn.closed:
                try:
                    await conn.notify(method, payload)
                except Exception:
                    pass
            return
        peer = await self._peer(node_id)
        if peer is not None:
            try:
                await peer.notify(
                    "route_to_client",
                    {"client_id": client_id, "method": method, "payload": payload},
                )
            except Exception:
                pass

    async def rpc_route_to_client(self, conn: Connection, p):
        c = self.clients.get(p["client_id"])
        if c is not None and not c.closed:
            try:
                await c.notify(p["method"], p["payload"])
            except Exception:
                pass

    async def _send_task_failure(self, spec: TaskSpec, reason: str, retriable: bool,
                                 lost_object: Optional[bytes] = None,
                                 worker_died: bool = False):
        await self._route_to_owner(
            spec.owner,
            "task_result",
            {"task_id": spec.task_id, "results": None, "error": reason,
             "system_error": True, "retriable": retriable, "attempt": spec.attempt,
             "lost_object": lost_object, "worker_died": worker_died},
        )
        await self._notify_spill_origin(spec)

    # ------------------------------------------------------------------
    # worker pool
    # ------------------------------------------------------------------
    def _return_worker(self, w: _Worker):
        self.idle_workers.setdefault(w.env_hash, deque()).append(w)

    async def _pop_worker(self, spec: TaskSpec) -> Optional[_Worker]:
        return await self._pop_worker_for(spec.job_id, spec.runtime_env)

    async def _pop_worker_for(self, job_id: Optional[bytes],
                              runtime_env: Optional[dict]) -> Optional[_Worker]:
        env_hash = runtime_env_hash(runtime_env)
        waited_s = 0.0
        while True:
            pool = self.idle_workers.get(env_hash)
            while pool:
                w = pool.popleft()
                if w.conn is not None and not w.conn.closed:
                    return w
            # A same-env worker is mid-boot (prestart or a concurrent
            # request): wait for it instead of racing a duplicate multi-
            # second interpreter spawn — but only as many waiters as
            # there are boots in flight, so N genuinely-concurrent
            # requests still spawn N workers in parallel.
            starting = self._workers_starting.get(env_hash, 0)
            waiting = self._spawn_waiters.get(env_hash, 0)
            if starting <= waiting:
                break
            if waited_s > cfg.worker_register_timeout_s * 2:
                # Livelock breaker: no boot takes this long — a leaked
                # _workers_starting count would otherwise park every
                # lease/dispatch for this env forever. Spawn our own.
                logger.error(
                    "spawn-wait exceeded %.0fs (starting=%d waiting=%d "
                    "env=%s); breaking out to spawn directly",
                    waited_s, starting, waiting, env_hash[:8],
                )
                break
            self._spawn_waiters[env_hash] = waiting + 1
            try:
                await asyncio.wait_for(self._worker_started.wait(), 0.25)
            except asyncio.TimeoutError:
                pass
            finally:
                self._spawn_waiters[env_hash] -= 1
            waited_s += 0.25
            self._worker_started.clear()
        n_alive = len(self.all_workers)
        if n_alive >= cfg.num_workers_soft_limit:
            # Reclaim ONE idle worker of a different runtime env to free a slot.
            for other in self.idle_workers.values():
                reclaimed = False
                while other:
                    victim = other.popleft()
                    if victim.conn is not None and not victim.conn.closed:
                        victim.kill_intended = True
                        victim.proc.terminate()
                        reclaimed = True
                        break
                if reclaimed:
                    break
            return None
        return await self._start_worker(job_id, runtime_env)

    async def _start_worker(self, job_id: Optional[bytes],
                            runtime_env: Optional[dict] = None) -> Optional[_Worker]:
        from ray_tpu_torch._private.node import package_env

        env = package_env()
        if runtime_env:
            for k, v in (runtime_env.get("env_vars") or {}).items():
                env[k] = str(v)
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id
        # explicit spawn key (RAY_TPU_TORCH_ prefix rides the container env
        # filter): the worker echoes it in register_client so the match
        # works even when the engine translates pids
        import uuid as _uuid

        spawn_id = _uuid.uuid4().hex
        env["RAY_TPU_TORCH_WORKER_SPAWN_ID"] = spawn_id
        # workers bind their direct-push server to the same host the
        # raylet advertises in lease grants and actor direct_addrs
        env["RAY_TPU_TORCH_NODE_IP"] = self.host
        env["RAY_TPU_TORCH_RAYLET_PORT"] = str(self.port)
        env["RAY_TPU_TORCH_GCS_ADDR"] = f"{self.gcs_host}:{self.gcs_port}"
        env["RAY_TPU_TORCH_STORE_DIR"] = self.store_dir
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        if runtime_env:
            # ship every key except env_vars (already applied at spawn,
            # above) so the worker's plugin registry — built-ins AND
            # custom plugins — can materialize it before serving tasks
            # (ray: raylet -> runtime-env agent CreateRuntimeEnv).
            import json as _json

            to_ship = {k: v for k, v in runtime_env.items()
                       if k != "env_vars" and v is not None}
            if to_ship:
                try:
                    env["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(to_ship)
                except TypeError:
                    # defense in depth (the driver validates at option
                    # time): a non-JSON value must not kill the dispatch
                    # loop — ship the safe subset and log loudly
                    safe = {}
                    for k, v in to_ship.items():
                        try:
                            _json.dumps(v)
                            safe[k] = v
                        except TypeError:
                            logger.error(
                                "runtime_env[%r] is not JSON-serializable; "
                                "dropped for worker spawn", k,
                            )
                    if safe:
                        env["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(safe)
        # Workers create no CUDA context until a task or actor touches the
        # card (torch initializes CUDA lazily).
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        self._worker_seq = getattr(self, "_worker_seq", 0) + 1
        log_file = os.path.join(
            log_dir,
            f"worker-{self.node_id[:8]}-{self._worker_seq}.out",
        )
        # the worker measures its own log offsets around user code for
        # per-task attribution (logplane.stdio_offset); RAY_TPU_TORCH_ prefix
        # rides the container env filter like the spawn id does
        env["RAY_TPU_TORCH_WORKER_LOG_FILE"] = log_file
        argv = [sys.executable, "-m", "ray_tpu_torch._private.worker_main"]
        cidfile = None
        container = (runtime_env or {}).get("container")
        if container is not None and (
            not isinstance(container, dict) or not container.get("image")
        ):
            # defense in depth: the driver validates at option time, but a
            # hand-built spec must not crash the dispatch loop
            logger.error(
                "invalid runtime_env['container'] %r: expected a dict with "
                "'image'; refusing to spawn", container,
            )
            return None
        if container:
            # container plugin (ray parity: runtime_env/container.py):
            # the worker process runs INSIDE the image; host network/ipc/
            # pid namespaces and /dev/shm shared so control plane, data
            # plane, and pid-keyed registration are unchanged. The
            # cidfile lets us force-remove the container if we have to
            # kill the engine client (SIGKILL never proxies inside).
            from ray_tpu_torch._private.runtime_env import build_container_command

            cidfile = os.path.join(
                log_dir, f"container-{self.node_id[:8]}-{self._worker_seq}.cid"
            )
            env_var_keys = tuple((runtime_env or {}).get("env_vars") or ())
            argv = build_container_command(
                container, env,
                ["python", "-m", "ray_tpu_torch._private.worker_main"],
                extra_env_keys=env_var_keys,
                cidfile=cidfile,
            )
        proc = subprocess.Popen(
            argv,
            env=env,
            stdout=open(log_file, "ab"),
            stderr=subprocess.STDOUT,
        )
        w = _Worker(proc, job_id, env_hash=runtime_env_hash(runtime_env),
                    log_path=log_file, cidfile=cidfile,
                    engine=(container.get("engine") or cfg.container_runtime)
                    if container else None, spawn_id=spawn_id)
        self.all_workers[proc.pid] = w
        self._workers_by_spawn[spawn_id] = w
        ehash = w.env_hash
        self._workers_starting[ehash] = \
            self._workers_starting.get(ehash, 0) + 1
        logger.info("spawning worker pid=%s env=%s (starting=%d)",
                    proc.pid, ehash[:8], self._workers_starting[ehash])
        try:
            await asyncio.wait_for(w.registered, cfg.worker_register_timeout_s)
        except asyncio.TimeoutError:
            logger.error(
                "worker %s failed to register within %.0fs (proc %s)",
                proc.pid, cfg.worker_register_timeout_s,
                "alive" if proc.poll() is None
                else f"exited rc={proc.returncode}",
            )
            w.kill_process()  # reaches the container too, if any
            self.all_workers.pop(proc.pid, None)
            self._workers_by_spawn.pop(spawn_id, None)
            return None
        finally:
            self._workers_starting[ehash] -= 1
            self._worker_started.set()
        logger.info("worker pid=%s registered", proc.pid)
        return w

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    async def rpc_create_actor(self, conn: Connection, p):
        spec: TaskSpec = p["spec"]
        # App-level idempotency: a retried creation (the reply to the first
        # attempt was lost in flight, or the caller's deadline expired while
        # the worker was still spawning) must join the live/in-flight
        # creation, not spawn a second worker for the same actor_id. This
        # is the dedup layer for create_actor — an rpc-level idem token is
        # wrong here because the scheduler legitimately re-asks after
        # transient rejections, and a cached {"rejected"} would poison
        # every later attempt on this node.
        w = self.local_actors.get(spec.actor_id)
        if w is not None and w.conn is not None and not w.conn.closed:
            return {"worker_client_id": w.client_id,
                    "direct_addr": (self.host, w.direct_port)
                    if w.direct_port else None}
        pending = self._actors_creating.get(spec.actor_id)
        if pending is not None:
            # a retry racing the in-flight creation shares its outcome
            # (resolved with a reply dict, never an exception)
            return await asyncio.shield(pending)
        fut = asyncio.get_running_loop().create_future()
        self._actors_creating[spec.actor_id] = fut
        reply = {"rejected": True}
        try:
            reply = await self._do_create_actor(spec)
            return reply
        finally:
            self._actors_creating.pop(spec.actor_id, None)
            if not fut.done():
                fut.set_result(reply)

    async def _do_create_actor(self, spec: TaskSpec) -> dict:
        if not res_fits(spec.resources, self.resources_available):
            return {"rejected": True}
        w = await self._pop_worker(spec)
        if w is None:
            return {"rejected": True}
        res_sub(self.resources_available, spec.resources)
        try:
            reply = await w.conn.request("become_actor", {"spec": spec},
                                         timeout=cfg.gcs_rpc_timeout_s)
        except Exception as e:
            res_add(self.resources_available, spec.resources)
            return {"rejected": True, "detail": str(e)}
        if reply.get("error"):
            res_add(self.resources_available, spec.resources)
            self._return_worker(w)
            return {"error": reply["error"]}
        w.actor_id = spec.actor_id
        w.actor_resources = dict(spec.resources)
        # streamed-line fallback prefix: anything this worker prints
        # outside a method's span attributes to the actor class
        w.log_name = spec.name
        self.local_actors[spec.actor_id] = w
        return {"worker_client_id": w.client_id,
                "direct_addr": (self.host, w.direct_port)
                if w.direct_port else None}

    async def rpc_kill_actor(self, conn: Connection, p):
        w = self.local_actors.get(p["actor_id"])
        if w is None:
            return {}
        w.kill_intended = True
        res_add(self.resources_available, getattr(w, "actor_resources", {}))
        try:
            w.proc.terminate()
        except Exception:
            pass
        return {}

    async def _route_actor_task(self, spec: TaskSpec, actor_addr: Optional[tuple]):
        # Local actor: push straight to its worker.
        w = self.local_actors.get(spec.actor_id)
        if w is not None and w.conn is not None and not w.conn.closed:
            spawn(self._run_actor_task(spec, w))
            return
        addr = actor_addr or self.actor_addr_cache.get(spec.actor_id)
        if addr is None or addr[0] == self.node_id:
            try:
                table = await self.gcs.request(
                    "wait_actor_alive",
                    {"actor_id": spec.actor_id,
                     "timeout": cfg.actor_route_wait_alive_timeout_s}
                )
            except Exception:
                table = None
            if table is None or table["state"] == "DEAD" or not table.get("address"):
                await self._route_to_owner(
                    spec.owner, "task_result",
                    {"task_id": spec.task_id, "results": None,
                     "error": f"actor {spec.actor_id.hex()[:16]} is dead"
                     if table and table["state"] == "DEAD" else "actor unavailable",
                     "actor_dead": bool(table and table["state"] == "DEAD"),
                     "system_error": True, "retriable": False, "attempt": spec.attempt},
                )
                return
            addr = tuple(table["address"])
        self.actor_addr_cache[spec.actor_id] = addr
        if addr[0] == self.node_id:
            await self._route_actor_task(spec, None)
            return
        peer = await self._peer(addr[0])
        if peer is None:
            self.actor_addr_cache.pop(spec.actor_id, None)
            await self._send_task_failure(spec, "actor node unreachable", retriable=True)
            return

        # Forward WITHOUT awaiting the round trip: the per-actor router
        # must not serialize throughput to one task per RTT. In-order
        # sends are enough for ordering (the remote enqueues synchronously
        # on dispatch); the tracked task handles a failed forward.
        async def _forward():
            try:
                await peer.request(
                    "submit_task", {"spec": spec, "actor_addr": addr}
                )
            except Exception:
                self.actor_addr_cache.pop(spec.actor_id, None)
                await self._send_task_failure(
                    spec, "actor node unreachable", retriable=True
                )

        spawn(_forward())

    async def _run_actor_task(self, spec: TaskSpec, w: _Worker):
        try:
            # timeout=0: spans the actor method's runtime (see dispatch path)
            result = await w.conn.request("execute_task", {"spec": spec},
                                          timeout=0)
        except Exception:
            # actor worker died mid-task; GCS failure path notifies owner of
            # actor death; report retriable failure for this call.
            await self._send_task_failure(spec, "actor worker died",
                                          retriable=True, worker_died=True)
            return
        await self._deliver_result(spec, result)

    # ------------------------------------------------------------------
    # object plane
    # ------------------------------------------------------------------
    async def rpc_register_put(self, conn: Connection, p):
        oid = p["object_id"]
        self.store.register_external(ObjectID(oid))
        try:
            await self.gcs.request(
                "add_object_location", {"object_id": oid, "node_id": self.node_id}
            )
        except Exception:
            pass
        return {}

    # -- slab arena lease + batched accounting (slab_arena.py) ---------
    async def rpc_lease_slab(self, conn: Connection, p):
        """Grant a write slab to a local client (one RPC amortized over
        many puts); ``seal`` retires the caller's previous slab in the
        same round trip. A denial (no arena / store full of leased
        slabs) sends the writer to the one-file fallback path, whose
        register_external accounts the overshoot honestly."""
        lease = getattr(self.store, "lease_slab", None)
        if lease is None:
            return {"ok": False}
        seals = p.get("seals") or ([p["seal"]] if p.get("seal") else [])
        return lease(conn.meta.get("client_id") or "", int(p["bytes"]),
                     seals)

    async def rpc_slab_report(self, conn: Connection, p):
        """Batched put accounting from a slab writer: adopt the entries
        into the store ledger and publish the new locations to the GCS
        in ONE frame (vs the legacy one-register_put-RPC-per-put)."""
        record = getattr(self.store, "record_slab_objects", None)
        if record is None:
            return {}
        new = record(p["objects"])
        if new:
            await self._publish_locations(new)
            self._dispatch_event.set()
        return {}

    def _reclaim_client_slabs(self, client_id: str):
        """A slab-leasing client died: adopt the sealed prefixes of its
        leased segments (torn mid-put tails are discarded by the scan)
        and publish any unreported objects it managed to seal."""
        reclaim = getattr(self.store, "reclaim_client_slabs", None)
        if reclaim is None or not client_id:
            return
        try:
            new = reclaim(client_id)
        except Exception:
            logger.exception("slab reclaim for %s failed", client_id[:8])
            return
        if new:
            t = spawn(self._publish_locations(new))
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_tasks.discard)

    async def _publish_locations(self, oids):
        try:
            await self.gcs.request(
                "add_object_locations",
                {"object_ids": list(oids), "node_id": self.node_id},
            )
        except Exception:
            pass  # directory is best-effort; owner locations self-heal

    async def rpc_pull_object(self, conn: Connection, p):
        owner = p.get("owner")
        ok = await self._ensure_local(
            p["object_id"], timeout=p.get("timeout"),
            priority=p.get("priority", PULL_PRIO_GET),
            owner=tuple(owner) if owner else None,
        )
        return {"ok": ok}

    async def _ensure_local(self, oid_bytes: bytes,
                            timeout: Optional[float] = None,
                            priority: int = PULL_PRIO_GET,
                            owner: Optional[tuple] = None) -> bool:
        oid = ObjectID(oid_bytes)
        if self.store.contains(oid):
            # May be spilled: bring it back into shm so workers can mmap it.
            restore = getattr(self.store, "restore_if_spilled", None)
            if restore is not None:
                restore(oid)
            return True
        fut = self._pulls_inflight.get(oid_bytes)
        if fut is not None:
            ok = await fut
            if ok or owner is None:
                return ok
            # the coalesced pull may have lacked our owner hint (e.g. an
            # ownerless pull racing a dep pull during a GCS outage): try
            # once more owner-aware now that the failed pull is cleared
            if self._pulls_inflight.get(oid_bytes) is None:
                return await self._ensure_local(
                    oid_bytes, timeout=timeout, priority=priority,
                    owner=owner,
                )
            return ok
        fut = asyncio.get_running_loop().create_future()
        self._pulls_inflight[oid_bytes] = fut
        try:
            await self._pull_gate.acquire(priority)
            try:
                ok = await self._do_pull(oid, timeout=timeout, owner=owner)
            finally:
                self._pull_gate.release_slot()
            # an incoming push may have satisfied (and resolved) us already
            if not fut.done():
                fut.set_result(ok)
            return fut.result()
        except Exception as e:
            if not fut.done():
                fut.set_result(False)
            logger.warning("pull of %s failed: %s", oid_bytes.hex()[:16], e)
            return False
        finally:
            self._pulls_inflight.pop(oid_bytes, None)

    async def _do_pull(self, oid: ObjectID, timeout: Optional[float] = None,
                       owner: Optional[tuple] = None) -> bool:
        """Resolve locations OWNER-FIRST (ray:
        ownership_based_object_directory.h): the owning worker is the
        authority on where its object has copies; the GCS directory is
        only the bootstrap/cache fallback. Pulls therefore keep working
        through a GCS outage or restart whenever the caller knows the
        owner (task args and driver gets do)."""
        deadline = time.monotonic() + (timeout or cfg.object_pull_timeout_s)
        while time.monotonic() < deadline:
            owner_locs: list = []
            if owner is not None:
                owner_locs = await self._query_owner_locations(
                    owner, oid, deadline
                )
            # Merge rather than short-circuit: a stale owner entry (no
            # removal protocol on eviction) must not shadow a live copy
            # the GCS knows about. A dead GCS just contributes nothing.
            locs = list(owner_locs)
            try:
                gcs_locs = await self.gcs.request(
                    "get_object_locations",
                    {"object_id": oid.binary(), "wait": not owner_locs,
                     "timeout": max(0.1, min(5.0,
                                             deadline - time.monotonic()))},
                )
                locs.extend(l for l in gcs_locs if l not in locs)
            except Exception:
                pass
            locs = [l for l in locs if l != self.node_id]
            if not locs and self.store.contains(oid):
                return True
            for node_id in locs:
                peer = await self._peer(node_id)
                info = self.cluster_view.get(node_id)
                same_host = info is not None and info.host == self.host
                if peer is not None and await self._fetch_from(
                        peer, oid, same_host=same_host):
                    self.counters["objects_pulled"] += 1
                    if node_id in owner_locs:
                        self.counters["owner_location_hits"] = (
                            self.counters.get("owner_location_hits", 0) + 1
                        )
                    if owner is not None:
                        await self._send_to_owner(
                            owner[0], owner[1], "owner_add_location",
                            {"object_id": oid.binary(),
                             "node_id": self.node_id},
                        )
                    try:
                        # retried (idempotent): a dropped registration would
                        # leave the new copy invisible to the directory
                        await call_with_retries(
                            lambda: self.gcs, "add_object_location",
                            {"object_id": oid.binary(),
                             "node_id": self.node_id},
                        )
                    except Exception:
                        pass
                    return True
                if owner is not None and node_id in owner_locs:
                    # unreachable/empty copy: retract the stale entry so
                    # the owner directory converges
                    await self._send_to_owner(
                        owner[0], owner[1], "owner_remove_location",
                        {"object_id": oid.binary(), "node_id": node_id},
                    )
            if self.store.contains(oid):
                return True
            await asyncio.sleep(cfg.pull_location_poll_interval_s)
        return False

    async def _query_owner_locations(self, owner: tuple, oid: ObjectID,
                                     deadline: float) -> list:
        # cap by the pull deadline: this runs while holding a pull-gate
        # slot, so a half-open owner connection must not starve the gate
        # for a full RPC timeout per attempt
        budget = max(0.1, min(cfg.gcs_rpc_timeout_s,
                              deadline - time.monotonic()))
        node_id, client_id = tuple(owner)
        try:
            if node_id == self.node_id:
                conn = self.clients.get(client_id)
                if conn is None or conn.closed:
                    return []
                reply = await conn.request(
                    "object_locations", {"object_id": oid.binary()},
                    timeout=budget,
                )
            else:
                peer = await self._peer(node_id)
                if peer is None:
                    return []
                reply = await peer.request(
                    "owner_locations",
                    {"client_id": client_id, "object_id": oid.binary()},
                    timeout=budget,
                )
            return list(reply.get("locations") or [])
        except Exception:
            return []

    async def rpc_owner_locations(self, conn: Connection, p):
        """Peer raylet resolving an owner that is OUR local client."""
        c = self.clients.get(p["client_id"])
        if c is None or c.closed:
            return {"locations": []}
        try:
            return await c.request(
                "object_locations", {"object_id": p["object_id"]},
                timeout=cfg.gcs_rpc_timeout_s,
            )
        except Exception:
            return {"locations": []}

    async def _fetch_from(self, peer: Connection, oid: ObjectID,
                          same_host: bool = False) -> bool:
        """Pull one object from a peer: the first chunk reveals the total
        size and metadata; the rest are fetched through a bounded window
        of CONCURRENT chunk requests (a serial chunk loop is latency-
        bound — the reason push used to outrun pull) that land
        out-of-order at their offsets. With a slab-backed store the
        chunks pwrite straight into a reserved unsealed arena entry
        (receive-side slab assembly: no heap staging, no store-put copy)
        sealed by the atomic state-word flip only when every byte has
        arrived; otherwise they assemble in heap buffers as before.

        ``same_host`` collapses the request window to 1: loopback peers
        have no RTT to hide, so concurrent frames on one connection only
        contend for CPU — the net-read-overlaps-pwrite pipelining below
        still applies (the measured win on single-host clusters)."""
        chunk = cfg.object_transfer_chunk_bytes
        head = max(1, min(chunk, cfg.fetch_head_chunk_bytes))
        t0 = time.perf_counter()
        try:
            first = await peer.request(
                "fetch_object",
                {"object_id": oid.binary(), "offset": 0, "chunk": head},
                timeout=cfg.gcs_rpc_timeout_s,
            )
        except Exception:
            return False
        if not first.get("exists"):
            return False
        total = first["total"]
        metadata = first["metadata"]
        # Byte-budget admission: now that the size is known, reserve it so
        # concurrent pulls cannot together overrun the transfer budget.
        await self._pull_gate.charge(total)
        res = None
        sealed = False
        try:
            data0 = first["data"]
            reserve = getattr(self.store, "reserve", None)
            if reserve is not None:
                res = reserve(oid, metadata, total)
            parts: Optional[dict] = None if res is not None else {}
            received = [0]
            failed = [False]
            loop = asyncio.get_running_loop()
            land_lock = asyncio.Lock()

            async def land(off, data):
                if res is not None:
                    # pwrite on an executor thread (os.pwrite drops the
                    # GIL): the event loop keeps decoding the next
                    # in-flight chunk's frame while this one lands —
                    # without this, chunk writes serialize behind frame
                    # reads and the pipeline buys nothing. Landings are
                    # SERIALIZED with each other (one pwrite at a time):
                    # parallel multi-MB pwrites just fight the socket
                    # reads for memory bandwidth
                    async with land_lock:
                        await loop.run_in_executor(None, res.write, off,
                                                   data)
                else:
                    parts[off] = data
                received[0] += len(data)

            try:
                await land(0, data0)
            except (ValueError, OSError):
                # same contract as the per-chunk guard in fetch_one: an
                # arena-landing failure (ENOSPC at first touch) fails
                # THIS attempt — the finally abandons the reservation,
                # and the retry's reserve() degrades to heap assembly
                return False
            if received[0] < total:
                depth = 1 if same_host else cfg.fetch_pipeline_depth
                sem = asyncio.Semaphore(max(1, depth))

                async def fetch_one(off):
                    try:
                        nxt = await peer.request(
                            "fetch_object",
                            {"object_id": oid.binary(), "offset": off,
                             "chunk": chunk},
                            timeout=cfg.gcs_rpc_timeout_s,
                        )
                        data = nxt["data"] if nxt.get("exists") else None
                    except Exception:
                        data = None
                    finally:
                        # the slot guards NETWORK in-flight only: freeing
                        # it at arrival lets the next chunk's socket read
                        # overlap this chunk's pwrite (the landing queue
                        # stays ~1 deep — pwrite outruns the wire)
                        sem.release()
                    if data is None or len(data) != min(chunk, total - off):
                        failed[0] = True
                        return
                    try:
                        await land(off, data)
                    except (ValueError, OSError):
                        failed[0] = True

                pending = []
                for off in range(len(data0), total, chunk):
                    await sem.acquire()
                    if failed[0]:
                        sem.release()
                        break  # stop issuing into a failed transfer
                    pending.append(spawn(fetch_one(off)))
                await asyncio.gather(*pending, return_exceptions=True)
            if failed[0] or received[0] != total:
                return False
            if res is not None:
                sealed = res.seal()
                if not sealed:
                    return False
                path = "arena"
            else:
                self.store.put(oid, metadata,
                               [parts[k] for k in sorted(parts)], total)
                # "heap": chunks staged through heap buffers before the
                # store-put copy (legacy/native fallback only)
                path = "heap"
            from ray_tpu_torch._private import memview

            memview.record_flow("fetch", total,
                                time.perf_counter() - t0, path,
                                oid.hex())
            return True
        finally:
            if res is not None and not sealed:
                res.abandon()
            self._pull_gate.uncharge(total)

    # ------------------------------------------------------------------
    # push plane (ray: object_manager/push_manager.h:30 — owner/holder-
    # initiated transfer with per-peer chunk budgets and dedup, vs the
    # receiver-driven pull path above) + tree broadcast
    # ------------------------------------------------------------------
    async def push_object(self, oid: ObjectID, node_id: str) -> bool:
        """Push a locally-present object to one peer. Dedup: a second push
        of the same (object, peer) while one is in flight piggybacks on
        it; chunk sends share a bounded per-peer pipeline."""
        key = (oid.binary(), node_id)
        existing = self._pushes_inflight.get(key)
        if existing is not None:
            return await asyncio.shield(existing)
        fut = asyncio.get_running_loop().create_future()
        self._pushes_inflight[key] = fut
        ok = False
        try:
            ok = await self._do_push(oid, node_id)
        except Exception as e:  # noqa: BLE001
            logger.warning("push of %s to %s failed: %s",
                           oid.hex()[:16], node_id[:8], e)
        finally:
            # resolve in the finally: if this task is CANCELLED mid-push,
            # piggybacked pushers shielded on `fut` must not hang forever
            self._pushes_inflight.pop(key, None)
            if not fut.done():
                fut.set_result(ok)
        if ok:
            self.counters["objects_pushed"] = (
                self.counters.get("objects_pushed", 0) + 1
            )
        return ok

    async def _do_push(self, oid: ObjectID, node_id: str) -> bool:
        peer = await self._peer(node_id)
        if peer is None:
            return False
        buf = self.store.get(oid)
        if buf is None:
            return False
        t0 = time.perf_counter()
        try:
            total = len(buf.data)
            chunk = cfg.object_transfer_chunk_bytes
            # session nonce: the receiver assembles per (object, push_id),
            # so interleaved pushes of the same object from two senders
            # (possibly with different chunk sizes) can never mix chunks
            push_id = f"{self.node_id[:8]}:{time.monotonic_ns()}"
            sem = self._push_peer_sems.setdefault(
                node_id, asyncio.Semaphore(cfg.push_max_chunks_in_flight)
            )

            failed = [False]
            landed = [False]  # receiver confirmed the object is in its store

            async def send(payload):
                try:
                    reply = await peer.request(
                        "push_chunks", payload, timeout=cfg.gcs_rpc_timeout_s
                    )
                    ok = bool(reply.get("ok") or reply.get("have"))
                    if reply.get("assembled") or reply.get("have"):
                        landed[0] = True
                except Exception:
                    ok = False
                finally:
                    sem.release()
                if not ok:
                    failed[0] = True
                return ok

            sends = []
            off = 0
            while True:
                if failed[0]:
                    break  # a chunk already failed: stop wasting bandwidth
                # zero-copy chunk: a PickleBuffer over the mmap'd store
                # view rides the v2 frame out-of-band (in-band, one copy,
                # on a v1 peer); the view is written before request()
                # resolves, so buf.release() below never races the send
                view = buf.data[off:off + chunk]
                payload = {
                    "object_id": oid.binary(), "offset": off,
                    "total": total, "data": pickle.PickleBuffer(view),
                    "push_id": push_id,
                }
                if off == 0:
                    payload["metadata"] = buf.metadata
                await sem.acquire()
                sends.append(
                    spawn(send(payload))
                )
                off += view.nbytes
                if off >= total:
                    break
            results = await asyncio.gather(*sends, return_exceptions=True)
            sent_all = off >= total and not failed[0]
            # success requires an explicit landing ack (assembled / have):
            # per-chunk acks alone can all succeed while the receiver's
            # session expired mid-push and the object never materialized
            ok = (sent_all and all(r is True for r in results)
                  and landed[0])
            if ok:
                from ray_tpu_torch._private import memview

                # sender path: zero-copy views straight off the slab
                # ("arena") vs a legacy file mapping ("file")
                memview.record_flow(
                    "push", total, time.perf_counter() - t0,
                    "arena" if buf.seg_id is not None else "file",
                    oid.hex())
            return ok
        finally:
            buf.release()

    def _drop_push_rx(self, key, st: dict):
        """Retire one push-rx session: return its byte charge AND
        discard its partially-written slab reservation (tombstoned dead,
        uncharged) — an abandoned session must not leak an unsealed
        entry eroding arena capacity until restart."""
        self._push_rx.pop(key, None)
        res = st.get("res")
        if res is not None:
            try:
                res.abandon()
            except Exception:
                logger.exception("push-rx reservation abandon failed")
        self._pull_gate.uncharge(st["total"])

    def _expire_push_rx(self, now: float):
        """Drop abandoned assemblies (sender died mid-push) and return
        their byte charges to the transfer budget."""
        for k, st in list(self._push_rx.items()):
            if now - st["ts"] > cfg.push_rx_expiry_s:
                self._drop_push_rx(k, st)

    async def rpc_push_chunks(self, conn: Connection, p):
        """Receiver side: assemble out-of-order chunks of ONE push session
        (keyed by (object, push_id) so concurrent senders never interleave);
        finalize into the store and register the location when complete.
        Inbound bytes charge the same transfer budget as pulls — blocking
        here backpressures the sender through its chunk pipeline.

        Receive-side slab assembly: once the metadata-bearing chunk
        (offset 0) has arrived — the entry layout is [HDR][meta][data],
        so data offsets need the metadata length — the session reserves
        an unsealed slab entry and every chunk pwrites straight into the
        segment at its offset; the seal is the same atomic state-word
        flip a local put uses, performed only when all bytes arrived.
        Chunks that beat the metadata chunk stage in heap briefly and
        flush into the reservation when it exists."""
        oid = ObjectID(p["object_id"])
        if self.store.contains(oid):
            # drop any in-progress assembly of this object (e.g. a slower
            # concurrent push) and return its pull-gate byte charge now
            # rather than stranding it until the expiry sweep
            for k, st in list(self._push_rx.items()):
                if k[0] == oid.binary():
                    self._drop_push_rx(k, st)
            return {"have": True}
        now = time.monotonic()
        self._expire_push_rx(now)
        key = (oid.binary(), p.get("push_id", ""))
        st = self._push_rx.get(key)
        if st is None:
            await self._pull_gate.charge(p["total"])
            if self.store.contains(oid):  # landed while we waited
                self._pull_gate.uncharge(p["total"])
                return {"have": True}
            # charge() suspended: a sibling chunk of this session may have
            # created the state meanwhile — overwriting it would drop its
            # chunk and leak a second charge
            st = self._push_rx.get(key)
            if st is not None:
                self._pull_gate.uncharge(p["total"])
            else:
                st = self._push_rx[key] = {
                    "parts": {}, "meta": None, "total": p["total"],
                    "ts": now, "t0": now, "res": None, "heap": False,
                    "got": 0, "seen": set(),
                }
        st["ts"] = now
        if p.get("metadata") is not None:
            st["meta"] = p["metadata"]
        if st["res"] is None and not st["heap"] and st["meta"] is not None:
            reserve = getattr(self.store, "reserve", None)
            if reserve is not None:
                st["res"] = reserve(oid, st["meta"], st["total"])
            if st["res"] is None:
                st["heap"] = True  # fall back for the session's lifetime
            else:
                try:
                    for off, d in st["parts"].items():
                        st["res"].write(off, d)
                except (ValueError, OSError):
                    # same contract as the per-chunk guard below: a bad
                    # offset / ENOSPC must retire the session (tombstone
                    # + uncharge) instead of leaking it until expiry
                    self._drop_push_rx(key, st)
                    return {"ok": False}
                st["parts"] = {}
        if p["offset"] not in st["seen"]:
            st["seen"].add(p["offset"])
            st["got"] += len(p["data"])
            if st["res"] is not None:
                try:
                    st["res"].write(p["offset"], p["data"])
                except (ValueError, OSError):
                    self._drop_push_rx(key, st)
                    return {"ok": False}
            else:
                st["parts"][p["offset"]] = p["data"]
        if st["got"] >= st["total"]:
            self._push_rx.pop(key, None)
            if st["res"] is not None:
                path = "arena"
                ok = st["res"].seal()
                if not ok:
                    self._pull_gate.uncharge(st["total"])
                    # a racing session's seal winning the ledger is a
                    # successful landing from the sender's viewpoint
                    if self.store.contains(oid):
                        return {"have": True}
                    return {"ok": False}
            else:
                path = "heap"
                parts = [st["parts"][k] for k in sorted(st["parts"])]
                if not self.store.contains(oid):
                    self.store.put(oid, st["meta"], parts, st["total"])
            self._pull_gate.uncharge(st["total"])
            from ray_tpu_torch._private import memview

            memview.record_flow("push_rx", st["total"],
                                now - st.get("t0", now), path,
                                oid.hex())
            # unblock local pull waiters and register the new copy
            fut = self._pulls_inflight.get(oid.binary())
            if fut is not None and not fut.done():
                fut.set_result(True)
            try:
                await self.gcs.request(
                    "add_object_location",
                    {"object_id": oid.binary(), "node_id": self.node_id},
                )
            except Exception:
                pass
            self._dispatch_event.set()
            return {"ok": True, "assembled": True}
        return {"ok": True}

    async def rpc_push_object(self, conn: Connection, p):
        """Driver-facing: push a (locally ensured) object to peers."""
        oid = ObjectID(p["object_id"])
        if not await self._ensure_local(oid.binary(), priority=PULL_PRIO_GET):
            return {"ok": False, "error": "object not obtainable locally"}
        results = await asyncio.gather(
            *[self.push_object(oid, n) for n in p["node_ids"]
              if n != self.node_id]
        )
        return {"ok": all(results), "pushed": sum(bool(r) for r in results)}

    async def rpc_broadcast_object(self, conn: Connection, p):
        """Binary-tree broadcast: push to the head of each half of the
        target list, then delegate the rest of that half to the head —
        log2 depth, every link pushes at full chunk pipeline (ray parity:
        the reference's 1GiB-to-N-nodes broadcast benchmark shape)."""
        oid = ObjectID(p["object_id"])
        entered = time.monotonic()
        # the caller's remaining time budget rides down the tree so deep
        # hops don't spuriously time out on big broadcasts
        budget = float(p.get("timeout") or cfg.object_pull_timeout_s * 4)
        if not await self._ensure_local(oid.binary(), priority=PULL_PRIO_GET):
            return {"ok": False, "error": "object not obtainable locally"}
        targets = [n for n in p["node_ids"] if n != self.node_id]
        if not targets:
            return {"ok": True, "nodes": 0}

        async def fan(half):
            try:
                if not half:
                    return True
                head, rest = half[0], half[1:]
                if not await self.push_object(oid, head):
                    # head unreachable: flat-push the rest from here instead
                    results = await asyncio.gather(
                        *[self.push_object(oid, n) for n in rest]
                    )
                    return all(results)
                if not rest:
                    return True
                peer = await self._peer(head)
                if peer is None:
                    return False
                remaining = max(1.0, budget - (time.monotonic() - entered))
                reply = await peer.request(
                    "broadcast_object",
                    {"object_id": oid.binary(), "node_ids": rest,
                     "timeout": remaining * 0.9},
                    timeout=remaining,
                )
                return bool(reply.get("ok"))
            except Exception as e:  # noqa: BLE001 — a failed half must not
                # cancel the sibling half's in-flight pushes
                logger.warning("broadcast subtree failed: %s", e)
                return False

        mid = (len(targets) + 1) // 2
        ok = await asyncio.gather(
            fan(targets[:mid]), fan(targets[mid:]), return_exceptions=True
        )
        return {"ok": all(r is True for r in ok), "nodes": len(targets)}

    async def rpc_fetch_object(self, conn: Connection, p):
        oid = ObjectID(p["object_id"])
        buf = self.store.get(oid)
        if buf is None:
            return {"exists": False}
        try:
            total = len(buf.data)
            off = p["offset"]
            # zero-copy chunk straight off the mmap; Finalized defers the
            # buffer release until the response frame reached the transport
            out = {
                "exists": True, "total": total,
                "data": pickle.PickleBuffer(buf.data[off: off + p["chunk"]]),
            }
            if off == 0:
                out["metadata"] = buf.metadata
        except BaseException:
            buf.release()  # failed before handing off: don't leak the mmap
            raise
        return Finalized(out, buf.release)

    def rpc_delete_object(self, conn: Connection, p):
        self.store.delete(ObjectID(p["object_id"]))

    def rpc_delete_objects(self, conn: Connection, p):
        """Batched GCS free broadcast (one frame per release burst)."""
        self._delete_local(p["object_ids"])

    def _delete_local(self, oids):
        many = getattr(self.store, "delete_many", None)
        if many is not None:
            many([ObjectID(oid) for oid in oids])
            return
        for oid in oids:
            self.store.delete(ObjectID(oid))

    async def rpc_owner_call(self, conn: Connection, p):
        """Route a request to an owning core worker anywhere in the cluster
        (generic transport for the borrower protocol: borrow_add,
        wait_ref_removed, release_return_pins, reconstruct_object —
        ray: core_worker.h WaitForRefRemoved / owner RPCs)."""
        node_id, client_id = tuple(p["owner"])
        timeout = p.get("timeout", cfg.gcs_rpc_timeout_s)
        if node_id == self.node_id:
            c = self.clients.get(client_id)
            if c is None or c.closed:
                return {"owner_dead": True}
            try:
                return await c.request(p["method"], p["payload"], timeout=timeout)
            except asyncio.TimeoutError:
                return {"timeout": True}
            except Exception:
                return {"owner_dead": True}
        peer = await self._peer(node_id)
        if peer is None:
            return {"owner_dead": True}
        try:
            return await peer.request("owner_call", p, timeout=timeout + 5.0)
        except asyncio.TimeoutError:
            return {"timeout": True}
        except Exception:
            return {"owner_dead": True}

    async def rpc_report_lost_object(self, conn: Connection, p):
        """Owner detected a lost plasma copy: drop the local record and the
        GCS location so pulls don't chase a dead file
        (ray: object_recovery_manager.h object-loss handling)."""
        oid = p["object_id"]
        # forget, not delete: a loss is not a free — reconstruction will
        # re-put this oid and must not hit a pending-delete tombstone
        forget = getattr(self.store, "forget", self.store.delete)
        forget(ObjectID(oid))
        try:
            await self.gcs.request(
                "remove_object_location",
                {"object_id": oid, "node_id": self.node_id},
            )
        except Exception:
            pass
        return {}

    async def rpc_fetch_owned_routed(self, conn: Connection, p):
        """Route a borrower's small-object fetch to the owning core worker
        (simplified owner-based object directory lookup)."""
        node_id, client_id = tuple(p["owner"])
        if node_id == self.node_id:
            c = self.clients.get(client_id)
            if c is None or c.closed:
                return {"unknown": True, "owner_dead": True}
            try:
                return await c.request(
                    "fetch_owned", {"object_id": p["object_id"]}, timeout=10.0
                )
            except Exception:
                return {"unknown": True}
        peer = await self._peer(node_id)
        if peer is None:
            return {"unknown": True, "owner_dead": True}
        try:
            return await peer.request(
                "fetch_owned_routed",
                {"owner": (node_id, client_id), "object_id": p["object_id"]},
                timeout=10.0,
            )
        except Exception:
            return {"unknown": True}

    async def rpc_free_object(self, conn: Connection, p):
        try:
            await self.gcs.request("free_object", {"object_id": p["object_id"]})
        except Exception:
            pass
        return {}

    async def rpc_free_objects(self, conn: Connection, p):
        """Tick-batched frees from an owner (one frame per release burst).
        The LOCAL copy is deleted synchronously — the owner only frees at
        cluster-wide refcount zero, so this is safe, and it returns the
        pages to the store's recycling pool NOW instead of after the GCS
        round-trip (a put/free loop would otherwise never see a warm
        pool). The GCS broadcast still clears remote copies."""
        try:
            self._delete_local(p["object_ids"])
        except Exception:
            pass
        try:
            await self.gcs.request(
                "free_objects", {"object_ids": list(p["object_ids"])}
            )
        except Exception:
            pass
        return {}

    # ------------------------------------------------------------------
    # profiling (ray: dashboard reporter's py-spy stack dumps — here the
    # workers self-report via sys._current_frames)
    # ------------------------------------------------------------------
    async def rpc_node_stacks(self, conn: Connection, p):
        """Stack dumps of every live worker on this node, gathered
        CONCURRENTLY — wedged workers are the very thing this exists to
        debug; waiting 10s for each in turn would blow the caller's
        budget and drop the healthy workers' stacks too."""
        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]

        async def dump(w):
            try:
                return await w.conn.request(
                    "dump_stacks", {},
                    timeout=cfg.worker_dump_stacks_timeout_s,
                )
            except Exception:
                return {"pid": w.proc.pid, "error": "unreachable"}

        dumps = list(await asyncio.gather(*[dump(w) for w in live]))
        return {"node_id": self.node_id, "workers": dumps}

    # -- on-demand profiling fan-out (profiler.py) ---------------------
    def _profiler(self):
        svc = getattr(self, "_profiler_svc", None)
        if svc is None:
            from ray_tpu_torch._private import profiler

            svc = self._profiler_svc = profiler.ProfilerService(
                role="raylet"
            )
        return svc

    async def rpc_profile_start(self, conn: Connection, p):
        return self._profiler().start(p or {})

    async def rpc_profile_stop(self, conn: Connection, p):
        out = self._profiler().stop(p or {})
        out["node_id"] = self.node_id
        return out

    async def rpc_profile_status(self, conn: Connection, p):
        return self._profiler().status()

    async def rpc_profile_node(self, conn: Connection, p):
        """Profile every live worker on this node (plus the raylet
        itself) for one window, CONCURRENTLY — each worker runs its own
        start/sample/stop session and the results come back as one list
        (the GCS merges node lists cluster-wide)."""
        p = dict(p or {})
        duration = min(float(p.get("duration") or 5.0),
                       cfg.profiler_max_duration_s)
        p["duration"] = duration
        actor_filter = p.get("actor_id")
        if isinstance(actor_filter, str):
            try:
                actor_filter = bytes.fromhex(actor_filter)
            except ValueError:
                pass
        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]
        if actor_filter:
            live = [w for w in live if w.actor_id == actor_filter]

        async def one(w: _Worker):
            try:
                out = await w.conn.request(
                    "profile_run", p, timeout=duration + 30.0
                )
            except Exception as e:
                return {"pid": w.proc.pid, "node_id": self.node_id,
                        "error": f"{type(e).__name__}: {e}"}
            out.setdefault("node_id", self.node_id)
            return out

        jobs = [one(w) for w in live]
        include_self = bool(p.get("include_raylet", True)) \
            and not actor_filter
        if include_self:
            async def self_prof():
                out = await self._profiler().run(p)
                out["node_id"] = self.node_id
                return out

            jobs.append(self_prof())
        processes = list(await asyncio.gather(*jobs))
        return {"node_id": self.node_id, "processes": processes}

    # -- metrics plane (metrics_core.py) -------------------------------
    async def rpc_metrics_snapshot(self, conn: Connection, p):
        from ray_tpu_torch._private import metrics_core

        return metrics_core.process_snapshot(
            "raylet", {"node_id": self.node_id})

    async def rpc_metrics_node(self, conn: Connection, p):
        """This raylet's snapshot plus every live worker's, gathered
        CONCURRENTLY (one wedged worker must not stall the node scrape —
        same posture as profile_node)."""
        from ray_tpu_torch._private import metrics_core

        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]

        async def one(w: _Worker):
            try:
                out = await w.conn.request(
                    "metrics_snapshot", {},
                    timeout=cfg.metrics_scrape_timeout_s)
            except Exception as e:
                return {"pid": w.proc.pid, "node_id": self.node_id,
                        "error": f"{type(e).__name__}: {e}"}
            out.setdefault("node_id", self.node_id)
            return out

        processes = list(await asyncio.gather(*[one(w) for w in live]))
        processes.append(metrics_core.process_snapshot(
            "raylet", {"node_id": self.node_id}))
        return {"node_id": self.node_id, "processes": processes}

    # -- step observatory (steptrace.py) -------------------------------
    async def rpc_steptrace_node(self, conn: Connection, p):
        """Every live worker's steptrace ring, gathered CONCURRENTLY
        (same posture as metrics_node: one wedged worker must not stall
        the scrape). The raylet itself runs no collectives or train
        steps, so it contributes no snapshot of its own."""
        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]

        async def one(w: _Worker):
            try:
                out = await w.conn.request(
                    "steptrace_snapshot", {},
                    timeout=cfg.steptrace_scrape_timeout_s)
            except Exception as e:
                return {"pid": w.proc.pid, "node_id": self.node_id,
                        "error": f"{type(e).__name__}: {e}"}
            out.setdefault("node_id", self.node_id)
            return out

        processes = list(await asyncio.gather(*[one(w) for w in live]))
        return {"node_id": self.node_id, "processes": processes}

    # -- request observatory (reqtrace.py) -----------------------------
    async def rpc_reqtrace_node(self, conn: Connection, p):
        """Every live worker's reqtrace ring, gathered CONCURRENTLY
        (same posture as steptrace_node: one wedged worker must not
        stall the scrape). Serve proxies and replicas are actors in
        worker processes, so the node fan-out covers them; the raylet
        itself serves no requests and contributes no snapshot."""
        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]

        async def one(w: _Worker):
            try:
                out = await w.conn.request(
                    "reqtrace_snapshot", {},
                    timeout=cfg.reqtrace_scrape_timeout_s)
            except Exception as e:
                return {"pid": w.proc.pid, "node_id": self.node_id,
                        "error": f"{type(e).__name__}: {e}"}
            out.setdefault("node_id", self.node_id)
            return out

        processes = list(await asyncio.gather(*[one(w) for w in live]))
        return {"node_id": self.node_id, "processes": processes}

    # -- memory observatory (memview.py) -------------------------------
    async def rpc_memview_node(self, conn: Connection, p):
        """This node's object-plane view: every live worker's memview
        snapshot (owned tables + reference sets + flow rings), gathered
        CONCURRENTLY, plus the raylet's own snapshot carrying the store
        ledger — per-object lifecycle rows and the arena introspection
        (segment occupancy, dead byte ranges, recycling pool, per-client
        charge, overshoot attribution)."""
        from ray_tpu_torch._private import memview

        live = [
            w for w in self.all_workers.values()
            if w.conn is not None and not w.conn.closed
        ]

        async def one(w: _Worker):
            try:
                out = await w.conn.request(
                    "memview_snapshot", {},
                    timeout=cfg.memview_scrape_timeout_s)
            except Exception as e:
                return {"pid": w.proc.pid, "node_id": self.node_id,
                        "error": f"{type(e).__name__}: {e}"}
            out.setdefault("node_id", self.node_id)
            return out

        limit = (p or {}).get("limit") or 10_000

        def collect():
            # store introspection is lock-held python over up to `limit`
            # ledger rows plus flock probes of the recycling pool: run
            # it on an executor thread so a full store never stalls the
            # raylet event loop (heartbeats, dispatch, pushes).
            # getattr-guarded: the native C++ store (slab_arena=0) has
            # no introspection surface yet — the node still reports its
            # workers.
            own = memview.process_snapshot({"node_id": self.node_id,
                                            "role": "raylet"})
            intro = getattr(self.store, "arena_introspect", None)
            objs = getattr(self.store, "memview_objects", None)
            own["store"] = {
                "arena": intro() if intro is not None else None,
                "objects": objs(limit) if objs is not None else [],
            }
            return own

        workers, own = await asyncio.gather(
            asyncio.gather(*[one(w) for w in live]),
            asyncio.get_running_loop().run_in_executor(None, collect),
        )
        processes = list(workers) + [own]
        return {"node_id": self.node_id, "processes": processes}

    # ------------------------------------------------------------------
    # placement groups (bundle resources; 2-phase)
    # ------------------------------------------------------------------
    async def rpc_pg_prepare(self, conn: Connection, p):
        from ray_tpu_torch._private.common import rewrite_resources_for_pg

        # App-level idempotency: a duplicated/retried prepare for a bundle
        # we already hold must ack without reserving twice. (An rpc-level
        # idem token is wrong here: pg_cancel legitimately rolls the
        # reservation back between placement attempts, and a cached "ok"
        # would ack a later attempt without actually re-reserving.)
        if (p["pg_id"], p["bundle_index"]) in self.pg_bundles:
            return {"ok": True}
        resources = p["resources"]
        if not res_fits(resources, self.resources_available):
            return {"ok": False}
        res_sub(self.resources_available, resources)
        named = rewrite_resources_for_pg(resources, p["pg_id"], p["bundle_index"])
        self.pg_bundles[(p["pg_id"], p["bundle_index"])] = {
            "original": resources, "named": named, "committed": False,
        }
        res_add(self.resources_total, named)
        res_add(self.resources_available, named)
        self._dispatch_event.set()
        return {"ok": True}

    async def rpc_pg_commit(self, conn: Connection, p):
        b = self.pg_bundles.get((p["pg_id"], p["bundle_index"]))
        if b:
            b["committed"] = True
        return {"ok": True}

    def rpc_pg_cancel(self, conn: Connection, p):
        self._return_bundle(p["pg_id"], p["bundle_index"])

    def rpc_pg_return_if_idle(self, conn: Connection, p):
        """Repack-pass release: return the bundle ONLY if nothing uses or
        is about to use it — the GCS plans migrations from its heartbeat
        view, which can be a beat stale, so this raylet (the authority on
        its own consumption) gates the actual release. Atomic within the
        handler: the check and the return happen in one event-loop step."""
        key = (p["pg_id"], p["bundle_index"])
        b = self.pg_bundles.get(key)
        if not b:
            return {"ok": False, "reason": "unknown bundle"}
        # consumed capacity: any named resource below its full reservation
        for k, v in b["named"].items():
            if self.resources_available.get(k, 0.0) < v - 1e-9:
                return {"ok": False, "reason": "in use"}
        # demand racing in: a queued/running task naming this pg's
        # formatted resources would dispatch into the hole the migration
        # leaves behind
        named = set(b["named"])
        for qt in list(self.ready) + list(self.waiting.values()) \
                + list(self.running.values()) \
                + list(self.infeasible.values()):
            if named & set(qt.resources):
                return {"ok": False, "reason": "queued demand"}
        self._return_bundle(*key)
        return {"ok": True}

    def rpc_pg_return(self, conn: Connection, p):
        self._return_bundle(p["pg_id"], p["bundle_index"])

    def _return_bundle(self, pg_id: str, bundle_index: int):
        b = self.pg_bundles.pop((pg_id, bundle_index), None)
        if not b:
            return
        for k, v in b["named"].items():
            self.resources_total[k] = max(0.0, self.resources_total.get(k, 0.0) - v)
            self.resources_available[k] = max(
                0.0, self.resources_available.get(k, 0.0) - v
            )
            if self.resources_total.get(k, 0.0) <= 0:
                self.resources_total.pop(k, None)
                self.resources_available.pop(k, None)
        res_add(self.resources_available, b["original"])
        self._dispatch_event.set()

    # ------------------------------------------------------------------
    # misc / introspection
    # ------------------------------------------------------------------
    async def rpc_node_stats(self, conn: Connection, _):
        return {
            "node_id": self.node_id,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": len(self.all_workers),
            "num_idle_workers": sum(len(q) for q in self.idle_workers.values()),
            "queued": len(self.ready) + len(self.waiting),
            "infeasible": len(self.infeasible),
            "infeasible_shapes": [dict(qt.resources)
                                  for qt in self.infeasible.values()][:5],
            "cluster_view_totals": {
                nid[:8]: dict(n.resources_total)
                for nid, n in self.cluster_view.items()
            },
            "running": len(self.running),
            "store_used_bytes": self.store.used_bytes(),
            "counters": dict(self.counters),
        }

    async def rpc_cancel_task(self, conn: Connection, p):
        tid = p["task_id"]
        qt = self.waiting.pop(tid, None)
        if qt is None:
            qt = self.infeasible.pop(tid, None)
        if qt is None:
            qt = self.ready.remove_task(tid)
        if qt is not None:
            await self._route_to_owner(
                qt.spec.owner, "task_result",
                {"task_id": tid, "results": None, "error": "task cancelled",
                 "cancelled": True, "retriable": False, "attempt": qt.spec.attempt},
            )
            # release the spiller's resubmission liability, or a later
            # node death would resurrect the cancelled task
            await self._notify_spill_origin(qt.spec)
            return {"cancelled": True}
        running = self.running.get(tid)
        if running is not None and p.get("force") and running.worker is not None:
            running.worker.proc.terminate()
            return {"cancelled": True}
        return {"cancelled": False}
