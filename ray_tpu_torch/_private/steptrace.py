"""Step-telemetry plane: per-step trainer + collective timing records.

The observability quartet (chaos/profiling/metrics/logs) covers the
control plane; this module lights up the training data plane. Every
process keeps ONE fixed-size ring of small tuples recording

- **collective ops** (``util.collective`` allreduce/allgather/
  reducescatter/broadcast/barrier): per-group monotonic sequence number
  plus rank-local start/end/bytes — the (group, seq) key is what lets a
  GCS-side merge line up the SAME logical collective across ranks and
  attribute arrival skew to the rank that showed up last;
- **step phases** (``train.session.step_phase("data"|"h2d"|"compute"|
  "optimizer")``) and **step boundaries** (auto-delimited at
  ``session.report()``);
- **compile events** (first-call / recompile timing per wrapped fn,
  via ``trace_jit`` cache-size sampling, and, once
  ``install_compile_listener`` ran, every nvcc build of a hand-written
  kernel in this process: ``ops/_build.py`` reports each one through
  ``record_kernel_build``) so compile storms are attributable in the same
  timeline. Eager PyTorch compiles nothing else at a first call; the
  kernels' builds are the port's first-call compiles.

Metrics-core discipline applies (see metrics_core.py): ``record_*`` is
one module-global flag load + a tuple pack + a list store — no locks
(GIL-atomic enough for telemetry; a torn write loses one record, never
corrupts structure) — and the whole plane is flag-gated
(``RAY_TPU_TORCH_STEPTRACE_ENABLED=0`` / cfg ``steptrace_enabled``) so it
costs nothing when off. The bench lane (BENCH_STEPTRACE_OVERHEAD=1)
gates the calibrated recorder share of a tight collective loop <2% and
asserts zero records when disabled.

Timestamps are ``time.time()`` (wall): arrival-skew comparisons happen
ACROSS processes, so the clocks must share an epoch — monotonic clocks
don't. Within one host that is exact; across hosts skew readings carry
NTP error, the same tradeoff the task-event timeline already makes.

The GCS folds per-rank records into rolling metrics via
``SkewAggregator``: per-rank ``collective_skew_seconds`` histograms
(each rank's lateness behind the first arrival) and a per-rank
``steptrace_straggler_score`` gauge (EWMA of "arrived last"), riding
the existing cluster scrape. ``merge_processes``/``chrome_trace`` build
the multi-rank timeline that ``util.state.train_timeline()``, the
dashboard Train tab, and ``ray_tpu_torch train timeline`` export as
Chrome-trace/Perfetto JSON.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "set_enabled", "is_enabled", "record_calls", "record_collective",
    "record_phase", "record_compile", "step_mark", "phase",
    "set_train_context", "clear_train_context", "reset", "snapshot",
    "process_snapshot", "trace_jit", "install_compile_listener",
    "record_kernel_build",
    "merge_collectives", "merge_processes", "chrome_trace",
    "SkewAggregator", "SEQ_MOD",
]

# Collective sequence numbers wrap here (32-bit): the (group, seq) join
# key stays aligned across ranks because every rank wraps at the same
# count. merge_collectives orders rows by timestamp, not seq, so a
# wrapped group still renders in arrival order.
SEQ_MOD = 1 << 32

_enabled = os.environ.get("RAY_TPU_TORCH_STEPTRACE_ENABLED", "1").lower() not in (
    "0", "false", "no")
_explicit = False  # set_enabled() was called: runtime override wins
# instrumentation event count (the bench lane's calibrated-cost x count
# estimator multiplies this, same discipline as metrics_core._events)
_events = 0

_RING_DEFAULT = 8192
_ring: List[Any] = []
_ring_size = 0
_idx = 0  # monotonic per-process write index (ring slot = _idx % size)

# train-session context: stamped onto phase/step/compile records
_rank = 0
_world = 1
_step = 0
_step_start: Optional[float] = None


def _fold_cfg():
    """Fold cfg ``steptrace_enabled`` (itself env-overridable as
    ``RAY_TPU_TORCH_steptrace_enabled``) into the flag — the documented kill
    switch must gate the record paths, not just the surfaces. Runs at
    import, again at first ring creation (so ``init(system_config=...)``
    overrides land), and from is_enabled(); an explicit set_enabled()
    always wins."""
    global _enabled
    if _explicit:
        return
    try:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.steptrace_enabled:
            _enabled = False
    except Exception:
        pass


_fold_cfg()


def set_enabled(flag: bool):
    global _enabled, _explicit
    _explicit = True  # explicit call wins over the config default
    _enabled = bool(flag)


def is_enabled() -> bool:
    _fold_cfg()
    return _enabled


def record_calls() -> int:
    """Total record_* calls in this process since import (the overhead
    lane's event count)."""
    return _events


def _ensure_ring():
    global _ring, _ring_size
    if _ring_size == 0:
        _fold_cfg()  # late system_config overrides land before any write
        size = _RING_DEFAULT
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            size = int(GLOBAL_CONFIG.steptrace_ring_size)
        except Exception:
            pass
        _ring = [None] * max(16, size)
        _ring_size = len(_ring)
    return _ring


def reset():
    """Drop all records and counters (tests / bench phases)."""
    global _ring, _ring_size, _idx, _step, _step_start
    _ring = []
    _ring_size = 0
    _idx = 0
    _step = 0
    _step_start = None


# ---------------------------------------------------------------------------
# record paths (hot: flag load + tuple pack + list store)
# ---------------------------------------------------------------------------

def _ring_slot():
    """The live ring, or None when recording is off (first call folds
    late config overrides in before anything is written)."""
    ring = _ring
    if not ring:
        ring = _ensure_ring()
        if not _enabled:
            return None
    return ring


def record_collective(group: str, seq: int, op: str, rank: int, world: int,
                      start: float, end: float, nbytes: int,
                      wire: Optional[int] = None,
                      logical: Optional[int] = None):
    """``nbytes`` is the op's tensor payload size (unchanged series);
    ``wire`` is what this rank actually moved over the transport after
    chunk/quant encoding, and ``logical`` what the same movements would
    have cost at full precision (both default to ``nbytes`` — the
    monolithic fp32 path moves what it means). logical/wire is the
    collective backend's effective-bandwidth series (EQuARX-style int8
    quantization shows up here as ~4x)."""
    global _events, _idx
    if not _enabled:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    wire = nbytes if wire is None else wire
    ring[_idx % _ring_size] = (
        "coll", _idx, group, seq % SEQ_MOD, op, rank, world, start, end,
        nbytes, wire, wire if logical is None else logical)
    _idx += 1


def record_chunk(group: str, seq: int, chunk: int, op: str, rank: int,
                 start: float, end: float, nbytes: int):
    """One chunk of a chunked collective (transport+reduce interval for
    sub-chunk ``chunk`` of the op at (group, seq)). Chunk records render
    as their own timeline lane so overlap with compute phases is visible;
    the (group, seq) skew join deliberately ignores them — the op is
    still ONE collective row, delimited by its ``record_collective``."""
    global _events, _idx
    if not _enabled:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = (
        "chunk", _idx, group, seq % SEQ_MOD, chunk, op, rank, start, end,
        nbytes)
    _idx += 1


def record_phase(name: str, start: float, end: float,
                 step: Optional[int] = None, rank: Optional[int] = None):
    global _events, _idx
    if not _enabled:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = (
        "phase", _idx, _step if step is None else step, name,
        _rank if rank is None else rank, start, end)
    _idx += 1


def record_compile(name: str, start: float, end: float, first: bool):
    global _events, _idx
    if not _enabled:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = ("compile", _idx, name, bool(first), _rank,
                               start, end)
    _idx += 1


def record_restart(cause: str, start: float, end: float, generation: int):
    """One gang recovery interval (detection -> new generation ready),
    recorded by the driver-side BackendExecutor. ``cause`` is the failure
    classification (actor_died / wedged / drain / error); ``generation``
    is the gang generation that STARTED at ``end``."""
    global _events, _idx
    if not _enabled:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = ("restart", _idx, cause, int(generation),
                               start, end)
    _idx += 1


def _record_step(step: int, start: float, end: float):
    global _events, _idx
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = ("step", _idx, step, _rank, start, end)
    _idx += 1


def step_mark(now: Optional[float] = None) -> int:
    """Close the current step interval and open the next one — called by
    ``train.session.report()`` so steps auto-delimit at the natural
    reporting boundary. Returns the step index just closed."""
    global _step, _step_start
    if not _enabled:
        return _step
    now = time.time() if now is None else now
    start = _step_start if _step_start is not None else now
    closed = _step
    _record_step(closed, start, now)
    _step += 1
    _step_start = now
    return closed


def set_train_context(rank: int, world: int):
    """Adopt a train session's identity: phase/step/compile records are
    stamped with this rank until cleared."""
    global _rank, _world, _step, _step_start
    _rank = int(rank)
    _world = int(world)
    _step = 0
    _step_start = time.time()


def clear_train_context():
    global _rank, _world, _step_start
    _rank = 0
    _world = 1
    _step_start = None


class phase:
    """Context manager recording one step-phase interval. Canonical
    phases are "data", "h2d", "compute", "optimizer" (free-form strings
    are accepted — the timeline renders whatever it gets)."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        record_phase(self.name, self._t0, time.time())
        return False


# ---------------------------------------------------------------------------
# compile-event hooks
# ---------------------------------------------------------------------------

def trace_jit(fn, name: Optional[str] = None):
    """Wrap a jitted callable so cache growth during a call is recorded
    as a compile event (first call vs recompile): jax compiles lazily at
    call time, so a call that grows ``fn._cache_size()`` spent its wall
    time tracing+compiling. Works on any object exposing ``_cache_size``
    (jax.jit since 0.4); silently degrades to a passthrough otherwise."""
    import functools

    label = name or getattr(fn, "__name__", None) or "jit"
    cache_size = getattr(fn, "_cache_size", None)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _enabled or cache_size is None:
            return fn(*args, **kwargs)
        try:
            before = cache_size()
        except Exception:
            return fn(*args, **kwargs)
        t0 = time.time()
        out = fn(*args, **kwargs)
        try:
            after = cache_size()
        except Exception:
            return out
        if after > before:
            record_compile(label, t0, time.time(), first=(before == 0))
        return out

    return wrapped


# ---------------------------------------------------------------------------
# snapshot (the steptrace_snapshot RPC payload)
# ---------------------------------------------------------------------------

_compile_listener_installed = False


def install_compile_listener():
    """From now on, record every kernel build of this process as a compile
    event (the port's counterpart of the reference's ``jax.monitoring``
    listener: there, a backend compile; here, an nvcc build by
    ``ops/_build.py``, which calls ``record_kernel_build``). Idempotent;
    imports nothing, so this module stays importable without torch."""
    global _compile_listener_installed
    _compile_listener_installed = True


def record_kernel_build(name: str, start: float, end: float):
    """One nvcc build of the kernel source ``name`` ran from ``start`` to
    ``end`` (wall clock): a compile event once the listener is installed."""
    if _compile_listener_installed:
        record_compile(name, start, end, first=True)


def snapshot() -> List[dict]:
    """The ring contents as dicts, oldest first. ``idx`` is the
    process-monotonic record index — consumers (SkewAggregator) use it
    to fold each record exactly once across repeated scrapes."""
    if _idx == 0:
        return []
    ring, size, idx = _ring, _ring_size, _idx
    if idx <= size:
        raw = ring[:idx]
    else:
        cut = idx % size
        raw = ring[cut:] + ring[:cut]
    out = []
    for rec in raw:
        if rec is None:  # torn slot mid-wrap: skip, never corrupt
            continue
        kind = rec[0]
        if kind == "coll":
            out.append({"kind": "coll", "idx": rec[1], "group": rec[2],
                        "seq": rec[3], "op": rec[4], "rank": rec[5],
                        "world": rec[6], "start": rec[7], "end": rec[8],
                        "bytes": rec[9],
                        "wire": rec[10] if len(rec) > 10 else rec[9],
                        "logical": rec[11] if len(rec) > 11 else rec[9]})
        elif kind == "chunk":
            out.append({"kind": "chunk", "idx": rec[1], "group": rec[2],
                        "seq": rec[3], "chunk": rec[4], "op": rec[5],
                        "rank": rec[6], "start": rec[7], "end": rec[8],
                        "bytes": rec[9]})
        elif kind == "phase":
            out.append({"kind": "phase", "idx": rec[1], "step": rec[2],
                        "phase": rec[3], "rank": rec[4], "start": rec[5],
                        "end": rec[6]})
        elif kind == "step":
            out.append({"kind": "step", "idx": rec[1], "step": rec[2],
                        "rank": rec[3], "start": rec[4], "end": rec[5]})
        elif kind == "compile":
            out.append({"kind": "compile", "idx": rec[1], "name": rec[2],
                        "first": rec[3], "rank": rec[4], "start": rec[5],
                        "end": rec[6]})
        elif kind == "restart":
            out.append({"kind": "restart", "idx": rec[1], "cause": rec[2],
                        "generation": rec[3], "start": rec[4],
                        "end": rec[5]})
    return out


def process_snapshot(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The ``steptrace_snapshot`` RPC payload: ring dump + identity."""
    out: Dict[str, Any] = {
        "pid": os.getpid(),
        "rank": _rank,
        "records": snapshot(),
        "dropped": max(0, _idx - _ring_size) if _ring_size else 0,
        "record_calls": _events,
    }
    if extra:
        out.update(extra)
    return out


# ---------------------------------------------------------------------------
# merge + skew math (GCS-side; pure functions, unit-testable)
# ---------------------------------------------------------------------------

# Arrivals to the SAME physical collective cannot be farther apart than
# the op's timeout (default collective_timeout_s=120) plus clock slop: a
# wider gap means the (group, seq) key was REUSED by a later run (groups
# reset seq to 0 on re-init, and the GCS log deliberately outlives runs).
# The join therefore clusters arrivals by time before attributing skew —
# no cross-rank coordination token needed.
JOIN_WINDOW_S = 300.0


def merge_collectives(records: Sequence[dict],
                      join_window_s: float = JOIN_WINDOW_S) -> List[dict]:
    """Join per-rank collective records by (group, seq) into arrival-skew
    rows, ordered by earliest arrival timestamp (NOT by seq: out-of-order
    delivery and seq wraparound must not scramble the timeline).

    Arrivals under one (group, seq) key are first CLUSTERED by time
    (consecutive-gap > ``join_window_s`` splits): a later training run
    that re-initialized the same group name restarts at seq 0, and its
    records must form their own rows instead of mis-joining with (or
    overwriting) the previous run's — cross-run "skew" would be minutes
    of wall clock, poisoning the straggler attribution.

    Each row: ``{group, seq, op, world, ranks: {rank: {start, end,
    bytes}}, skew, first_rank, last_rank, missing}`` where ``skew`` is
    the spread of arrival (start) times over the ranks PRESENT, the
    last/first ranks are the late/early arrivals, and ``missing`` lists
    ranks the join never saw (rank died, ring overwrote, scrape raced).
    Duplicate (group, seq, rank) records in a cluster keep the latest
    arrival."""
    by_key: Dict[tuple, List[dict]] = {}
    for rec in records:
        if rec.get("kind") != "coll":
            continue
        by_key.setdefault((rec["group"], rec["seq"] % SEQ_MOD),
                          []).append(rec)
    out = []
    for (group, seq), recs in by_key.items():
        recs.sort(key=lambda r: r["start"])
        clusters: List[List[dict]] = []
        for rec in recs:
            if clusters and \
                    rec["start"] - clusters[-1][-1]["start"] <= join_window_s:
                clusters[-1].append(rec)
            else:
                clusters.append([rec])
        for cluster in clusters:
            row = {"group": group, "seq": seq, "op": cluster[0]["op"],
                   "world": max(r.get("world", 0) for r in cluster),
                   "ranks": {}}
            for rec in cluster:  # sorted by start: newest-start wins
                row["ranks"][rec["rank"]] = {
                    "start": rec["start"], "end": rec["end"],
                    "bytes": rec.get("bytes", 0),
                    "wire": rec.get("wire", rec.get("bytes", 0)),
                    "logical": rec.get("logical", rec.get("bytes", 0)),
                }
            starts = {r: v["start"] for r, v in row["ranks"].items()}
            first_rank = min(starts, key=starts.get)
            last_rank = max(starts, key=starts.get)
            row["skew"] = starts[last_rank] - starts[first_rank]
            row["first_rank"] = first_rank
            row["last_rank"] = last_rank
            row["missing"] = sorted(
                set(range(row["world"])) - set(row["ranks"]))
            out.append(row)
    out.sort(key=lambda r: min(v["start"] for v in r["ranks"].values()))
    return out


def merge_records(records: Sequence[dict]) -> Dict[str, Any]:
    """Fold a flat record stream (already identity-stamped) into one
    merged view: collectives joined by (group, seq) with skew
    attribution; phases, steps, and compiles sorted by time."""
    colls: List[dict] = []
    phases: List[dict] = []
    steps: List[dict] = []
    compiles: List[dict] = []
    restarts: List[dict] = []
    chunks: List[dict] = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "coll":
            colls.append(rec)
        elif kind == "phase":
            phases.append(rec)
        elif kind == "step":
            steps.append(rec)
        elif kind == "compile":
            compiles.append(rec)
        elif kind == "restart":
            restarts.append(rec)
        elif kind == "chunk":
            chunks.append(rec)
    phases.sort(key=lambda r: r["start"])
    steps.sort(key=lambda r: r["start"])
    compiles.sort(key=lambda r: r["start"])
    restarts.sort(key=lambda r: r["start"])
    chunks.sort(key=lambda r: r["start"])
    return {
        "collectives": merge_collectives(colls),
        "phases": phases,
        "steps": steps,
        "compiles": compiles,
        "restarts": restarts,
        "chunks": chunks,
    }


def merge_processes(processes: Sequence[dict]) -> Dict[str, Any]:
    """Fold per-process steptrace snapshots into one merged view (see
    ``merge_records``; per-record identity comes from the snapshot)."""
    flat: List[dict] = []
    for proc in processes:
        if proc.get("error"):
            continue
        ident = {"node_id": proc.get("node_id"), "pid": proc.get("pid")}
        for rec in proc.get("records", ()):
            flat.append(dict(rec, **ident))
    return merge_records(flat)


def chrome_trace(merged: Dict[str, Any]) -> List[dict]:
    """Render a merged view (``merge_processes`` output) as Chrome-trace
    JSON events — loadable in Perfetto / chrome://tracing. One process
    row per rank; step/phase/collective/compile slices on named
    threads; collective slices carry the merged skew attribution in
    ``args``."""
    trace: List[dict] = []
    seen_ranks = set()

    def proc_meta(rank):
        if rank in seen_ranks:
            return
        seen_ranks.add(rank)
        trace.append({"name": "process_name", "ph": "M", "pid": rank,
                      "args": {"name": f"rank {rank}"}})

    for rec in merged.get("steps", ()):
        proc_meta(rec["rank"])
        trace.append({
            "name": f"step {rec['step']}", "cat": "step", "ph": "X",
            "ts": rec["start"] * 1e6,
            "dur": max((rec["end"] - rec["start"]) * 1e6, 1.0),
            "pid": rec["rank"], "tid": "step",
            "args": {"step": rec["step"]},
        })
    for rec in merged.get("phases", ()):
        proc_meta(rec["rank"])
        trace.append({
            "name": rec["phase"], "cat": "phase", "ph": "X",
            "ts": rec["start"] * 1e6,
            "dur": max((rec["end"] - rec["start"]) * 1e6, 1.0),
            "pid": rec["rank"], "tid": "phases",
            "args": {"step": rec["step"]},
        })
    for row in merged.get("collectives", ()):
        for rank, v in sorted(row["ranks"].items()):
            proc_meta(rank)
            trace.append({
                "name": f"{row['op']}#{row['seq']}", "cat": "collective",
                "ph": "X", "ts": v["start"] * 1e6,
                "dur": max((v["end"] - v["start"]) * 1e6, 1.0),
                "pid": rank, "tid": f"collective:{row['group']}",
                "args": {
                    "group": row["group"], "seq": row["seq"],
                    "op": row["op"], "bytes": v.get("bytes", 0),
                    "wire": v.get("wire", v.get("bytes", 0)),
                    "skew_s": row["skew"],
                    "last_rank": row["last_rank"],
                    "arrived_last": rank == row["last_rank"],
                    "missing": row["missing"],
                },
            })
    for rec in merged.get("chunks", ()):
        proc_meta(rec["rank"])
        trace.append({
            "name": f"{rec['op']}#{rec['seq']}.{rec['chunk']}",
            "cat": "chunk", "ph": "X", "ts": rec["start"] * 1e6,
            "dur": max((rec["end"] - rec["start"]) * 1e6, 1.0),
            "pid": rec["rank"], "tid": f"chunks:{rec['group']}",
            "args": {"group": rec["group"], "seq": rec["seq"],
                     "chunk": rec["chunk"], "bytes": rec.get("bytes", 0)},
        })
    for rec in merged.get("compiles", ()):
        proc_meta(rec["rank"])
        trace.append({
            "name": rec["name"], "cat": "compile", "ph": "X",
            "ts": rec["start"] * 1e6,
            "dur": max((rec["end"] - rec["start"]) * 1e6, 1.0),
            "pid": rec["rank"], "tid": "compile",
            "args": {"first_call": bool(rec.get("first"))},
        })
    restarts = merged.get("restarts", ())
    if restarts:
        trace.append({"name": "process_name", "ph": "M", "pid": -1,
                      "args": {"name": "driver (recovery)"}})
    for rec in restarts:
        trace.append({
            "name": f"restart[{rec['cause']}] -> gen {rec['generation']}",
            "cat": "restart", "ph": "X",
            "ts": rec["start"] * 1e6,
            "dur": max((rec["end"] - rec["start"]) * 1e6, 1.0),
            "pid": -1, "tid": "recovery",
            "args": {"cause": rec["cause"],
                     "generation": rec["generation"],
                     "recovery_s": rec["end"] - rec["start"]},
        })
    return trace


class SkewAggregator:
    """GCS-side rolling skew metrics over successive cluster scrapes.

    Feeds two metric families on the host registry (they ride the
    existing /metrics cluster scrape because the GCS snapshots itself):

    - ``collective_skew_seconds{rank=}``: histogram of each rank's
      arrival lateness behind that collective's FIRST arrival (rank-
      attributable tail: a persistent straggler's histogram is visibly
      fatter at p99);
    - ``steptrace_straggler_score{rank=}``: EWMA of "this rank arrived
      last" per completed collective — 0.0 never-last .. 1.0
      always-last; ~``1/world`` is the healthy uniform value.

    Dedup across scrapes: every record carries its process-monotonic
    ``idx``; records at or below the per-(node, pid) high-water mark
    were folded already. Joins incomplete at one scrape (some ranks'
    snapshots lag) are kept pending until all ``world`` ranks arrive;
    the pending table is bounded, evicting oldest-seen incomplete joins.

    The aggregator also keeps a bounded LOG of every fresh record seen
    (identity-stamped), so the merged train timeline survives the
    processes that produced it — a trainer's final scrape (the
    BackendExecutor fires one at shutdown, before the worker gang dies)
    leaves the whole run queryable by ``ray_tpu_torch train timeline`` /
    ``util.state.train_timeline()`` afterwards. In-memory only: a GCS
    restart starts a fresh log, same posture as the task-event buffer.
    """

    def __init__(self, registry=None, alpha: float = 0.1,
                 max_pending: int = 4096, log_limit: int = 65536,
                 join_window_s: float = JOIN_WINDOW_S):
        import threading
        from collections import deque

        from ray_tpu_torch._private import metrics_core

        reg = registry or metrics_core.registry()
        self.log: "deque[dict]" = deque(maxlen=log_limit)
        self.join_window_s = join_window_s
        # fold() may run on executor threads (the GCS offloads the whole
        # fold+merge off its event loop): state mutates under this lock
        self._lock = threading.Lock()
        self._scrapes = 0
        self._hist = reg.histogram(
            "collective_skew_seconds",
            "per-rank collective arrival lateness behind first arrival",
            scale=metrics_core.LATENCY)
        self._gauge = reg.gauge(
            "steptrace_straggler_score",
            "EWMA of 'rank arrived last to a collective' (0..1)")
        self._folded = reg.counter(
            "steptrace_collectives_folded_total",
            "complete (group, seq) collective joins folded into skew "
            "metrics")
        self.alpha = alpha
        self.max_pending = max_pending
        # (node_id, pid) -> (max record idx folded, last scrape seen)
        self._seen: Dict[tuple, tuple] = {}
        self._pending: Dict[tuple, dict] = {}  # (group, seq) -> row
        self._scores: Dict[int, float] = {}    # rank -> EWMA

    def fold(self, processes: Sequence[dict]) -> int:
        """Ingest one cluster scrape: append every record NOT yet seen
        from its process to the log, fold the fresh collective records
        into the skew metrics. Returns how many complete collective
        joins were folded into the metrics this call. Thread-safe (the
        GCS runs it on executor threads)."""
        with self._lock:
            return self._fold_locked(processes)

    def _fold_locked(self, processes: Sequence[dict]) -> int:
        self._scrapes += 1
        fresh: List[dict] = []
        for proc in processes:
            if proc.get("error"):
                continue
            key = (proc.get("node_id"), proc.get("pid"))
            ident = {"node_id": proc.get("node_id"),
                     "pid": proc.get("pid")}
            mark, _ = self._seen.get(key, (-1, 0))
            recs = proc.get("records", ())
            # a process's top ring idx only ever grows while it lives; a
            # snapshot whose top sits BELOW the high-water mark is a NEW
            # process that recycled a dead worker's pid — start it fresh
            # instead of discarding its whole ring as already-folded
            snap_top = max((r.get("idx", 0) for r in recs), default=None)
            if snap_top is not None and snap_top < mark:
                mark = -1
            top = mark
            for rec in recs:
                idx = rec.get("idx", 0)
                if idx <= mark:
                    continue
                top = max(top, idx)
                rec = dict(rec, **ident)
                self.log.append(rec)
                if rec.get("kind") == "coll":
                    fresh.append(rec)
            self._seen[key] = (top, self._scrapes)
        # high-water marks for processes gone from many scrapes serve no
        # dedup purpose (their rings died with them) — drop them so
        # worker churn can't grow _seen without bound
        if len(self._seen) > 1024:
            floor = self._scrapes - 64
            for key in [k for k, (_, s) in self._seen.items()
                        if s < floor]:
                del self._seen[key]
        for rec in fresh:
            key = (rec["group"], rec["seq"] % SEQ_MOD)
            row = self._pending.get(key)
            if row is None:
                row = self._pending[key] = {
                    "world": rec.get("world", 0), "ranks": {},
                }
            elif row["ranks"] and rec["start"] - min(row["ranks"].values()) \
                    > self.join_window_s:
                # a (group, seq) key reused by a LATER run (groups reset
                # seq on re-init): the stale pending join can never
                # complete honestly — discard it rather than let the new
                # run's arrivals "complete" it with minutes of fake skew
                row = self._pending[key] = {
                    "world": rec.get("world", 0), "ranks": {},
                }
            elif row["ranks"] and min(row["ranks"].values()) - rec["start"] \
                    > self.join_window_s:
                continue  # stale straggler record from a previous run
            row["world"] = max(row["world"], rec.get("world", 0))
            row["ranks"][rec["rank"]] = rec["start"]
        done = 0
        for key in list(self._pending):
            row = self._pending[key]
            if row["world"] <= 0 or len(row["ranks"]) < row["world"]:
                continue
            del self._pending[key]
            done += 1
            starts = row["ranks"]
            t0 = min(starts.values())
            last = max(starts, key=starts.get)
            for rank, start in starts.items():
                self._hist.labels(rank=str(rank)).record(start - t0)
                prev = self._scores.get(rank, 0.0)
                score = prev + self.alpha * (
                    (1.0 if rank == last else 0.0) - prev)
                self._scores[rank] = score
                self._gauge.labels(rank=str(rank)).set(round(score, 6))
        if done:
            self._folded.inc(done)
        if len(self._pending) > self.max_pending:
            for key in list(self._pending)[
                    : len(self._pending) - self.max_pending]:
                del self._pending[key]
        return done

    def scores(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._scores)

    def records(self) -> List[dict]:
        """Every record the aggregator has ever accepted (bounded log,
        newest ``log_limit`` entries) — the merged-timeline source that
        outlives the worker processes."""
        with self._lock:
            return list(self.log)

    def fold_and_merge(self, processes: Sequence[dict],
                       limit: int = 0) -> Dict[str, Any]:
        """One scrape's whole CPU-bound path — fold the snapshots, copy
        the (possibly 65k-entry) log, and merge it — as a single call the
        GCS can push onto an executor thread, so none of it stalls the
        event loop. ``limit`` caps the merge to the newest N records for
        cheap polling surfaces."""
        with self._lock:
            self._fold_locked(processes)
            records = list(self.log)
            # snapshot under the lock: a concurrent fold on another
            # executor thread may be inserting a rank's first score
            scores = {str(r): s for r, s in sorted(self._scores.items())}
        if limit and len(records) > limit:
            records = records[-int(limit):]
        merged = merge_records(records)
        merged["straggler_scores"] = scores
        return merged
