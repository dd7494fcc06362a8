"""Request observatory: per-request serve tracing + phase attribution.

The six planes so far (chaos/profiling/metrics/logs/steptrace/memview)
watch the control plane, the training loop, and the object plane; this
one lights up the SERVE data plane — answering "where did a slow request
spend its time" (proxy? routing? replica queue? batch window? execute?
serialize? stream?) with per-deployment per-replica attribution. Every
process keeps ONE fixed-size ring of small tuples recording

- **phase spans**: the proxy mints a request id per HTTP/handle call and
  threads it through the handle→replica RPC envelope; every hop records
  its phase against that id — ``ingress`` (proxy receive + route match),
  ``route`` (chosen replica + the router's inflight snapshot at decision
  time), ``queue`` (handle send → user code start, the replica-side
  wait), ``batch_wait`` (submit → flush inside ``serve.batch``, with
  batch key + size), ``execute`` (user code), ``serialize`` (proxy
  response construction);
- **marks**: streaming ``first_byte`` / ``last_byte`` timestamps, so
  TTFT is a first-class number instead of a log grep.

Metrics-core discipline applies (see metrics_core.py): ``record_*`` is
one module-global flag load + a tuple pack + a list store — no locks
(GIL-atomic enough for telemetry; a torn write loses one record, never
corrupts structure) — and the whole plane is flag-gated
(``RAY_TPU_TORCH_REQTRACE_ENABLED=0`` / cfg ``reqtrace_enabled``) so it costs
nothing when off. The bench lane (BENCH_REQTRACE_OVERHEAD=1) gates the
calibrated per-request record cost <2% of a proxy round trip and
asserts zero ring records when disabled.

Timestamps are ``time.time()`` (wall): queue-wait spans START on the
caller's clock (the handle stamps the send time into the RPC envelope)
and END on the replica's, so the clocks must share an epoch — the same
tradeoff steptrace makes for cross-rank skew. Within one host that is
exact; across hosts the queue reading carries NTP error.

The GCS folds per-process records into rolling metrics via
``RequestAggregator``: ``serve_request_phase_seconds{app,deployment,
phase}`` and ``serve_request_ttft_seconds{app,deployment}`` histograms
riding the existing /metrics cluster scrape (p50/p95/p99 come free from
the metrics core) — exactly the signals the admission-control and
autoscaling ROADMAP levers will consume. ``merge_processes`` joins
proxy+replica records by request id into per-request phase breakdowns,
per-deployment summaries, per-replica phase profiles, and **skew
verdicts** ("replica r3 is slow, and it's queue wait, not execute");
``chrome_trace`` renders the merged view as Perfetto JSON, one track
per replica, for ``ray_tpu_torch serve timeline`` /
``util.state.request_timeline()`` / the dashboard Serve tab.
"""

from __future__ import annotations

import contextvars
import os
import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "set_enabled", "is_enabled", "record_calls", "reset",
    "new_request_id", "record_span", "record_mark", "CURRENT",
    "snapshot", "process_snapshot",
    "merge_requests", "merge_processes", "deployment_summary",
    "replica_breakdown", "skew_verdicts", "chrome_trace",
    "RequestAggregator",
]

_enabled = os.environ.get("RAY_TPU_TORCH_REQTRACE_ENABLED", "1").lower() not in (
    "0", "false", "no")
_explicit = False  # set_enabled() was called: runtime override wins
# instrumentation event count (the bench lane's calibrated-cost x count
# estimator multiplies this, same discipline as steptrace._events)
_events = 0

_RING_DEFAULT = 8192
_ring: List[Any] = []
_ring_size = 0
_idx = 0  # monotonic per-process write index (ring slot = _idx % size)
# process identity for the aggregator's exactly-once fold: a recycled
# pid whose new ring already wrote PAST the dead process's high-water
# mark is undetectable from idx alone — the epoch disambiguates
_EPOCH = os.urandom(4).hex()

# per-request identity for code that runs UNDER a request but doesn't see
# the RPC envelope (serve.batch flushes, nested helpers): the replica sets
# (rid, app, deployment, replica) around user-code invocation. Contextvars
# propagate through asyncio awaits, which is exactly the scope needed.
CURRENT: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "reqtrace_current", default=None)


def _fold_cfg():
    """Fold cfg ``reqtrace_enabled`` (itself env-overridable as
    ``RAY_TPU_TORCH_reqtrace_enabled``) into the flag — the documented kill
    switch must gate the record paths, not just the surfaces. An
    explicit set_enabled() always wins."""
    global _enabled
    if _explicit:
        return
    try:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.reqtrace_enabled:
            _enabled = False
    except Exception:
        pass


_fold_cfg()


def set_enabled(flag: bool):
    global _enabled, _explicit
    _explicit = True
    _enabled = bool(flag)


def is_enabled() -> bool:
    _fold_cfg()
    return _enabled


def record_calls() -> int:
    """Total record_* calls in this process since import (the overhead
    lane's event count)."""
    return _events


def reset():
    """Drop all records and counters (tests / bench phases)."""
    global _ring, _ring_size, _idx, _events
    _ring = []
    _ring_size = 0
    _idx = 0
    _events = 0


def new_request_id() -> str:
    """Mint a request id (16 hex chars): the proxy mints one per HTTP
    call, the handle mints one per direct ``.remote()`` that arrived
    without one — every hop's records join on it."""
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# record paths (hot: flag load + tuple pack + list store)
# ---------------------------------------------------------------------------

def _ensure_ring():
    global _ring, _ring_size
    if _ring_size == 0:
        _fold_cfg()  # late system_config overrides land before any write
        size = _RING_DEFAULT
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            size = int(GLOBAL_CONFIG.reqtrace_ring_size)
        except Exception:
            pass
        _ring = [None] * max(16, size)
        _ring_size = len(_ring)
    return _ring


def _ring_slot():
    ring = _ring
    if not ring:
        ring = _ensure_ring()
        if not _enabled:
            return None
    return ring


def record_span(rid: str, phase: str, start: float, end: float,
                app: str = "", deployment: str = "", replica: str = "",
                detail: Optional[dict] = None):
    global _events, _idx
    if not _enabled or not rid:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = ("span", _idx, rid, phase, app, deployment,
                               replica, start, end, detail)
    _idx += 1


def record_mark(rid: str, name: str, ts: float, app: str = "",
                deployment: str = "", replica: str = ""):
    global _events, _idx
    if not _enabled or not rid:
        return
    ring = _ring_slot()
    if ring is None:
        return
    _events += 1
    ring[_idx % _ring_size] = ("mark", _idx, rid, name, app, deployment,
                               replica, ts)
    _idx += 1


# ---------------------------------------------------------------------------
# snapshot (the reqtrace_snapshot RPC payload)
# ---------------------------------------------------------------------------

def snapshot() -> List[dict]:
    """The ring contents as dicts, oldest first. ``idx`` is the
    process-monotonic record index — consumers (RequestAggregator) use
    it to fold each record exactly once across repeated scrapes."""
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
        if rec[0] == "span":
            out.append({"kind": "span", "idx": rec[1], "rid": rec[2],
                        "phase": rec[3], "app": rec[4],
                        "deployment": rec[5], "replica": rec[6],
                        "start": rec[7], "end": rec[8],
                        "detail": rec[9]})
        elif rec[0] == "mark":
            out.append({"kind": "mark", "idx": rec[1], "rid": rec[2],
                        "name": rec[3], "app": rec[4],
                        "deployment": rec[5], "replica": rec[6],
                        "ts": rec[7]})
    return out


def process_snapshot(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The ``reqtrace_snapshot`` RPC payload: ring dump + identity +
    drop accounting."""
    out: Dict[str, Any] = {
        "pid": os.getpid(),
        "epoch": _EPOCH,
        "records": snapshot(),
        "dropped": max(0, _idx - _ring_size) if _ring_size else 0,
        "record_calls": _events,
    }
    if extra:
        out.update(extra)
    return out


# ---------------------------------------------------------------------------
# merge (GCS-side; pure functions, unit-testable)
# ---------------------------------------------------------------------------

def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def merge_requests(records: Sequence[dict]) -> List[dict]:
    """Join per-process span/mark records by request id into one row per
    request, ordered by start time.

    Each row: ``{rid, app, deployment, replica, start, end, total,
    phases: [{phase, start, end, dur, replica, detail}], marks:
    {name: ts}, ttft, missing}`` — ``replica`` is the one the replica-
    side spans ran on (falling back to the route decision), ``ttft`` is
    first_byte − request start when a first_byte mark exists, and
    ``missing`` is "replica" when the route span names a replica but no
    replica-side span ever arrived (replica died, ring overwrote, scrape
    raced — the row is still rendered from the proxy's half)."""
    by_rid: Dict[str, dict] = {}
    for rec in records:
        rid = rec.get("rid")
        if not rid:
            continue
        row = by_rid.get(rid)
        if row is None:
            row = by_rid[rid] = {"rid": rid, "app": "", "deployment": "",
                                 "replica": "", "phases": [], "marks": {}}
        if rec.get("kind") == "span":
            row["phases"].append({
                "phase": rec["phase"], "start": rec["start"],
                "end": rec["end"],
                "dur": max(0.0, rec["end"] - rec["start"]),
                "replica": rec.get("replica") or "",
                "detail": rec.get("detail"),
            })
        elif rec.get("kind") == "mark":
            row["marks"][rec["name"]] = rec["ts"]
        for key in ("app", "deployment"):
            if not row[key] and rec.get(key):
                row[key] = rec[key]
    out = []
    _REPLICA_SIDE = ("queue", "execute", "batch_wait")
    for row in by_rid.values():
        if not row["phases"] and not row["marks"]:
            continue
        # dedup retried/re-scraped identical spans (same phase+start)
        seen = set()
        phases = []
        for ph in sorted(row["phases"], key=lambda p: p["start"]):
            key = (ph["phase"], ph["replica"], round(ph["start"], 6))
            if key in seen:
                continue
            seen.add(key)
            phases.append(ph)
        row["phases"] = phases
        starts = [p["start"] for p in phases]
        ends = [p["end"] for p in phases]
        row["start"] = min(starts) if starts else min(
            row["marks"].values())
        row["end"] = max(ends + list(row["marks"].values())) \
            if (ends or row["marks"]) else row["start"]
        row["total"] = row["end"] - row["start"]
        # the replica that served it: replica-side spans first, else the
        # route decision's choice
        replica = next((p["replica"] for p in phases
                        if p["phase"] in _REPLICA_SIDE and p["replica"]),
                       "")
        routed = next((p for p in phases if p["phase"] == "route"), None)
        if not replica and routed:
            replica = (routed.get("detail") or {}).get("replica", "") \
                or routed.get("replica", "")
        row["replica"] = replica
        fb = row["marks"].get("first_byte")
        row["ttft"] = (fb - row["start"]) if fb is not None else None
        has_replica_side = any(p["phase"] in _REPLICA_SIDE for p in phases)
        row["missing"] = "replica" if (routed and not has_replica_side) \
            else None
        out.append(row)
    out.sort(key=lambda r: r["start"])
    return out


def _phase_totals(rows: Sequence[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in rows:
        for ph in row["phases"]:
            out[ph["phase"]] = out.get(ph["phase"], 0.0) + ph["dur"]
    return out


def deployment_summary(rows: Sequence[dict]) -> List[dict]:
    """Per-(app, deployment) latency summary: request count, total
    p50/p95/p99, TTFT p50/p95/p99 (streaming requests only), and mean
    seconds per phase — the table ``ray_tpu_torch serve requests`` prints."""
    groups: Dict[tuple, List[dict]] = {}
    for row in rows:
        groups.setdefault((row["app"], row["deployment"]), []).append(row)
    out = []
    for (app, deployment), rs in groups.items():
        totals = sorted(r["total"] for r in rs)
        ttfts = sorted(r["ttft"] for r in rs if r["ttft"] is not None)
        phase_tot = _phase_totals(rs)
        out.append({
            "app": app, "deployment": deployment, "count": len(rs),
            "p50": _pct(totals, 0.50), "p95": _pct(totals, 0.95),
            "p99": _pct(totals, 0.99),
            "ttft_p50": _pct(ttfts, 0.50) if ttfts else None,
            "ttft_p95": _pct(ttfts, 0.95) if ttfts else None,
            "ttft_p99": _pct(ttfts, 0.99) if ttfts else None,
            "phase_mean": {ph: tot / len(rs)
                           for ph, tot in sorted(phase_tot.items())},
            "missing_replica_side": sum(1 for r in rs if r["missing"]),
        })
    out.sort(key=lambda e: (e["app"], e["deployment"]))
    return out


def replica_breakdown(rows: Sequence[dict]) -> List[dict]:
    """Per-(app, deployment, replica) phase profile: request count and
    mean seconds per phase — the input to ``skew_verdicts``."""
    groups: Dict[tuple, List[dict]] = {}
    for row in rows:
        if not row["replica"]:
            continue
        groups.setdefault(
            (row["app"], row["deployment"], row["replica"]), []
        ).append(row)
    out = []
    for (app, deployment, replica), rs in groups.items():
        phase_tot = _phase_totals(rs)
        totals = sorted(r["total"] for r in rs)
        out.append({
            "app": app, "deployment": deployment, "replica": replica,
            "count": len(rs),
            "mean_total": sum(totals) / len(totals),
            "p95": _pct(totals, 0.95),
            "phase_mean": {ph: tot / len(rs)
                           for ph, tot in sorted(phase_tot.items())},
        })
    out.sort(key=lambda e: (e["app"], e["deployment"], e["replica"]))
    return out


def skew_verdicts(breakdown: Sequence[dict], min_requests: int = 5,
                  factor: float = 1.5) -> List[dict]:
    """Replica skew attribution: for every deployment with >=2 replicas
    that each served >= ``min_requests``, compare each replica's mean
    total latency against the MEDIAN of its peers; a replica beyond
    ``factor``x earns a verdict naming the phase that contributes the
    largest share of the excess — "replica r3 is slow, and it's queue
    wait, not execute"."""
    groups: Dict[tuple, List[dict]] = {}
    for entry in breakdown:
        if entry["count"] >= min_requests:
            groups.setdefault((entry["app"], entry["deployment"]),
                              []).append(entry)
    verdicts = []
    for (app, deployment), entries in groups.items():
        if len(entries) < 2:
            continue
        for entry in entries:
            peers = [e for e in entries if e is not entry]
            peer_totals = sorted(e["mean_total"] for e in peers)
            peer_median = peer_totals[len(peer_totals) // 2]
            if peer_median <= 0 or \
                    entry["mean_total"] < factor * peer_median:
                continue
            # which phase explains the excess: largest mean delta vs the
            # peers' mean for that phase
            deltas = {}
            for ph, mean in entry["phase_mean"].items():
                peer_mean = sum(e["phase_mean"].get(ph, 0.0)
                                for e in peers) / len(peers)
                deltas[ph] = mean - peer_mean
            dominant = max(deltas, key=deltas.get) if deltas else "?"
            verdicts.append({
                "kind": "slow_replica",
                "app": app, "deployment": deployment,
                "replica": entry["replica"],
                "mean_total": entry["mean_total"],
                "peer_median": peer_median,
                "ratio": entry["mean_total"] / peer_median,
                "dominant_phase": dominant,
                "phase_delta": round(deltas.get(dominant, 0.0), 6),
                "detail": (
                    f"replica {entry['replica']} mean "
                    f"{entry['mean_total'] * 1e3:.1f}ms vs peer median "
                    f"{peer_median * 1e3:.1f}ms "
                    f"({entry['mean_total'] / peer_median:.1f}x) — "
                    f"dominated by {dominant} "
                    f"(+{deltas.get(dominant, 0.0) * 1e3:.1f}ms/req)"),
            })
    verdicts.sort(key=lambda v: -v["ratio"])
    return verdicts


def merge_records(records: Sequence[dict]) -> Dict[str, Any]:
    """Fold a flat record stream into the merged serve view: per-request
    rows joined by rid, per-deployment summaries, per-replica phase
    profiles, and slow-replica skew verdicts."""
    rows = merge_requests(records)
    breakdown = replica_breakdown(rows)
    return {
        "requests": rows,
        "deployments": deployment_summary(rows),
        "replicas": breakdown,
        "verdicts": skew_verdicts(breakdown),
    }


def merge_processes(processes: Sequence[dict]) -> Dict[str, Any]:
    """Fold per-process reqtrace snapshots into one merged view."""
    flat: List[dict] = []
    for proc in processes:
        if proc.get("error"):
            continue
        flat.extend(proc.get("records", ()))
    return merge_records(flat)


def chrome_trace(merged: Dict[str, Any]) -> List[dict]:
    """Render a merged view as Chrome-trace JSON — loadable in Perfetto /
    chrome://tracing. One process row per replica (plus one for the
    proxy-side phases), phase slices on per-phase tracks, each slice
    stamped with its request id so a slow request reads end to end."""
    trace: List[dict] = []
    pids: Dict[str, int] = {}
    _PROXY_SIDE = ("ingress", "route", "serialize")

    def pid_of(name: str) -> int:
        pid = pids.get(name)
        if pid is None:
            pid = pids[name] = len(pids)
            trace.append({"name": "process_name", "ph": "M", "pid": pid,
                          "args": {"name": name}})
        return pid

    for row in merged.get("requests", ()):
        dep = f"{row['app']}/{row['deployment']}".strip("/") or "serve"
        for ph in row["phases"]:
            if ph["phase"] in _PROXY_SIDE:
                track = f"proxy ({dep})"
            else:
                track = f"replica {ph['replica'] or row['replica'] or '?'}"
            args = {"rid": row["rid"], "deployment": dep}
            if ph.get("detail"):
                args.update(ph["detail"])
            trace.append({
                "name": ph["phase"], "cat": "serve", "ph": "X",
                "ts": ph["start"] * 1e6,
                "dur": max(ph["dur"] * 1e6, 1.0),
                "pid": pid_of(track), "tid": ph["phase"],
                "args": args,
            })
        for name, ts in row["marks"].items():
            trace.append({
                "name": name, "cat": "serve", "ph": "i",
                "ts": ts * 1e6, "s": "p",
                "pid": pid_of(f"replica {row['replica'] or '?'}"
                              if row["replica"] else f"proxy ({dep})"),
                "tid": "stream",
                "args": {"rid": row["rid"]},
            })
    return trace


class RequestAggregator:
    """GCS-side rolling serve-request metrics over successive cluster
    scrapes, plus the bounded record log the merged request view renders
    from (so the timeline survives the proxies/replicas that produced
    it — same posture as steptrace.SkewAggregator).

    Metric families on the host registry (riding the existing /metrics
    cluster scrape because the GCS snapshots itself):

    - ``serve_request_phase_seconds{app,deployment,phase}``: histogram
      of per-phase span durations — p50/p95/p99 per phase per
      deployment, the autoscaling/admission signals;
    - ``serve_request_ttft_seconds{app,deployment}``: streaming time to
      first byte (first_byte mark − request start).

    Dedup across scrapes: every record carries its process-monotonic
    ``idx``; records at or below the per-(node, pid) high-water mark
    were folded already.
    """

    def __init__(self, registry=None, log_limit: int = 65536):
        import threading
        from collections import OrderedDict, deque

        from ray_tpu_torch._private import metrics_core

        reg = registry or metrics_core.registry()
        self.log: "deque[dict]" = deque(maxlen=log_limit)
        self._lock = threading.Lock()
        self._scrapes = 0
        self._hist = reg.histogram(
            "serve_request_phase_seconds",
            "serve request phase span durations, by deployment and phase",
            scale=metrics_core.LATENCY)
        self._ttft = reg.histogram(
            "serve_request_ttft_seconds",
            "streaming serve requests: time to first byte",
            scale=metrics_core.LATENCY)
        self._folded = reg.counter(
            "reqtrace_spans_folded_total",
            "serve request phase spans folded into metrics")
        # (node_id, pid) -> (max idx folded, last scrape seen, epoch)
        self._seen: Dict[tuple, tuple] = {}
        # rid -> earliest span start (TTFT pairing), bounded FIFO
        self._starts: "OrderedDict[str, float]" = OrderedDict()

    def fold(self, processes: Sequence[dict]) -> int:
        with self._lock:
            return self._fold_locked(processes)

    def _fold_locked(self, processes: Sequence[dict]) -> int:
        self._scrapes += 1
        folded = 0
        for proc in processes:
            if proc.get("error"):
                continue
            key = (proc.get("node_id"), proc.get("pid"))
            mark, _, seen_epoch = self._seen.get(key, (-1, 0, None))
            epoch = proc.get("epoch")
            recs = proc.get("records", ())
            # pid recycling: a NEW process behind an old (node, pid) key
            # must fold from scratch, not be discarded as already-folded.
            # The epoch token detects it exactly; the top-idx-below-mark
            # heuristic is kept for snapshots without one, but misses a
            # recycled process that already wrote past the dead one's mark
            snap_top = max((r.get("idx", 0) for r in recs), default=None)
            if (epoch is not None and epoch != seen_epoch
                    and seen_epoch is not None) or \
                    (snap_top is not None and snap_top < mark):
                mark = -1
            top = mark
            for rec in recs:
                idx = rec.get("idx", 0)
                if idx <= mark:
                    continue
                top = max(top, idx)
                self.log.append(rec)
                folded += self._fold_record(rec)
            self._seen[key] = (top, self._scrapes, epoch)
        if len(self._seen) > 1024:
            floor = self._scrapes - 64
            for key in [k for k, (_, s) in self._seen.items()
                        if s < floor]:
                del self._seen[key]
        if folded:
            self._folded.inc(folded)
        return folded

    def _fold_record(self, rec: dict) -> int:
        rid = rec.get("rid") or ""
        if rec.get("kind") == "span":
            self._hist.labels(
                app=rec.get("app") or "?",
                deployment=rec.get("deployment") or "?",
                phase=rec.get("phase") or "?",
            ).record(max(0.0, rec.get("end", 0.0) - rec.get("start", 0.0)))
            start = rec.get("start", 0.0)
            prev = self._starts.get(rid)
            if prev is None or start < prev:
                self._starts[rid] = start
                self._starts.move_to_end(rid)
            while len(self._starts) > 4096:
                self._starts.popitem(last=False)
            return 1
        if rec.get("kind") == "mark" and rec.get("name") == "first_byte":
            start = self._starts.get(rid)
            if start is not None:
                self._ttft.labels(
                    app=rec.get("app") or "?",
                    deployment=rec.get("deployment") or "?",
                ).record(max(0.0, rec.get("ts", 0.0) - start))
            return 1
        return 0

    def records(self) -> List[dict]:
        with self._lock:
            return list(self.log)

    def fold_and_merge(self, processes: Sequence[dict],
                       limit: int = 0) -> Dict[str, Any]:
        """One scrape's whole CPU-bound path — fold the snapshots, copy
        the bounded log, merge it — as a single call the GCS pushes onto
        an executor thread. ``limit`` caps the merge to the newest N
        records for cheap polling surfaces."""
        with self._lock:
            self._fold_locked(processes)
            records = list(self.log)
        if limit and len(records) > limit:
            records = records[-int(limit):]
        return merge_records(records)
