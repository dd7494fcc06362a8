"""Process-local, dependency-free runtime metrics core.

Analog of the reference's native stats layer (ray: src/ray/stats/ — every
subsystem reports into OpenCensus views scraped per node). Here each
process owns one ``Registry`` of counters, gauges, and fixed-bucket
histograms; the RPC plane exposes a ``metrics_snapshot`` verb that dumps
it, raylets fan snapshots out to their workers, and the GCS fans out
cluster-wide and merges (sum counters/gauges, merge histogram buckets).

Design constraints, in order:

1. **record() must be cheap enough for the rpcio send path.** A latency
   histogram observation is: one module-global load (the enable flag),
   one int multiply, one ``int.bit_length()`` (the log2 bucket index —
   no search, no branch chain), one list increment, one float add.
   Measured ~0.3-0.6us on the bench box; the metrics-overhead lane in
   bench.py gates the self-measured instrumentation share at <2% of the
   sync-task hot path.
2. **No locks on the record path.** CPython's GIL makes the individual
   ``list[i] += 1`` / ``float +=`` updates effectively atomic enough for
   *statistics*: a torn read-modify-write across threads can lose an
   increment, never corrupt structure. Snapshots copy under the GIL the
   same way. (The reference accepts the same looseness in its per-thread
   OpenCensus measure buffers.)
3. **No dependencies.** Prometheus text rendering lives in
   ``ray_tpu_torch.dashboard.prometheus`` over the same dump format the old KV
   pipeline used, so one exposition path serves both runtime and user
   metrics.

Bucketing: log2 ("exponential") buckets with a fixed floor, pre-sized at
construction. Two standard scales cover the runtime:

* ``LATENCY``: 1us floor, 26 buckets -> boundaries 1us..32s (+overflow).
* ``SIZE``: 1-byte floor, 31 buckets -> boundaries 1B..1GiB (+overflow).

The bucket index for value ``v`` is ``int(v / floor).bit_length()``
clamped to the overflow bucket; bucket ``i`` therefore holds values
``< floor * 2**i`` — cumulative counts line up with Prometheus ``le``
semantics (to within the open/closed edge, irrelevant at log2 width).
User-defined histograms (``ray_tpu_torch.util.metrics``) may instead pass
explicit ``boundaries``; those take a bisect on record, which is fine
off the hot path.

Lifetime caveat: ``set_fn`` callbacks live in the process-global
registry and pin whatever they close over. That is by design for the
production topology (one raylet/GCS/replica per process — the component
IS the process); code that rebuilds a component in-process must
``registry().unregister()`` its metric names or re-register the same
labelsets (``set_fn`` on an existing child replaces the callback).
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "registry",
    "LATENCY", "SIZE", "set_enabled", "is_enabled", "record_calls",
    "merge_snapshots", "hist_quantiles", "summarize", "snapshot_records",
]

# Module-global enable flag: record paths read it once per call. Flipped
# by set_enabled() (the overhead A/B lane) or RAY_TPU_TORCH_METRICS_ENABLED=0.
_enabled = os.environ.get("RAY_TPU_TORCH_METRICS_ENABLED", "1").lower() not in (
    "0", "false", "no")
# Count of instrumentation events (inc/set/record calls) in this process:
# the self-measured overhead gate multiplies this by the measured
# per-event cost. The increment itself rides inside every timed event, so
# the measurement stays honest about its own bookkeeping.
_events = 0


def set_enabled(flag: bool):
    global _enabled
    _enabled = bool(flag)


def is_enabled() -> bool:
    return _enabled


def record_calls() -> int:
    """Total inc/set/record calls in this process since import."""
    return _events


# --- standard log2 scales ----------------------------------------------
LATENCY = ("log2", 1e-6, 26)   # 1us .. 32s
SIZE = ("log2", 1.0, 31)       # 1B .. 1GiB


def _log2_boundaries(lo: float, nb: int) -> List[float]:
    return [lo * (1 << i) for i in range(nb)]


class Counter:
    """Monotonic counter (one labelset). ``set_fn`` registers a callback
    evaluated at snapshot time instead — components that already keep
    their own monotonic tallies (raylet dispatch counters) expose them
    as proper Prometheus counters with zero hot-path cost."""

    __slots__ = ("tags", "_value", "_fn")

    def __init__(self, tags: Dict[str, str]):
        self.tags = tags
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, n: float = 1.0):
        global _events
        if not _enabled:
            return
        _events += 1
        self._value += n

    def set_fn(self, fn: Callable[[], float]):
        self._fn = fn
        return self

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return self._value
        return self._value

    def _series(self) -> dict:
        return {"tags": self.tags, "value": self.value()}


class Gauge:
    """Point-in-time value (one labelset). ``set_fn`` registers a
    callback evaluated at snapshot time instead — queue depths, pool
    sizes and breaker states cost ZERO on their hot paths this way."""

    __slots__ = ("tags", "_value", "_fn")

    def __init__(self, tags: Dict[str, str]):
        self.tags = tags
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float):
        global _events
        if not _enabled:
            return
        _events += 1
        self._value = v

    def inc(self, n: float = 1.0):
        global _events
        if not _enabled:
            return
        _events += 1
        self._value += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    def set_fn(self, fn: Callable[[], float]):
        self._fn = fn
        return self

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return self._value
        return self._value

    def _series(self) -> dict:
        return {"tags": self.tags, "value": self.value()}


class Histogram:
    """Fixed-bucket distribution (one labelset).

    ``scale`` is ``LATENCY``/``SIZE`` (log2 index via bit_length) or
    ``boundaries`` is an explicit sorted list (bisect on record — the
    user-metrics path)."""

    __slots__ = ("tags", "_counts", "_sum", "_inv_lo", "_nb", "_bounds")

    def __init__(self, tags: Dict[str, str],
                 scale: Tuple = LATENCY,
                 boundaries: Optional[Sequence[float]] = None):
        self.tags = tags
        if boundaries is not None:
            self._bounds = sorted(float(b) for b in boundaries)
            self._inv_lo = None
            self._nb = len(self._bounds)
        else:
            _, lo, nb = scale
            self._bounds = _log2_boundaries(lo, nb)
            self._inv_lo = 1.0 / lo
            self._nb = nb
        self._counts = [0] * (self._nb + 1)
        self._sum = 0.0

    def record(self, v: float):
        global _events
        if not _enabled:
            return
        _events += 1
        inv = self._inv_lo
        if inv is not None:
            i = int(v * inv).bit_length()
            if i > self._nb:
                i = self._nb
        else:
            i = bisect_left(self._bounds, v)
        self._counts[i] += 1
        self._sum += v

    # alias matching the user-facing util.metrics API
    observe = record

    def count(self) -> int:
        return sum(self._counts)

    def _series(self) -> dict:
        return {
            "tags": self.tags,
            "buckets": list(self._counts),
            "boundaries": list(self._bounds),
            "sum": self._sum,
            "count": sum(self._counts),
        }


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One metric name; children per labelset. ``labels(**tags)`` is the
    (cached) child lookup — hot call sites resolve their child once and
    keep the reference. The family itself proxies inc/set/record to the
    unlabeled child for convenience."""

    def __init__(self, name: str, mtype: str, description: str = "",
                 **kwargs):
        self.name = name
        self.type = mtype
        self.description = description
        self._kwargs = kwargs
        self._children: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()

    @property
    def default(self):
        """The unlabeled child, created on first use — a labeled-only
        family must not emit a spurious empty series."""
        return self.labels()

    def labels(self, **tags):
        key = tuple(sorted(tags.items()))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    cls = _TYPES[self.type]
                    child = cls(dict(tags), **self._kwargs) \
                        if self._kwargs else cls(dict(tags))
                    self._children[key] = child
        return child

    # convenience proxies (unlabeled child)
    def inc(self, n: float = 1.0):
        self.default.inc(n)

    def set(self, v: float):
        self.default.set(v)

    def dec(self, n: float = 1.0):
        self.default.dec(n)

    def set_fn(self, fn):
        return self.default.set_fn(fn)

    def record(self, v: float):
        self.default.record(v)

    observe = record

    def dump(self) -> dict:
        return {
            "name": self.name,
            "type": self.type,
            "description": self.description,
            "series": [c._series() for c in list(self._children.values())],
            "ts": time.time(),
        }


class Registry:
    """Per-process metric table; get-or-create by name."""

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, mtype: str, description: str,
             **kwargs) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, mtype, description, **kwargs)
                    self._families[name] = fam
        if fam.type != mtype:
            raise ValueError(
                f"metric {name!r} already registered as {fam.type}")
        return fam

    def counter(self, name: str, description: str = "") -> Family:
        return self._get(name, "counter", description)

    def gauge(self, name: str, description: str = "") -> Family:
        return self._get(name, "gauge", description)

    def histogram(self, name: str, description: str = "",
                  scale: Tuple = LATENCY,
                  boundaries: Optional[Sequence[float]] = None) -> Family:
        return self._get(name, "histogram", description, scale=scale,
                         boundaries=boundaries)

    def unregister(self, name: str):
        with self._lock:
            self._families.pop(name, None)

    def snapshot(self) -> Dict[str, dict]:
        """{name: dump} for every registered metric. Series with zero
        activity are included (a just-registered histogram is a valid,
        empty distribution)."""
        return {name: fam.dump()
                for name, fam in list(self._families.items())}


_REGISTRY: Optional[Registry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> Registry:
    """The process-wide default registry (what the runtime instruments
    and ``metrics_snapshot`` dumps)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                reg = Registry()
                try:
                    from ray_tpu_torch._private.config import GLOBAL_CONFIG

                    set_enabled(GLOBAL_CONFIG.metrics_enabled)
                except Exception:
                    pass
                _REGISTRY = reg
    return _REGISTRY


# ---------------------------------------------------------------------------
# merge + summaries (the fan-out layers and scrape surfaces use these)
# ---------------------------------------------------------------------------
def merge_snapshots(snaps: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """Fold per-process snapshots into one: counters and gauges SUM per
    labelset; histogram buckets merge elementwise when boundaries agree
    (a mismatched declaration is dropped rather than corrupting the
    merge — same posture as the Prometheus renderer)."""
    out: Dict[str, dict] = {}
    for snap in snaps:
        if not snap:
            continue
        for name, dump in snap.items():
            cur = out.get(name)
            if cur is None:
                out[name] = {
                    "name": name, "type": dump.get("type", "gauge"),
                    "description": dump.get("description", ""),
                    "series": [dict(s) for s in dump.get("series", ())],
                    "ts": dump.get("ts", 0.0),
                }
                continue
            cur["ts"] = max(cur["ts"], dump.get("ts", 0.0))
            by_tags = {tuple(sorted(s["tags"].items())): s
                       for s in cur["series"]}
            for s in dump.get("series", ()):
                key = tuple(sorted(s["tags"].items()))
                mine = by_tags.get(key)
                if mine is None:
                    cur["series"].append(dict(s))
                    continue
                if cur["type"] in ("counter", "gauge"):
                    mine["value"] = mine.get("value", 0.0) \
                        + float(s.get("value", 0.0))
                else:
                    if list(mine.get("boundaries", ())) != \
                            list(s.get("boundaries", ())):
                        continue  # mismatched declaration: drop this dump
                    mine["buckets"] = [
                        a + b for a, b in zip(mine["buckets"], s["buckets"])
                    ]
                    mine["sum"] = mine.get("sum", 0.0) + s.get("sum", 0.0)
                    mine["count"] = mine.get("count", 0) + s.get("count", 0)
    return out


def hist_quantiles(series: dict,
                   qs: Sequence[float] = (0.5, 0.95, 0.99)
                   ) -> Dict[float, float]:
    """Estimate quantiles from one histogram series' buckets (linear
    interpolation inside the landing bucket; the log2 widths keep the
    error within a factor of 2, which is what tail tracking needs)."""
    counts = series.get("buckets") or ()
    bounds = series.get("boundaries") or ()
    total = sum(counts)
    out = {q: 0.0 for q in qs}
    if total == 0:
        return out
    for q in qs:
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                hi = bounds[i] if i < len(bounds) else bounds[-1] * 2.0
                lo = bounds[i - 1] if i >= 1 else 0.0
                frac = (rank - (cum - c)) / c
                out[q] = lo + (hi - lo) * frac
                break
    return out


def summarize(snapshot: Dict[str, dict]) -> Dict[str, dict]:
    """Compact per-metric summary: counters/gauges -> value per labelset;
    histograms -> count/sum/mean/p50/p95/p99 per labelset. This is what
    the CLI table, ``util.state.metrics_summary()``, and the dashboard
    history ring serve."""
    out: Dict[str, dict] = {}
    for name, dump in sorted(snapshot.items()):
        mtype = dump.get("type", "gauge")
        entry: Dict[str, Any] = {"type": mtype,
                                 "description": dump.get("description", "")}
        series_out = []
        for s in dump.get("series", ()):
            if mtype in ("counter", "gauge"):
                series_out.append({"tags": s.get("tags", {}),
                                   "value": s.get("value", 0.0)})
            else:
                count = s.get("count", 0)
                qs = hist_quantiles(s)
                series_out.append({
                    "tags": s.get("tags", {}),
                    "count": count,
                    "sum": s.get("sum", 0.0),
                    "mean": (s.get("sum", 0.0) / count) if count else 0.0,
                    "p50": qs[0.5], "p95": qs[0.95], "p99": qs[0.99],
                })
        entry["series"] = series_out
        out[name] = entry
    return out


def snapshot_records(snapshot: Dict[str, dict]) -> Dict[str, List[dict]]:
    """Adapt a (merged) snapshot to the ``{name: [dump, ...]}`` records
    shape the Prometheus renderer consumes."""
    return {name: [dump] for name, dump in snapshot.items()}


def process_snapshot(role: str, extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The ``metrics_snapshot`` RPC payload: this process's registry dump
    plus identity for slicing and the event count for the overhead gate."""
    out: Dict[str, Any] = {
        "role": role,
        "pid": os.getpid(),
        "record_calls": _events,
        "metrics": registry().snapshot(),
    }
    if extra:
        out.update(extra)
    return out
