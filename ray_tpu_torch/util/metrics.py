"""Application metrics API: Counter / Gauge / Histogram.

ray parity: python/ray/util/metrics (backed by the C++ OpenCensus stack,
src/ray/stats/metric_defs.h, scraped by the per-node metrics agent).

Rebased onto the runtime metrics core (``_private/metrics_core.py``):
user metrics register in the SAME per-process registry the runtime
instruments itself with, so they ride the ``metrics_snapshot`` RPC
fan-out (worker -> raylet -> GCS) and land in the SAME Prometheus scrape
as the rpcio/raylet/GCS/object-store built-ins — one exposition surface,
no separate KV pipeline.

This also garbage-collects itself by construction: the old KV dump wrote
one ``(metric, process)`` entry per flush and kept it forever after the
process died; a live scrape only ever reflects processes that answered
it, so ``list_metrics()`` now shows live processes exactly.

    from ray_tpu_torch.util import metrics

    c = metrics.Counter("requests_total", tag_keys=("route",))
    c.inc(1, tags={"route": "/a"})

    metrics.metrics_summary()      # merged cluster view, p50/p95/p99
    metrics.prometheus_text()      # the /metrics exposition, as a string
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import metrics_core

__all__ = [
    "Counter", "Gauge", "Histogram",
    "list_metrics", "cluster_snapshot", "metrics_summary",
    "prometheus_text", "flush", "metrics_overhead_bench",
]


def _gcs_request(method: str, payload=None, timeout: Optional[float] = None):
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    cw = global_worker.core_worker
    return cw.io.run(cw.gcs.request(method, payload or {}, timeout=timeout))


def cluster_snapshot() -> dict:
    """One cluster-wide scrape via the GCS fan-out: ``{"merged": {name:
    dump}, "processes": [per-process snapshots], "errors": [...]}``."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    budget = cfg.metrics_scrape_timeout_s
    return _gcs_request("metrics_cluster", {}, timeout=budget + 15.0)


def list_metrics() -> Dict[str, List[dict]]:
    """All metric records cluster-wide, grouped by metric name — one
    record per (metric, live process), each carrying the reporting
    process's identity (role/pid/node_id). Same shape the old KV dump
    produced, sourced from a live scrape instead."""
    out: Dict[str, List[dict]] = {}
    for proc in cluster_snapshot().get("processes", ()):
        if proc.get("error"):
            continue
        ident = {k: proc.get(k) for k in
                 ("role", "pid", "node_id", "client_id") if proc.get(k)}
        for name, dump in (proc.get("metrics") or {}).items():
            out.setdefault(name, []).append(dict(dump, **ident))
    return out


def metrics_summary() -> Dict[str, dict]:
    """Merged cluster metrics, compacted: counters/gauges -> value,
    histograms -> count/sum/mean/p50/p95/p99 per labelset."""
    return metrics_core.summarize(cluster_snapshot().get("merged", {}))


def prometheus_text(merged: Optional[Dict[str, dict]] = None) -> str:
    """Prometheus text exposition of the merged cluster scrape (pass a
    pre-fetched merged snapshot to skip the fan-out)."""
    from ray_tpu_torch.dashboard.prometheus import render_metrics

    if merged is None:
        merged = cluster_snapshot().get("merged", {})
    return render_metrics(metrics_core.snapshot_records(merged))


def flush():
    """Deprecated no-op, kept for API compatibility: metrics are scraped
    live over RPC now; there is no KV pipeline to flush."""


class Metric:
    """Tag-key validation + default tags over a metrics_core Family."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        if not name:
            raise ValueError("metric name required")
        self.name = name
        self.description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._family = self._register()

    def _register(self) -> metrics_core.Family:
        raise NotImplementedError

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        unknown = set(merged) - set(self._tag_keys)
        if unknown:
            raise ValueError(
                f"unknown tag keys {sorted(unknown)}; declared {self._tag_keys}"
            )
        return merged

    def _dump(self) -> dict:
        """This process's record for the metric (back-compat helper;
        the scrape path reads the registry directly)."""
        return self._family.dump()


class Counter(Metric):
    """Monotonically increasing count (ray parity: util/metrics Counter)."""

    def _register(self):
        return metrics_core.registry().counter(self.name, self.description)

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        if value < 0:
            raise ValueError("Counter can only increase")
        self._family.labels(**self._tags(tags)).inc(value)


class Gauge(Metric):
    """Point-in-time value (ray parity: util/metrics Gauge)."""

    def _register(self):
        return metrics_core.registry().gauge(self.name, self.description)

    def set(self, value: float, tags: Optional[Dict] = None):
        self._family.labels(**self._tags(tags)).set(float(value))


class Histogram(Metric):
    """Bucketed distribution (ray parity: util/metrics Histogram).
    ``boundaries`` default to the pre-rebase ``[0.1, 1, 10, 100, 1000]``
    — user histograms hold arbitrary magnitudes, not latencies, so the
    runtime's 1us..32s log2 scale would overflow them silently."""

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        self.boundaries = sorted(boundaries or [0.1, 1, 10, 100, 1000])
        super().__init__(name, description, tag_keys)

    def _register(self):
        return metrics_core.registry().histogram(
            self.name, self.description, boundaries=self.boundaries)

    def observe(self, value: float, tags: Optional[Dict] = None):
        self._family.labels(**self._tags(tags)).record(value)


# ---------------------------------------------------------------------------
# metrics-overhead bench (the <2% acceptance gate; see bench.py's
# BENCH_METRICS_OVERHEAD lane and tests/test_metrics.py)
# ---------------------------------------------------------------------------
def measure_record_cost(n: int = 200_000) -> float:
    """Seconds per histogram record() on this host — the primitive the
    self-measured overhead gate multiplies by the observed event rate.
    Measures the REAL hot-path type (log2 latency histogram), including
    its own event accounting."""
    h = metrics_core.Histogram({}, scale=metrics_core.LATENCY)
    vals = [i * 1e-6 + 1e-7 for i in range(100)]
    t0 = time.perf_counter()
    for i in range(n):
        h.record(vals[i % 100])
    return (time.perf_counter() - t0) / n


def metrics_overhead_bench(batch: int = 200, repeat: int = 4,
                           rounds: int = 3) -> dict:
    """Measure the metrics plane's cost on the sync-task hot path, two
    ways (PAIRED, like the profiler's overhead gate — A/A throughput
    noise on a small host is ~1.8x, so the end-to-end delta is reported but the robust
    <2% gate is the self-measured number):

    - ``self_fraction``: (instrumentation events during the window x
      measured per-event cost) / window wall time — the total extra
      CPU-seconds per wall-second the instrumentation injects across the
      whole cluster. This is what ``<2%`` gates.
    - ``overhead_fraction``: throughput delta between enabled and
      disabled windows on the SAME cluster (metrics_core.set_enabled
      toggled in every process via a broadcast task), baseline paired
      (off, on, off) so pool/lease warm-up ramps cancel.
    """
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _nop():
        return b"ok"

    @ray_tpu_torch.remote
    def _set_enabled(flag):
        from ray_tpu_torch._private import metrics_core as mc

        mc.set_enabled(flag)
        return True

    def broadcast(flag: bool):
        # hit every pooled worker a few times over; raylet/GCS keep
        # recording but their per-event cost rides self_fraction anyway
        metrics_core.set_enabled(flag)
        ray_tpu_torch.get([_set_enabled.remote(flag) for _ in range(8)])

    def measure() -> float:
        best = 0.0
        for _ in range(repeat):
            t0 = time.perf_counter()
            ray_tpu_torch.get([_nop.remote() for _ in range(batch)])
            best = max(best, batch / (time.perf_counter() - t0))
        return best

    for _ in range(3):
        measure()  # warm pools/leases past the ramp

    # self-measured: events during an enabled window x per-event cost
    per_event_s = measure_record_cost()
    calls0 = cluster_snapshot().get("record_calls", 0)
    t0 = time.perf_counter()
    on_1 = measure()
    window_s = time.perf_counter() - t0
    calls1 = cluster_snapshot().get("record_calls", 0)
    events = max(0, calls1 - calls0)
    self_fraction = (events * per_event_s) / window_s if window_s else 0.0

    # paired A/B: off, on, off
    offs, ons = [], [on_1]
    for _ in range(max(1, rounds - 1)):
        broadcast(False)
        offs.append(measure())
        broadcast(True)
        ons.append(measure())
    broadcast(True)
    baseline = sum(offs) / len(offs)
    enabled = sum(ons) / len(ons)
    overhead = max(0.0, 1.0 - enabled / baseline) if baseline else 0.0
    return {
        "per_event_us": round(per_event_s * 1e6, 3),
        "events_in_window": events,
        "events_per_task": round(events / max(1, batch * repeat), 1),
        "window_s": round(window_s, 3),
        "self_fraction": round(self_fraction, 5),
        "overhead_fraction": round(overhead, 4),
        "enabled_tasks_per_s": round(enabled, 1),
        "disabled_tasks_per_s": round(baseline, 1),
    }
