"""Prometheus text exposition for the metrics surface.

ray parity: python/ray/_private/metrics_agent.py (OpenCensus → Prometheus
exporter on each node, scraped on :8080/metrics) — here one exposition
endpoint on the dashboard renders every published metric record plus the
cluster built-ins, so a stock Prometheus scrape_config pointed at the
dashboard works with no extra agent.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt_labels(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(
        f'{_sanitize(k)}="{str(v).replace(chr(92), chr(92)*2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(tags.items())
    )
    return "{" + inner + "}"


def render_metrics(records: Dict[str, List[dict]]) -> str:
    """records: ``util.metrics.list_metrics()`` output — name -> list of
    per-process dumps. Counter/gauge series sum across processes;
    histograms merge bucket counts."""
    lines: List[str] = []
    for name, dumps in sorted(records.items()):
        pname = _sanitize(name)
        mtype = dumps[0].get("type", "gauge")
        help_text = (dumps[0].get("description") or "").replace("\n", " ")
        lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {mtype}")
        if mtype in ("counter", "gauge"):
            agg: Dict[tuple, float] = {}
            for d in dumps:
                for s in d.get("series", []):
                    key = tuple(sorted(s["tags"].items()))
                    agg[key] = agg.get(key, 0.0) + float(s["value"])
            for key, v in sorted(agg.items()):
                lines.append(f"{pname}{_fmt_labels(dict(key))} {v}")
        elif mtype == "histogram":
            merged: Dict[tuple, dict] = {}
            for d in dumps:
                for s in d.get("series", []):
                    key = tuple(sorted(s["tags"].items()))
                    m = merged.setdefault(key, {
                        "boundaries": s["boundaries"],
                        "buckets": [0] * len(s["buckets"]),
                        "sum": 0.0, "count": 0,
                    })
                    if tuple(s["boundaries"]) != tuple(m["boundaries"]):
                        # summing bucket counts by index across differently
                        # bucketed declarations silently corrupts the merge,
                        # and emitting both would duplicate the labelset and
                        # invalidate the whole exposition — drop the
                        # mismatched dump and keep the endpoint scrapeable
                        logger.warning(
                            "histogram %s: conflicting bucket boundaries "
                            "across processes; dropping one dump", name)
                        continue
                    for i, c in enumerate(s["buckets"]):
                        m["buckets"][i] += c
                    m["sum"] += s["sum"]
                    m["count"] += s["count"]
            for key, m in sorted(merged.items()):
                tags = dict(key)
                cum = 0
                for bound, c in zip(m["boundaries"], m["buckets"]):
                    cum += c
                    lines.append(
                        f"{pname}_bucket"
                        f"{_fmt_labels({**tags, 'le': repr(float(bound))})} {cum}"
                    )
                cum += m["buckets"][-1]
                lines.append(
                    f"{pname}_bucket{_fmt_labels({**tags, 'le': '+Inf'})} {cum}"
                )
                lines.append(f"{pname}_sum{_fmt_labels(tags)} {m['sum']}")
                lines.append(f"{pname}_count{_fmt_labels(tags)} {m['count']}")
    return "\n".join(lines) + "\n"


def cluster_builtin_metrics() -> Dict[str, List[dict]]:
    """Synthesized cluster gauges (ray parity: metric_defs.h node/resource
    gauges the C++ core exports without user code)."""
    import time

    import ray_tpu_torch
    from ray_tpu_torch.util import state

    records: Dict[str, List[dict]] = {}

    def gauge(name, desc, series):
        records[name] = [{
            "name": name, "type": "gauge", "description": desc,
            "series": series, "ts": time.time(),
        }]

    nodes = ray_tpu_torch.nodes()
    gauge("ray_tpu_node_count", "Cluster nodes by liveness", [
        {"tags": {"state": "alive"},
         "value": float(sum(1 for n in nodes if n["alive"]))},
        {"tags": {"state": "dead"},
         "value": float(sum(1 for n in nodes if not n["alive"]))},
    ])
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    gauge("ray_tpu_resources_total", "Cluster resource capacity", [
        {"tags": {"resource": k}, "value": float(v)} for k, v in total.items()
    ])
    gauge("ray_tpu_resources_available", "Cluster resources available", [
        {"tags": {"resource": k}, "value": float(v)} for k, v in avail.items()
    ])
    try:
        summary = state.summarize_tasks()  # name -> {state: count}
        by_state: Dict[str, float] = {}
        for entry in summary.values():
            for k, v in entry.items():
                if k != "total":
                    by_state[k] = by_state.get(k, 0.0) + v
        gauge("ray_tpu_tasks", "Task events by state", [
            {"tags": {"state": k}, "value": float(v)}
            for k, v in by_state.items()
        ])
    except Exception:
        pass
    try:
        actors = state.list_actors(limit=10_000)
        by_state: Dict[str, int] = {}
        for a in actors:
            by_state[a.get("state", "?")] = by_state.get(a.get("state", "?"), 0) + 1
        gauge("ray_tpu_actors", "Actors by state", [
            {"tags": {"state": k}, "value": float(v)}
            for k, v in by_state.items()
        ])
    except Exception:
        pass
    return records
