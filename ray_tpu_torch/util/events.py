"""Structured cluster events.

ray parity: src/ray/util/event.h:130 (RayEvent — severity/label/message +
custom fields, aggregated for the dashboard) — core components (GCS node
lifecycle, actor failures, memory-monitor kills) record events into a
bounded ring on the GCS; applications add their own with
``record_event()``; ``list_events()`` and the dashboard's
``/api/v0/events`` read them newest-first with severity/source filters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")


def _cw():
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    return global_worker.core_worker


def record_event(message: str, *, severity: str = "INFO",
                 label: str = "", source: str = "user",
                 **fields) -> None:
    """Record one structured event on the cluster's event log."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")
    cw = _cw()
    cw.io.run(cw.gcs.request("add_event", {
        "severity": severity, "source": source, "label": label,
        "message": message, "fields": fields,
    }))


def list_events(*, severity: Optional[str] = None,
                source: Optional[str] = None,
                limit: int = 100) -> List[Dict]:
    """Newest-first events, optionally filtered by severity/source."""
    cw = _cw()
    return cw.io.run(cw.gcs.request("get_events", {
        "severity": severity, "source": source, "limit": limit,
    }))
