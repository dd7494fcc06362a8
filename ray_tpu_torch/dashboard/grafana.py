"""Grafana dashboard factory.

ray parity: dashboard/modules/metrics/grafana_dashboard_factory.py — emit
a ready-to-import Grafana dashboard JSON wired to a Prometheus datasource
scraping this framework's ``/metrics`` endpoint (see
dashboard/prometheus.py). Panels cover the cluster built-ins plus any
user metric names passed in.
"""

from __future__ import annotations

import json
from typing import List, Optional


def _panel(panel_id: int, title: str, expr: str, y: int, x: int = 0,
           w: int = 12, h: int = 8, legend: str = "{{instance}}") -> dict:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": h, "w": w, "x": x, "y": y},
        "targets": [{
            "expr": expr,
            "legendFormat": legend,
            "refId": "A",
        }],
        "fieldConfig": {"defaults": {"custom": {"fillOpacity": 10}}},
    }


def generate_dashboard(user_metrics: Optional[List[str]] = None) -> dict:
    """Dashboard dict; json.dump it and import into Grafana."""
    panels = [
        _panel(1, "Nodes by state", "ray_tpu_node_count", 0, 0,
               legend="{{state}}"),
        _panel(2, "Tasks by state", "ray_tpu_tasks", 0, 12,
               legend="{{state}}"),
        _panel(3, "Actors by state", "ray_tpu_actors", 8, 0,
               legend="{{state}}"),
        _panel(4, "Resources available vs total",
               "ray_tpu_resources_available", 8, 12,
               legend="{{resource}} available"),
    ]
    next_id, y = 5, 16
    for name in user_metrics or []:
        panels.append(_panel(next_id, name, name, y, (next_id % 2) * 12,
                             legend="{{__name__}}"))
        if next_id % 2:
            y += 8
        next_id += 1
    return {
        "title": "ray_tpu_torch cluster",
        "uid": "ray-tpu-torch-cluster",
        "editable": True,
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource",
            "type": "datasource",
            "query": "prometheus",
        }]},
        "panels": panels,
        "schemaVersion": 39,
    }


def write_dashboard(path: str,
                    user_metrics: Optional[List[str]] = None) -> str:
    """Write the dashboard JSON next to a scrape config snippet; returns
    the dashboard path."""
    dash = generate_dashboard(user_metrics)
    with open(path, "w") as f:
        json.dump(dash, f, indent=1)
    return path
