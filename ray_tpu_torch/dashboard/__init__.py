"""Dashboard: cluster-state HTTP JSON API.

ray parity: dashboard/head.py DashboardHead + its module routes — per
SURVEY §7 the TS UI is deliberately out of scope; the dashboard starts as
the JSON API the reference modules serve (nodes, actors, tasks, jobs,
objects, placement groups, metrics, timeline, healthz). Any HTTP client
(or a Grafana JSON datasource) consumes it.

    from ray_tpu_torch.dashboard import start_dashboard
    port = start_dashboard(port=8265)          # after ray_tpu_torch.init()
    GET /api/v0/nodes  /api/v0/actors  /api/v0/tasks ...
"""

from ray_tpu_torch.dashboard.head import start_dashboard, stop_dashboard

__all__ = ["start_dashboard", "stop_dashboard"]
