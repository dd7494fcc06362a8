"""Usage stats (reference parity: python/ray/_private/usage/usage_lib.py
:166 UsageStatsToReport, :190 collection, :823 the reporting loop).

The reference phones a usage payload home unless RAY_USAGE_STATS_ENABLED=0.
This build is for offline images, so the DEFAULT is inverted: nothing
ever leaves the machine. Collection still runs (it feeds the dashboard
and gives operators a local snapshot at
``<session_dir>/usage_stats.json``), and a reporting hook exists for
deployments that want to ship the payload somewhere themselves.

Env switches (reference names honored):
- ``RAY_TPU_TORCH_USAGE_STATS_ENABLED`` / ``RAY_USAGE_STATS_ENABLED``:
  "0" disables even local collection.
- ``RAY_TPU_TORCH_USAGE_STATS_REPORT_URL``: if set AND reachable, the payload
  POSTs there (operator-owned endpoint; never a vendor default).
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Any, Dict, Optional


def usage_stats_enabled() -> bool:
    for var in ("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "RAY_USAGE_STATS_ENABLED"):
        v = os.environ.get(var)
        if v is not None:
            return v not in ("0", "false", "False")
    return True  # local-only collection is on by default


def collect_usage_stats(gcs_request=None) -> Dict[str, Any]:
    """One usage snapshot (reference: UsageStatsToReport fields that make
    sense without a vendor endpoint)."""
    import ray_tpu_torch

    payload: Dict[str, Any] = {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "collected_at": time.time(),
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "arch": platform.machine(),
    }
    try:
        # the installed torch's version, read without importing torch
        from importlib.metadata import version

        payload["torch_version"] = version("torch")
    except Exception:
        pass
    try:
        if ray_tpu_torch.is_initialized():
            nodes = ray_tpu_torch.nodes()
            payload["total_num_nodes"] = sum(1 for n in nodes if n["alive"])
            res = ray_tpu_torch.cluster_resources()
            payload["total_num_cpus"] = res.get("CPU")
            payload["total_num_gpus"] = res.get("GPU")
    except Exception:
        pass
    # library usages (reference: record_library_usage telemetry)
    import sys

    libs = [name for name in ("ray_tpu_torch.serve", "ray_tpu_torch.tune",
                              "ray_tpu_torch.train", "ray_tpu_torch.data",
                              "ray_tpu_torch.rllib", "ray_tpu_torch.workflow")
            if name in sys.modules]
    payload["library_usages"] = [n.split(".", 1)[1] for n in libs]
    return payload


def write_usage_stats(session_dir: str,
                      payload: Optional[Dict[str, Any]] = None) -> str:
    """Persist the snapshot locally (the reference writes usage_stats.json
    under the session dir too; this build stops there by default)."""
    payload = payload if payload is not None else collect_usage_stats()
    path = os.path.join(session_dir, "usage_stats.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def maybe_report(payload: Dict[str, Any]) -> bool:
    """POST to the OPERATOR-configured endpoint, if any. Returns whether
    a report was attempted. No vendor default: offline images never make
    network calls."""
    url = os.environ.get("RAY_TPU_TORCH_USAGE_STATS_REPORT_URL")
    if not url:
        return False
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10):
            return True
    except Exception:
        return True  # attempted; operators watch their own endpoint
