"""Workflow management actor (ray parity: python/ray/workflow/
workflow_access.py WorkflowManagementActor — the cluster-level registry
every driver can reach: which workflows are running, where, and the
cancel path that works from a DIFFERENT driver than the one executing).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

MANAGEMENT_ACTOR_NAME = "__workflow_management__"


class WorkflowManagementActor:
    """Named detached actor tracking workflow runs cluster-wide."""

    def __init__(self):
        self._runs: Dict[str, dict] = {}

    def register(self, workflow_id: str, storage: str, pid: int,
                 host: str) -> None:
        self._runs[workflow_id] = {
            "workflow_id": workflow_id, "storage": storage,
            "pid": pid, "host": host, "status": "RUNNING",
            "started_at": time.time(),
        }

    def mark(self, workflow_id: str, status: str) -> None:
        run = self._runs.get(workflow_id)
        if run is not None:
            run["status"] = status
            run["ended_at"] = time.time()

    def list_runs(self) -> Dict[str, dict]:
        return {k: dict(v) for k, v in self._runs.items()}

    def cancel(self, workflow_id: str) -> bool:
        """Cross-driver cancel: flips the durable meta so the executing
        driver's step loop stops before its next step."""
        run = self._runs.get(workflow_id)
        if run is None:
            return False
        from ray_tpu_torch import workflow as wf

        wrun = wf._WorkflowRun(workflow_id, run["storage"])
        if wrun.read_meta().get("status") != wf.RUNNING:
            # terminal already: nothing to cancel, and CANCELED must not
            # clobber a SUCCESSFUL/FAILED record
            return False
        wrun.write_meta(status=wf.CANCELED)
        run["status"] = wf.CANCELED
        return True


def get_management_actor():
    """Get-or-create the detached management actor; None when no cluster
    is initialized (workflows still run, just unregistered)."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        return None
    try:
        return ray_tpu_torch.get_actor(MANAGEMENT_ACTOR_NAME)
    except Exception:
        pass
    try:
        cls = ray_tpu_torch.remote(num_cpus=0, name=MANAGEMENT_ACTOR_NAME,
                             lifetime="detached")(WorkflowManagementActor)
        return cls.remote()
    except Exception:
        # lost the creation race
        try:
            return ray_tpu_torch.get_actor(MANAGEMENT_ACTOR_NAME)
        except Exception:
            return None


def notify(method: str, *args) -> None:
    """Fire-and-forget notification to the management actor."""
    actor = get_management_actor()
    if actor is None:
        return
    try:
        getattr(actor, method).remote(*args)
    except Exception:
        pass
