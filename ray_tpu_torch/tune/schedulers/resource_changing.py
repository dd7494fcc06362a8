"""ResourceChangingScheduler (ray parity:
python/ray/tune/schedulers/resource_changing_scheduler.py).

Wraps any trial scheduler and, on a cadence, reallocates cluster
resources among LIVE trials: as trials finish, survivors absorb the
freed capacity (checkpoint -> restart with the new allocation, driven
by ``controller.change_trial_resources``). The default policy,
``DistributeResources``, splits the cluster's CPUs evenly across
running trials with the experiment's base request as the floor."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class DistributeResources:
    """Even split of total cluster CPUs over live trials (floor = the
    trial's current base request)."""

    def __init__(self, resource_key: str = "CPU"):
        self.key = resource_key

    def __call__(self, controller, trial, base_resources: Dict[str, float]
                 ) -> Optional[Dict[str, float]]:
        import ray_tpu_torch

        try:
            total = float(
                ray_tpu_torch.cluster_resources().get(self.key, 0.0)
            )
        except Exception:
            return None
        live = [
            t for t in getattr(controller, "trials", [])
            if getattr(t, "status", None) in ("RUNNING", "PENDING")
        ]
        if not live or total <= 0:
            return None
        base = float(base_resources.get(self.key, 1.0))
        if base <= 0:
            # CPU=0 is the Trainer-coordinator convention: the trial actor
            # deliberately claims nothing while its NESTED train workers
            # hold the CPUs — upsizing the coordinator would strand those
            # workers in the infeasible queue and deadlock
            return None
        share = max(base, math.floor(total / len(live)))
        out = dict(trial.resources)
        out[self.key] = float(share)
        return out


class ResourceChangingScheduler(TrialScheduler):
    def __init__(
        self,
        base_scheduler: Optional[TrialScheduler] = None,
        resources_allocation_function: Optional[Callable] = None,
        reallocate_interval: int = 5,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
    ):
        from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler

        super().__init__(metric, mode)
        self._base = base_scheduler or FIFOScheduler()
        self._alloc = resources_allocation_function or DistributeResources()
        self._interval = max(1, int(reallocate_interval))
        self._base_resources: Dict[str, Dict[str, float]] = {}
        self._since_check: Dict[str, int] = {}
        self.num_resource_changes = 0

    def set_search_properties(self, metric, mode) -> bool:
        # BOTH layers need the experiment's metric/mode: the wrapped
        # scheduler makes the actual stop/pause decisions
        super().set_search_properties(metric, mode)
        return self._base.set_search_properties(metric, mode)

    def __getattr__(self, name):
        # forward the rest of the scheduler surface (may_resume, bracket
        # state, ...) to the wrapped scheduler so controller feature
        # probes see the base scheduler's capabilities
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._base, name)

    # __getattr__ never fires for hooks TrialScheduler defines concretely,
    # so forward those explicitly — a wrapped ASHA/HyperBand must learn
    # about errored/removed trials or its bracket state leaks
    def on_trial_error(self, controller, trial):
        self._base_resources.pop(trial.trial_id, None)
        self._since_check.pop(trial.trial_id, None)
        return self._base.on_trial_error(controller, trial)

    def on_trial_remove(self, controller, trial):
        self._base_resources.pop(trial.trial_id, None)
        self._since_check.pop(trial.trial_id, None)
        return self._base.on_trial_remove(controller, trial)

    def debug_string(self) -> str:
        return (f"ResourceChangingScheduler "
                f"({self.num_resource_changes} changes) wrapping "
                f"{self._base.debug_string()}")

    # -- delegate the scheduling decisions to the wrapped scheduler ----
    def on_trial_add(self, controller, trial):
        self._base_resources[trial.trial_id] = dict(trial.resources or {})
        self._since_check[trial.trial_id] = 0
        return self._base.on_trial_add(controller, trial)

    def on_trial_complete(self, controller, trial, result):
        self._base_resources.pop(trial.trial_id, None)
        self._since_check.pop(trial.trial_id, None)
        return self._base.on_trial_complete(controller, trial, result)

    def on_trial_result(self, controller, trial, result):
        decision = self._base.on_trial_result(controller, trial, result)
        if decision != TrialScheduler.CONTINUE:
            return decision
        n = self._since_check.get(trial.trial_id, 0) + 1
        self._since_check[trial.trial_id] = n
        if n < self._interval:
            return decision
        self._since_check[trial.trial_id] = 0
        base = self._base_resources.get(trial.trial_id, {})
        want = self._alloc(controller, trial, base)
        if want and dict(want) != dict(trial.resources or {}):
            if controller.change_trial_resources(trial, want):
                self.num_resource_changes += 1
        return decision
