"""Trial scheduler interface (ray parity:
python/ray/tune/schedulers/trial_scheduler.py)."""

from __future__ import annotations

from typing import Dict, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self._metric = metric
        self._mode = mode

    @property
    def metric(self):
        return self._metric

    @property
    def mode(self):
        return self._mode

    def set_search_properties(self, metric, mode) -> bool:
        if self._metric is None:
            self._metric = metric
        if self._mode is None:
            self._mode = mode
        return True

    def _score(self, result: Dict) -> Optional[float]:
        """Metric as a maximization score (negated for mode=min)."""
        if self._metric is None or self._metric not in result:
            return None
        v = float(result[self._metric])
        return -v if self._mode == "min" else v

    def on_trial_add(self, controller, trial):
        pass

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, controller, trial, result: Dict):
        pass

    def on_trial_error(self, controller, trial):
        pass

    def on_trial_remove(self, controller, trial):
        pass

    def debug_string(self) -> str:
        return type(self).__name__


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""
