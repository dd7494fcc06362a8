"""Median stopping rule (ray parity:
python/ray/tune/schedulers/median_stopping_rule.py).

Stop a trial at time t if its best/mean result so far is worse than the
median of all other trials' running means at comparable times.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        grace_period: float = 1.0,
        min_samples_required: int = 3,
        min_time_slice: float = 0,
        hard_stop: bool = True,
    ):
        super().__init__(metric, mode)
        self._time_attr = time_attr
        self._grace_period = grace_period
        self._min_samples = min_samples_required
        self._hard_stop = hard_stop
        # trial_id -> list of (t, score)
        self._history: Dict[str, List] = defaultdict(list)
        self._completed = set()

    def _running_mean(self, trial_id: str, t_max: float) -> Optional[float]:
        pts = [s for (t, s) in self._history[trial_id] if t <= t_max]
        return statistics.fmean(pts) if pts else None

    def on_trial_result(self, controller, trial, result):
        t = result.get(self._time_attr)
        score = self._score(result)
        if t is None or score is None:
            return TrialScheduler.CONTINUE
        self._history[trial.trial_id].append((t, score))
        if t < self._grace_period:
            return TrialScheduler.CONTINUE
        other_means = [
            m
            for tid in self._history
            if tid != trial.trial_id
            for m in [self._running_mean(tid, t)]
            if m is not None
        ]
        if len(other_means) < self._min_samples:
            return TrialScheduler.CONTINUE
        median = statistics.median(other_means)
        best = max(s for (_, s) in self._history[trial.trial_id])
        if best < median:
            return (
                TrialScheduler.STOP if self._hard_stop else TrialScheduler.PAUSE
            )
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, controller, trial, result):
        self._completed.add(trial.trial_id)
