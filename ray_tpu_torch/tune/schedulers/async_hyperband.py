"""ASHA — asynchronous successive halving (ray parity:
python/ray/tune/schedulers/async_hyperband.py).

Rung levels r = grace_period * rf^k up to max_t. When a trial reaches a rung
it records its metric there; if it falls below the top-1/rf quantile of that
rung's history it is stopped. Fully asynchronous — no waiting for a cohort.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Bracket:
    def __init__(self, grace_period: float, max_t: float, reduction_factor: float, s: int):
        self.rf = reduction_factor
        # Rung levels, smallest first; bracket s skips the s lowest rungs.
        max_rungs = int(math.log(max(max_t / grace_period, 1), reduction_factor) + 1)
        self.rungs: List[Dict] = [
            {"level": grace_period * reduction_factor ** k, "recorded": {}}
            for k in range(s, max_rungs)
            if grace_period * reduction_factor ** k <= max_t
        ]

    def cutoff(self, recorded: Dict[str, float]) -> Optional[float]:
        if len(recorded) < self.rf:
            return None
        scores = sorted(recorded.values(), reverse=True)
        k = int(len(scores) / self.rf)
        return scores[max(k - 1, 0)]

    def on_result(self, trial_id: str, t: float, score: Optional[float]) -> str:
        action = TrialScheduler.CONTINUE
        for rung in reversed(self.rungs):
            if t < rung["level"] or trial_id in rung["recorded"]:
                continue
            if score is None:
                break
            cutoff = self.cutoff(rung["recorded"])
            rung["recorded"][trial_id] = score
            if cutoff is not None and score < cutoff:
                action = TrialScheduler.STOP
            break
        return action


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: float = 100.0,
        grace_period: float = 1.0,
        reduction_factor: float = 4.0,
        brackets: int = 1,
    ):
        super().__init__(metric, mode)
        self._time_attr = time_attr
        self._max_t = max_t
        self._brackets = [
            _Bracket(grace_period, max_t, reduction_factor, s)
            for s in range(brackets)
        ]
        self._trial_bracket: Dict[str, _Bracket] = {}
        self._counter = 0

    def on_trial_add(self, controller, trial):
        # Round-robin trials across brackets (the reference softmaxes on
        # bracket size; round-robin is an unbiased stand-in).
        b = self._brackets[self._counter % len(self._brackets)]
        self._counter += 1
        self._trial_bracket[trial.trial_id] = b

    def on_trial_result(self, controller, trial, result):
        t = result.get(self._time_attr)
        if t is None:
            return TrialScheduler.CONTINUE
        if t >= self._max_t:
            return TrialScheduler.STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return TrialScheduler.CONTINUE
        return bracket.on_result(trial.trial_id, t, self._score(result))

    def on_trial_complete(self, controller, trial, result):
        t = result.get(self._time_attr) if result else None
        bracket = self._trial_bracket.pop(trial.trial_id, None)
        if bracket is not None and t is not None:
            bracket.on_result(trial.trial_id, t, self._score(result))


# Common alias, matching the reference export.
ASHAScheduler = AsyncHyperBandScheduler
