"""Stoppers (ray parity: python/ray/tune/stopper/)."""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Optional


class Stopper:
    def __call__(self, trial_id: str, result: Dict) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self._max_iter = max_iter

    def __call__(self, trial_id, result):
        return result.get("training_iteration", 0) >= self._max_iter


class TimeoutStopper(Stopper):
    """Stop the whole experiment after a wall-clock budget."""

    def __init__(self, timeout: float):
        self._deadline = time.monotonic() + timeout

    def __call__(self, trial_id, result):
        return False

    def stop_all(self):
        return time.monotonic() >= self._deadline


class TrialPlateauStopper(Stopper):
    def __init__(
        self,
        metric: str,
        std: float = 0.01,
        num_results: int = 4,
        grace_period: int = 4,
        metric_threshold: Optional[float] = None,
        mode: str = "min",
    ):
        self._metric = metric
        self._std = std
        self._num_results = num_results
        self._grace = grace_period
        self._threshold = metric_threshold
        self._mode = mode
        self._window = defaultdict(lambda: deque(maxlen=num_results))
        self._count = defaultdict(int)

    def __call__(self, trial_id, result):
        v = result.get(self._metric)
        if v is None:
            return False
        self._count[trial_id] += 1
        self._window[trial_id].append(float(v))
        if self._count[trial_id] < max(self._grace, self._num_results):
            return False
        if self._threshold is not None:
            if self._mode == "min" and v > self._threshold:
                return False
            if self._mode == "max" and v < self._threshold:
                return False
        w = self._window[trial_id]
        mean = sum(w) / len(w)
        var = sum((x - mean) ** 2 for x in w) / len(w)
        return var ** 0.5 <= self._std


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self._stoppers = stoppers

    def __call__(self, trial_id, result):
        return any(s(trial_id, result) for s in self._stoppers)

    def stop_all(self):
        return any(s.stop_all() for s in self._stoppers)


class FunctionStopper(Stopper):
    def __init__(self, function):
        self._fn = function

    def __call__(self, trial_id, result):
        return self._fn(trial_id, result)


class _DictStopper(Stopper):
    """run_config.stop={"metric": threshold} — stop when metric >= threshold
    (reference semantics)."""

    def __init__(self, criteria: Dict[str, float]):
        self._criteria = criteria

    def __call__(self, trial_id, result):
        for k, v in self._criteria.items():
            if k in result and result[k] >= v:
                return True
        return False


def resolve_stopper(stop) -> Optional[Stopper]:
    if stop is None:
        return None
    if isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        return _DictStopper(stop)
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(f"invalid stop criteria: {stop!r}")
