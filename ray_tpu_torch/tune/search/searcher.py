"""Searcher interface + meta-searchers (ray parity:
python/ray/tune/search/searcher.py, concurrency_limiter.py, repeater.py).
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Any, Dict, Optional


class Searcher:
    """Suggest configs for new trials; observe completions.

    ``suggest`` returns a config dict, ``Searcher.FINISHED`` when the search
    space is exhausted, or ``None`` ("no suggestion right now, ask later").
    """

    FINISHED = "FINISHED"

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self._metric = metric
        self._mode = mode

    @property
    def metric(self):
        return self._metric

    @property
    def mode(self):
        return self._mode

    def set_search_properties(self, metric, mode, config=None, **kwargs) -> bool:
        if self._metric is None:
            self._metric = metric
        if self._mode is None:
            self._mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict):
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict] = None, error: bool = False
    ):
        pass

    def save(self, path: str):
        pass

    def restore(self, path: str):
        pass


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions from the wrapped searcher
    (ray parity: search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int, batch: bool = False):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self.batch = batch
        self._live = set()

    def set_search_properties(self, metric, mode, config=None, **kwargs):
        return self.searcher.set_search_properties(metric, mode, config, **kwargs)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None
        config = self.searcher.suggest(trial_id)
        if config is not None and config != Searcher.FINISHED:
            self._live.add(trial_id)
        return config

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result=result, error=error)


class Repeater(Searcher):
    """Run each suggested config ``repeat`` times and report the mean metric
    to the wrapped searcher (ray parity: search/repeater.py)."""

    def __init__(self, searcher: Searcher, repeat: int = 1, set_index: bool = True):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self.set_index = set_index
        self._group_of: Dict[str, int] = {}
        self._group_configs: Dict[int, Dict] = {}
        self._group_members: Dict[int, list] = defaultdict(list)
        self._group_scores: Dict[int, list] = defaultdict(list)
        self._group_finished: Dict[int, int] = defaultdict(int)
        self._group_leader: Dict[int, str] = {}
        self._next_group = 0
        self._pending_in_group = 0

    def set_search_properties(self, metric, mode, config=None, **kwargs):
        super().set_search_properties(metric, mode, config, **kwargs)
        return self.searcher.set_search_properties(metric, mode, config, **kwargs)

    def suggest(self, trial_id):
        gid = self._next_group
        if not self._group_members[gid] or len(self._group_members[gid]) >= self.repeat:
            if self._group_members[gid]:
                gid = self._next_group = self._next_group + 1
            config = self.searcher.suggest(trial_id)
            if config is None or config == Searcher.FINISHED:
                return config
            self._group_configs[gid] = config
            self._group_leader[gid] = trial_id
        config = dict(self._group_configs[gid])
        if self.set_index:
            config["__trial_index__"] = len(self._group_members[gid])
        self._group_members[gid].append(trial_id)
        self._group_of[trial_id] = gid
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        gid = self._group_of.get(trial_id)
        if gid is None:
            return
        metric = self._metric or self.searcher.metric
        if result and metric and metric in result:
            self._group_scores[gid].append(result[metric])
        self._group_finished[gid] += 1
        # Report once every member has finished (scored, errored, or missing
        # the metric) and the group was fully suggested.
        if (
            self._group_finished[gid] >= len(self._group_members[gid])
            and len(self._group_members[gid]) >= self.repeat
        ):
            scores = self._group_scores[gid]
            agg = dict(result or {})
            if scores and metric:
                agg[metric] = statistics.fmean(scores)
            self.searcher.on_trial_complete(
                self._group_leader[gid], result=agg, error=not scores
            )
