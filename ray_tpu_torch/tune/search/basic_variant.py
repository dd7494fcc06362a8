"""Default grid/random searcher (ray parity:
python/ray/tune/search/basic_variant.py:192 BasicVariantGenerator).

Pre-expands grid variants; each of ``num_samples`` repetitions re-samples
all Domain leaves.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Optional, Tuple

from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.variant_generator import (
    count_variants,
    format_vars,
    generate_variants,
)


class BasicVariantGenerator(Searcher):
    def __init__(
        self,
        max_concurrent: int = 0,
        random_state: Optional[int] = None,
    ):
        super().__init__()
        self.max_concurrent = max_concurrent
        self._rng = random.Random(random_state)
        self._space: Optional[Dict] = None
        self._num_samples = 1
        self._iter: Optional[Iterator[Tuple[Dict, Dict]]] = None
        self._live = set()
        self.total_samples = 0
        self._consumed = 0

    # Experiment snapshot support: the live generator cannot pickle; resume
    # rebuilds it and fast-forwards past the already-suggested variants
    # (grid order is deterministic; random leaves of remaining samples just
    # draw fresh values).
    def __getstate__(self):
        st = self.__dict__.copy()
        st["_iter"] = None
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        if self._space is not None and self._consumed:
            consumed = self._consumed
            self.set_space(self._space, self._num_samples)
            for _ in range(consumed):
                next(self._iter, None)
            self._consumed = consumed

    def set_search_properties(self, metric, mode, config=None, **kwargs):
        super().set_search_properties(metric, mode, config, **kwargs)
        if config is not None:
            self._space = config
        return True

    def set_space(self, space: Dict, num_samples: int):
        self._space = space
        self._num_samples = num_samples
        self.total_samples = count_variants(space) * num_samples

        def gen():
            for _ in range(num_samples):
                yield from generate_variants(space, rng=self._rng)

        self._iter = gen()

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._iter is None:
            if self._space is None:
                return Searcher.FINISHED
            self.set_space(self._space, self._num_samples)
        if self.max_concurrent and len(self._live) >= self.max_concurrent:
            return None
        try:
            resolved, config = next(self._iter)
        except StopIteration:
            return Searcher.FINISHED
        self._consumed += 1
        self._live.add(trial_id)
        config["__resolved_vars__"] = format_vars(resolved)
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
