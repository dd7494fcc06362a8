"""BOHB: Bayesian-Optimization HyperBand (native implementation).

Reference parity: ray python/ray/tune/search/bohb/bohb_search.py (TuneBOHB,
which wraps hpbandster's BOHB model) paired with
schedulers/hb_bohb.py (HyperBandForBOHB). The design follows the BOHB
paper's rule set rather than hpbandster's code: a TPE-style KDE model is
fit PER BUDGET (rung), suggestions come from the largest budget that has
collected enough observations (|D_b| >= dims + 2), and earlier budgets'
data is never mixed into the model — low-fidelity scores are biased
estimators of high-fidelity ones.

Pair with ``HyperBandForBOHB`` (the bracket scheduler): the scheduler
decides who stops at each rung, this searcher decides what to try next.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ray_tpu_torch.tune.search.tpe import TPESearcher


class BOHBSearcher(TPESearcher):
    """TPE/KDE model keyed by rung budget (ray parity: TuneBOHB).

    ``budget_attr`` names the result field that identifies the fidelity a
    score was measured at (HyperBandForBOHB's ``time_attr``,
    "training_iteration" by default).
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 budget_attr: str = "training_iteration",
                 n_initial_points: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode, n_initial_points=n_initial_points,
                         gamma=gamma, n_candidates=n_candidates, seed=seed)
        self.budget_attr = budget_attr
        # budget -> [(flat_config, signed_value)]
        self._budget_obs: Dict[float, list] = {}

    # -- observation plumbing ------------------------------------------
    def _record(self, trial_id: str, result: Dict):
        flat = self._live.get(trial_id)
        if flat is None or not result:
            return
        metric = self._metric
        if metric is None or metric not in result:
            return
        value = result[metric]
        if self._mode == "max":
            value = -value
        budget = float(result.get(self.budget_attr, 1.0) or 1.0)
        # one (trial, budget) observation; a re-report at the same budget
        # (checkpoint replay) overwrites rather than double-counts
        bucket = self._budget_obs.setdefault(budget, [])
        for i, (cfg, _v) in enumerate(bucket):
            if cfg is flat:
                bucket[i] = (flat, value)
                break
        else:
            bucket.append((flat, value))

    def on_trial_result(self, trial_id: str, result: Dict):
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        if not error and result:
            self._record(trial_id, result)
        self._live.pop(trial_id, None)

    # -- model selection -----------------------------------------------
    def _model_obs(self):
        """Observations of the LARGEST budget with enough data (BOHB's
        |D_b| >= dims + 2 rule); None when no budget qualifies yet."""
        from ray_tpu_torch.tune.search.sample import Domain, Function

        # count only dimensions the KDE actually models — constants,
        # grid markers, and sample_from functions don't raise the bar
        dims = sum(
            1 for dom in self._space.values()
            if isinstance(dom, Domain) and not isinstance(dom, Function)
        )
        need = max(dims + 2, self.n_initial_points)
        for budget in sorted(self._budget_obs, reverse=True):
            obs = self._budget_obs[budget]
            if len(obs) >= need:
                return obs
        return None

    def suggest(self, trial_id: str) -> Optional[Dict]:
        obs = self._model_obs()
        # splice the chosen budget's data into the parent's sampling path
        self._obs = obs or []
        return super().suggest(trial_id)
