"""Population Based Training (ray parity:
python/ray/tune/schedulers/pbt.py PopulationBasedTraining).

Every ``perturbation_interval`` time units each trial's score is recorded.
A trial in the bottom quantile exploits a top-quantile donor: it adopts the
donor's latest checkpoint and an explored (mutated) version of the donor's
config. The controller performs the actual stop → restore → restart dance
via ``controller.exploit_trial``.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


def _explore(
    config: Dict,
    mutations: Dict,
    resample_probability: float,
    custom_explore_fn: Optional[Callable],
    rng: random.Random,
) -> Dict:
    new_config = dict(config)
    for key, spec in mutations.items():
        if key not in new_config:
            continue
        old = new_config[key]
        if callable(getattr(spec, "sample", None)):
            # Domain object
            if rng.random() < resample_probability:
                new_config[key] = spec.sample()
            else:
                new_config[key] = old * rng.choice([0.8, 1.2]) if isinstance(
                    old, (int, float)
                ) else spec.sample()
        elif isinstance(spec, list):
            if rng.random() < resample_probability or old not in spec:
                new_config[key] = rng.choice(spec)
            else:
                i = spec.index(old)
                shift = rng.choice([-1, 1])
                new_config[key] = spec[max(0, min(len(spec) - 1, i + shift))]
        elif callable(spec):
            new_config[key] = spec()
        if isinstance(old, int) and isinstance(new_config[key], float):
            new_config[key] = int(new_config[key])
    if custom_explore_fn:
        new_config = custom_explore_fn(new_config)
    return new_config


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: float = 10.0,
        hyperparam_mutations: Optional[Dict] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        custom_explore_fn: Optional[Callable] = None,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._explore_fn = custom_explore_fn
        self._rng = random.Random(seed)
        # trial_id -> {"last_perturb_t": t, "score": latest score}
        self._state: Dict[str, Dict] = {}
        self.num_perturbations = 0

    def on_trial_add(self, controller, trial):
        self._state[trial.trial_id] = {"last_perturb_t": 0.0, "score": None}

    def _quantiles(self):
        scored = [
            (tid, st["score"])
            for tid, st in self._state.items()
            if st["score"] is not None
        ]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda kv: kv[1])
        n = max(1, int(len(scored) * self._quantile))
        if len(scored) <= n:
            return [], []
        bottom = [tid for tid, _ in scored[:n]]
        top = [tid for tid, _ in scored[-n:]]
        return bottom, top

    def on_trial_result(self, controller, trial, result):
        t = result.get(self._time_attr)
        score = self._score(result)
        st = self._state.setdefault(
            trial.trial_id, {"last_perturb_t": 0.0, "score": None}
        )
        if score is not None:
            st["score"] = score
        if t is None or t - st["last_perturb_t"] < self._interval:
            return TrialScheduler.CONTINUE
        st["last_perturb_t"] = t
        bottom, top = self._quantiles()
        if trial.trial_id in bottom and top:
            donor_id = self._rng.choice(top)
            donor = controller.get_trial(donor_id)
            if donor is None:
                return TrialScheduler.CONTINUE
            new_config = self._make_explored_config(donor.config)
            self.num_perturbations += 1
            controller.exploit_trial(trial, donor, new_config)
            # The trial resumes from the DONOR's checkpoint: its previous
            # score no longer describes this lineage. Resetting avoids a
            # spurious jump being attributed to the explored config (PB2's
            # GP would otherwise learn from that phantom improvement).
            st["score"] = None
            # Controller restarted the trial; its in-flight future is void.
            return TrialScheduler.CONTINUE
        return TrialScheduler.CONTINUE

    def _make_explored_config(self, donor_config: Dict) -> Dict:
        """Hook for exploration strategies (PB2 overrides with a GP)."""
        return _explore(
            donor_config,
            self._mutations,
            self._resample_prob,
            self._explore_fn,
            self._rng,
        )

    def on_trial_complete(self, controller, trial, result):
        self._state.pop(trial.trial_id, None)


class PB2(PopulationBasedTraining):
    """PBT with GP-bandit exploration (Parker-Holder et al. 2020; ray
    parity: python/ray/tune/schedulers/pb2.py).

    Instead of random multiplicative perturbation, exploration fits a
    Gaussian process over (time, hyperparameters) -> score improvement
    from ALL trials' perturbation history and picks the next
    hyperparameters by UCB maximization inside ``hyperparam_bounds`` —
    sample-efficient tuning for small populations where random
    perturbation thrashes."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        perturbation_interval: float = 10.0,
        hyperparam_bounds: Optional[Dict] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 2.0,
        n_candidates: int = 256,
        seed: Optional[int] = None,
    ):
        if not hyperparam_bounds:
            raise ValueError(
                "PB2 requires hyperparam_bounds={key: [min, max], ...}"
            )
        # fail at construction, not silently inside explore: without the
        # GP this scheduler would quietly degrade to random search
        import sklearn.gaussian_process  # noqa: F401
        super().__init__(
            time_attr=time_attr, metric=metric, mode=mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={k: list(v)
                                  for k, v in hyperparam_bounds.items()},
            quantile_fraction=quantile_fraction, seed=seed,
        )
        self._bounds = {k: (float(v[0]), float(v[1]))
                        for k, v in hyperparam_bounds.items()}
        self._keys = sorted(self._bounds)
        self._kappa = ucb_kappa
        self._n_candidates = n_candidates
        # GP training rows: [t, hp_1..hp_k] -> score delta over the window
        self._X: list = []
        self._y: list = []
        self._now_t = 0.0

    def on_trial_result(self, controller, trial, result):
        t = result.get(self._time_attr)
        score = self._score(result)
        st = self._state.setdefault(
            trial.trial_id, {"last_perturb_t": 0.0, "score": None}
        )
        if t is not None:
            self._now_t = max(self._now_t, float(t))
        if score is not None and st["score"] is not None and t is not None:
            # improvement observation for the GP, tagged with the config
            # that PRODUCED it
            self._X.append(
                [float(t)] + [float(trial.config.get(k, 0.0))
                              for k in self._keys]
            )
            self._y.append(float(score) - float(st["score"]))
            # recency window: the GP refit is O(n^3) and old dynamics stop
            # being predictive anyway (reference PB2 also windows)
            if len(self._y) > 512:
                self._X = self._X[-512:]
                self._y = self._y[-512:]
        return super().on_trial_result(controller, trial, result)

    def _make_explored_config(self, donor_config: Dict) -> Dict:
        import numpy as np

        new_config = dict(donor_config)
        lo = np.array([self._bounds[k][0] for k in self._keys])
        hi = np.array([self._bounds[k][1] for k in self._keys])
        rng = np.random.default_rng(self._rng.randrange(2**31))
        cands = rng.uniform(lo, hi, size=(self._n_candidates, len(self._keys)))
        picked = None
        if len(self._y) >= 4:
            try:
                from sklearn.gaussian_process import GaussianProcessRegressor
                from sklearn.gaussian_process.kernels import (
                    ConstantKernel,
                    Matern,
                    WhiteKernel,
                )

                X = np.asarray(self._X, float)
                y = np.asarray(self._y, float)
                # normalize inputs to [0,1]; standardize outputs
                xmin, xmax = X.min(0), X.max(0)
                span = np.where(xmax > xmin, xmax - xmin, 1.0)
                Xn = (X - xmin) / span
                ystd = y.std() or 1.0
                yn = (y - y.mean()) / ystd
                # fixed kernel hyperparams (optimizer=None): PB2's data is
                # tiny and normalized to [0,1], where a 0.25 Matern length
                # scale is a sane prior — fitting kernel params on <20
                # points just produces lbfgs convergence noise
                gp = GaussianProcessRegressor(
                    kernel=ConstantKernel(1.0) * Matern(
                        length_scale=0.25, nu=2.5
                    ) + WhiteKernel(1e-3),
                    normalize_y=False, alpha=1e-6, optimizer=None,
                    random_state=int(rng.integers(2**31)),
                )
                gp.fit(Xn, yn)
                Xc = np.concatenate(
                    [np.full((len(cands), 1), self._now_t), cands], axis=1
                )
                Xcn = (Xc - xmin) / span
                mu, sigma = gp.predict(Xcn, return_std=True)
                picked = cands[int(np.argmax(mu + self._kappa * sigma))]
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "PB2 GP fit failed; falling back to random exploration "
                    "for this perturbation", exc_info=True,
                )
                picked = None
        if picked is None:
            picked = cands[0]
        for i, k in enumerate(self._keys):
            val = float(np.clip(picked[i], lo[i], hi[i]))
            if isinstance(donor_config.get(k), int):
                val = int(round(val))
            new_config[k] = val
        return new_config
