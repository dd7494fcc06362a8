"""Tree-structured Parzen Estimator searcher.

The reference offers model-based search via external wrappers
(ray: python/ray/tune/search/hyperopt/hyperopt_search.py — HyperOpt's core
algorithm is TPE; optuna's default sampler is also TPE). Neither library
is a dependency of the package, so the algorithm itself is implemented here,
natively, over the in-repo sample domains — same role in the stack
(drop-in ``search_alg`` for ``TuneConfig``), no external dependency.

Algorithm (Bergstra et al., "Algorithms for Hyper-Parameter Optimization",
NeurIPS 2011): after ``n_initial_points`` random startup trials, split
observations at the ``gamma`` quantile into good/bad sets; model each
numeric dimension with Gaussian kernel density estimates l(x) (good) and
g(x) (bad); draw candidates from l and keep the one maximizing l(x)/g(x).
Categoricals use smoothed category frequencies. Dimensions are modeled
independently (the classic TPE factorization).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search.sample import (
    Categorical,
    Domain,
    Float,
    Function,
    Integer,
    LogInteger,
    LogUniform,
    Normal,
    Quantized,
)
from ray_tpu_torch.tune.search.searcher import Searcher


def _flatten(space: dict, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    out: Dict[Tuple, Any] = {}
    for k, v in space.items():
        if isinstance(v, dict) and "grid_search" not in v:
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Tuple, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


class _NumericDim:
    """One numeric dimension: optional log transform + KDE machinery."""

    def __init__(self, domain):
        self.quantum = None
        if isinstance(domain, Quantized):
            self.quantum = domain.q
            domain = domain.base_domain
        self.log = isinstance(domain, (LogUniform, LogInteger))
        self.integer = isinstance(domain, Integer)
        self.domain = domain
        if isinstance(domain, Normal):
            self.lo, self.hi = -math.inf, math.inf
            self.width = 2 * domain.sd
        else:
            lo, hi = float(domain.lower), float(domain.upper)
            if self.log:
                lo, hi = math.log(lo), math.log(hi)
            self.lo, self.hi = lo, hi
            self.width = hi - lo

    def to_internal(self, v: float) -> float:
        return math.log(v) if self.log else float(v)

    def from_internal(self, x: float) -> Any:
        v = math.exp(x) if self.log else x
        if not isinstance(self.domain, Normal):
            v = min(max(v, float(self.domain.lower)),
                    float(self.domain.upper) - (1 if self.integer else 0))
        if self.quantum is not None:
            v = round(v / self.quantum) * self.quantum
            if float(self.quantum).is_integer():
                v = int(v)
        elif self.integer:
            v = int(v)
        return v

    def _bandwidth(self, obs: List[float]) -> float:
        if len(obs) < 2:
            return max(self.width / 5.0, 1e-12)
        spread = max(obs) - min(obs)
        return max(spread / max(len(obs) - 1, 1),
                   self.width / (5.0 * len(obs)), 1e-12)

    def kde_sample(self, obs: List[float], rng: random.Random) -> float:
        if not obs:
            return self.to_internal(self.domain.sample(rng))
        bw = self._bandwidth(obs)
        x = rng.gauss(rng.choice(obs), bw)
        if math.isfinite(self.lo):
            x = min(max(x, self.lo), self.hi)
        return x

    def kde_logpdf(self, x: float, obs: List[float]) -> float:
        if not obs:
            return 0.0
        bw = self._bandwidth(obs)
        total = 0.0
        for o in obs:
            z = (x - o) / bw
            total += math.exp(-0.5 * z * z) / bw
        return math.log(total / len(obs) + 1e-300)


class TPESearcher(Searcher):
    """Native TPE ``search_alg`` (see module docstring for provenance)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *,
                 n_initial_points: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial_points = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._space: Dict[Tuple, Any] = {}
        self._live: Dict[str, Dict[Tuple, Any]] = {}
        self._obs: List[Tuple[Dict[Tuple, Any], float]] = []

    def set_search_properties(self, metric, mode, config=None, **kwargs):
        super().set_search_properties(metric, mode, config, **kwargs)
        if config:
            self._space = _flatten(config)
        return True

    # ------------------------------------------------------------------
    def _random_flat(self) -> Dict[Tuple, Any]:
        flat = {}
        for path, dom in self._space.items():
            if isinstance(dom, Function):
                continue  # resolved last, against the partial config
            if isinstance(dom, Domain):
                flat[path] = dom.sample(self._rng)
            elif isinstance(dom, dict) and "grid_search" in dom:
                flat[path] = self._rng.choice(dom["grid_search"])
            else:
                flat[path] = dom
        return flat

    def _split(self):
        """Sort observations best-first and split at the gamma quantile."""
        ordered = sorted(self._obs, key=lambda p: p[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good
        return good, bad

    def _suggest_dim(self, path, dom, good, bad):
        if isinstance(dom, Categorical):
            cats = dom.categories

            def counts(group):
                w = [1.0] * len(cats)  # +1 smoothing
                for cfg in group:
                    v = cfg.get(path)
                    for i, c in enumerate(cats):
                        if c == v:
                            w[i] += 1.0
                            break
                s = sum(w)
                return [x / s for x in w]

            lw, gw = counts(good), counts(bad)
            best_i = max(range(len(cats)),
                         key=lambda i: lw[i] / gw[i] + self._rng.random() * 1e-9)
            # sample proportionally to the good distribution, biased by ratio
            scores = [lw[i] / gw[i] for i in range(len(cats))]
            total = sum(scores)
            r = self._rng.random() * total
            acc = 0.0
            for i, s in enumerate(scores):
                acc += s
                if r <= acc:
                    return cats[i]
            return cats[best_i]
        if isinstance(dom, (Quantized, Float, Integer, Normal)):
            nd = _NumericDim(dom)
            g_obs = [nd.to_internal(c[path]) for c in good if path in c]
            b_obs = [nd.to_internal(c[path]) for c in bad if path in c]
            best_x, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                x = nd.kde_sample(g_obs, self._rng)
                score = nd.kde_logpdf(x, g_obs) - nd.kde_logpdf(x, b_obs)
                if score > best_score:
                    best_x, best_score = x, score
            return nd.from_internal(best_x)
        # other Domains / grid markers / constants: fall back to random
        if isinstance(dom, Domain):
            return dom.sample(self._rng)
        if isinstance(dom, dict) and "grid_search" in dom:
            return self._rng.choice(dom["grid_search"])
        return dom

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if not self._space:
            return {}
        if len(self._obs) < self.n_initial_points:
            flat = self._random_flat()
        else:
            good, bad = self._split()
            flat = {
                path: self._suggest_dim(path, dom, good, bad)
                for path, dom in self._space.items()
                if not isinstance(dom, Function)
            }
        self._live[trial_id] = flat
        config = _unflatten(flat)
        # sample_from callables see the partial config (like the variant
        # generator) and are not modeled by TPE
        for path, dom in self._space.items():
            if isinstance(dom, Function):
                cur = config
                for k in path[:-1]:
                    cur = cur.setdefault(k, {})
                cur[path[-1]] = dom.sample(self._rng, spec=config)
        return config

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._live.pop(trial_id, None)
        if flat is None or error or not result:
            return
        metric = self._metric
        if metric is None or metric not in result:
            return
        value = result[metric]
        if self._mode == "max":
            value = -value
        self._obs.append((flat, value))
