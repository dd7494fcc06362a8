"""Adapter for third-party suggesters (ray parity: the wrapper family in
python/ray/tune/search/ — optuna/, hyperopt/, ax/, bayesopt/... — each of
which adapts one library's ask/tell surface onto tune's Searcher).

This module provides the one generic adapter those wrappers share:
anything that can (a) propose a config dict and (b) ingest an observed
score plugs into the Tuner through ``ExternalSearcherAdapter``.

Worked example — wrapping a hand-rolled simulated-annealing suggester::

    import math, random

    class Annealer:
        def __init__(self, lo, hi, seed=0):
            self.rng = random.Random(seed)
            self.lo, self.hi = lo, hi
            self.best_x, self.best_v, self.temp = None, math.inf, 1.0

        def ask(self):
            if self.best_x is None:
                return {"x": self.rng.uniform(self.lo, self.hi)}
            span = (self.hi - self.lo) * self.temp
            x = min(max(self.best_x + self.rng.gauss(0, span), self.lo),
                    self.hi)
            return {"x": x}

        def tell(self, config, value, error=False):
            self.temp *= 0.9
            if not error and value < self.best_v:
                self.best_x, self.best_v = config["x"], value

    ann = Annealer(lo=-5.0, hi=5.0)
    tuner = Tuner(
        objective,
        tune_config=TuneConfig(
            search_alg=ExternalSearcherAdapter(ann, metric="loss",
                                               mode="min"),
            num_samples=30, metric="loss", mode="min",
        ),
    )

The wrapped object needs ``ask() -> dict`` and, optionally,
``tell(config, value, error)``; objects using other method names can be
adapted with the ``ask``/``tell`` keyword overrides.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune.search.searcher import Searcher


class ExternalSearcherAdapter(Searcher):
    """Wrap an ask/tell suggester as a tune Searcher.

    - ``ask()`` must return the next config dict (or ``None`` to signal
      exhaustion, which finishes the search).
    - ``tell(config, value, error)`` (optional) receives each completed
      trial's config and metric value; ``mode="max"`` values are passed
      through unnegated — the suggester sees exactly what tune saw.
    """

    def __init__(self, suggester: Any = None,
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 *, ask: Optional[Callable[[], Optional[Dict]]] = None,
                 tell: Optional[Callable[..., None]] = None):
        super().__init__(metric, mode)
        if ask is None:
            if suggester is None or not hasattr(suggester, "ask"):
                raise ValueError(
                    "ExternalSearcherAdapter needs an object with .ask() "
                    "or an explicit ask= callable"
                )
            ask = suggester.ask
        if tell is None and suggester is not None:
            tell = getattr(suggester, "tell", None)
        self._ask = ask
        self._tell = tell
        # detect the tell arity ONCE: catching TypeError at call time
        # would re-invoke a 3-arg tell whose body raised, doubling its
        # side effects
        self._tell_takes_error = False
        if tell is not None:
            import inspect

            try:
                sig = inspect.signature(tell)
                self._tell_takes_error = (
                    "error" in sig.parameters
                    or any(p.kind == inspect.Parameter.VAR_KEYWORD
                           for p in sig.parameters.values())
                )
            except (TypeError, ValueError):
                self._tell_takes_error = True
        self._live: Dict[str, Dict] = {}

    def suggest(self, trial_id: str) -> Optional[Dict]:
        config = self._ask()
        if config is None:
            return Searcher.FINISHED
        self._live[trial_id] = config
        return dict(config)

    def on_trial_complete(self, trial_id, result=None, error=False):
        config = self._live.pop(trial_id, None)
        if config is None or self._tell is None:
            return
        value = None
        if result and self._metric and self._metric in result:
            value = result[self._metric]
        if self._tell_takes_error:
            self._tell(config, value, error=error or value is None)
        else:
            self._tell(config, value)


class OptunaSearch(Searcher):
    """Optuna wrapper (ray parity: tune/search/optuna/optuna_search.py).
    Requires ``optuna``; the search space is defined optuna-style via a
    ``space(trial)`` definition function returning the params dict."""

    def __init__(self, space: Callable, metric: str, mode: str = "min",
                 seed: Optional[int] = None, **study_kwargs):
        super().__init__(metric, mode)
        try:
            import optuna
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "OptunaSearch requires the 'optuna' package"
            ) from e
        self._optuna = optuna
        sampler = optuna.samplers.TPESampler(seed=seed)
        direction = "minimize" if mode == "min" else "maximize"
        self._study = optuna.create_study(
            direction=direction, sampler=sampler, **study_kwargs
        )
        self._space_fn = space
        self._trials: Dict[str, Any] = {}

    def suggest(self, trial_id: str) -> Optional[Dict]:
        t = self._study.ask()
        self._trials[trial_id] = t
        cfg = self._space_fn(t)
        # ray parity: a define-by-run function may return None and rely
        # on trial.suggest_* side effects — take the params off the trial
        return dict(cfg) if cfg is not None else dict(t.params)

    def on_trial_complete(self, trial_id, result=None, error=False):
        t = self._trials.pop(trial_id, None)
        if t is None:
            return
        value = (result or {}).get(self._metric)
        if error or value is None:
            self._study.tell(
                t, state=self._optuna.trial.TrialState.FAIL
            )
        else:
            self._study.tell(t, value)
