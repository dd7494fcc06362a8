"""Tuner + TuneConfig (ray parity: python/ray/tune/tuner.py:53,
tune/tune_config.py) and the legacy ``tune.run`` entry
(tune/tune.py:295).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.logger import DEFAULT_CALLBACKS
from ray_tpu_torch.tune.result_grid import ResultGrid


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: Optional[str] = None
    num_samples: int = 1
    search_alg: Any = None
    scheduler: Any = None
    max_concurrent_trials: int = 0
    time_budget_s: Optional[float] = None
    reuse_actors: bool = False


class _ResourceWrapped:
    """Result of tune.with_resources — trainable + resource request."""

    def __init__(self, trainable, resources: Dict[str, float]):
        self.trainable = trainable
        self.resources = resources
        self.__name__ = getattr(trainable, "__name__", "trainable")


def with_resources(trainable, resources: Union[Dict[str, float], Any]):
    """ray parity: tune.with_resources — attach a per-trial resource request.

    Accepts a plain dict ({"CPU": 2, "GPU": 1}) or a ScalingConfig (its
    worker bundle is used)."""
    if hasattr(resources, "worker_resources"):
        resources = resources.worker_resources()
    return _ResourceWrapped(trainable, dict(resources))


def with_parameters(trainable, **kwargs):
    """ray parity: tune.with_parameters — bind large constants via the
    object store so they're shipped once, not per-trial-config."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    if callable(trainable) and not isinstance(trainable, type):
        def _inner(config):
            bound = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
            return trainable(config, **bound)

        _inner.__name__ = getattr(trainable, "__name__", "trainable")
        return _inner

    class _Bound(trainable):  # type: ignore[misc]
        def setup(self, config):
            bound = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
            super().setup(config, **bound)

    _Bound.__name__ = trainable.__name__
    return _Bound


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable, type, Any] = None,
        *,
        param_space: Optional[Dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        resources = None
        nested_resources = None
        # Trainer instances (ray_tpu_torch.train) wrap themselves into a trainable.
        # The trial actor only coordinates — its BackendExecutor spawns the
        # actual train workers — so the trial claims trainer_resources
        # (default none) while the worker bundles enter the concurrency cap
        # as nested demand. Claiming worker bundles twice deadlocks the
        # cluster (trial actors hoard resources their own workers need).
        # The worker bundles hold the workers' "GPU" (ScalingConfig leases
        # one per worker unless use_gpu=False), so GPUs cap trial
        # concurrency: {"GPU": 0.25} per worker packs four trials a card.
        if hasattr(trainable, "as_trainable"):
            trainer = trainable
            sc = trainer.scaling_config
            resources = dict(sc.trainer_resources or {})
            # Explicit CPU 0: _actor_options defaults a missing CPU key to
            # 1.0, which would quietly re-grow the coordinator's footprint.
            resources.setdefault("CPU", 0.0)
            per_worker = sc.worker_resources()
            nested_resources = {
                k: v * sc.num_workers for k, v in per_worker.items()
            }
            if run_config is None:
                run_config = trainer.run_config
            trainable = trainer.as_trainable()
        if isinstance(trainable, _ResourceWrapped):
            resources = trainable.resources
            trainable = trainable.trainable
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._resources = resources
        self._nested_resources = nested_resources
        self._controller: Optional[TuneController] = None
        self._restore_state: Optional[dict] = None
        self._restore_dir: Optional[str] = None
        self._restore_flags: Dict[str, bool] = {}

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        callbacks = [cls() for cls in DEFAULT_CALLBACKS]
        callbacks += list(self._run_config.callbacks or [])
        self._controller = TuneController(
            self._trainable,
            self._param_space,
            metric=tc.metric,
            mode=tc.mode,
            num_samples=tc.num_samples,
            search_alg=tc.search_alg,
            scheduler=tc.scheduler,
            max_concurrent_trials=tc.max_concurrent_trials,
            time_budget_s=tc.time_budget_s,
            run_config=self._run_config,
            trial_resources=self._resources,
            nested_resources=self._nested_resources,
            reuse_actors=tc.reuse_actors,
            callbacks=callbacks,
            experiment_dir=self._restore_dir,
        )
        if self._restore_state is not None:
            self._controller.restore_experiment_state(
                self._restore_state, **self._restore_flags
            )
            self._restore_state = None
        trials = self._controller.run()
        return ResultGrid(
            trials,
            metric=tc.metric,
            mode=tc.mode,
            experiment_dir=self._controller.experiment_dir,
        )

    @classmethod
    def can_restore(cls, path: str) -> bool:
        """ray parity: Tuner.can_restore — a resumable experiment dir holds
        a state snapshot (tune/execution/experiment_state.py)."""
        import os

        return os.path.exists(os.path.join(path, TuneController.STATE_FILE))

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Union[Callable, type, Any],
        *,
        resume_errored: bool = False,
        restart_errored: bool = False,
    ) -> "Tuner":
        """Resume an interrupted experiment from its directory (ray parity:
        Tuner.restore). The trainable must be re-supplied (code is not
        persisted); trials that were in flight restart from their latest
        checkpoint, finished trials keep their results."""
        import os
        import pickle

        state_path = os.path.join(path, TuneController.STATE_FILE)
        with open(state_path, "rb") as f:
            state = pickle.load(f)
        tuner = cls(
            trainable,
            param_space=state.get("param_space"),
            tune_config=TuneConfig(
                metric=state.get("metric"),
                mode=state.get("mode"),
                num_samples=state.get("num_samples", 1),
            ),
            run_config=state.get("run_config"),
        )
        tuner._restore_state = state
        tuner._restore_dir = path
        tuner._restore_flags = {
            "resume_errored": resume_errored,
            "restart_errored": restart_errored,
        }
        return tuner

    def get_results(self) -> ResultGrid:
        if self._controller is None:
            raise RuntimeError("call fit() first")
        tc = self._tune_config
        return ResultGrid(
            self._controller.trials, metric=tc.metric, mode=tc.mode,
            experiment_dir=self._controller.experiment_dir,
        )


def run(
    trainable,
    *,
    config: Optional[Dict] = None,
    metric: Optional[str] = None,
    mode: Optional[str] = None,
    num_samples: int = 1,
    search_alg=None,
    scheduler=None,
    stop=None,
    resources_per_trial: Optional[Dict] = None,
    max_concurrent_trials: int = 0,
    time_budget_s: Optional[float] = None,
    name: Optional[str] = None,
    storage_path: Optional[str] = None,
    **_ignored,
) -> ResultGrid:
    """Legacy entry (ray parity: tune.run, tune/tune.py:295).

    ``resources_per_trial`` keys "cpu" and "gpu" become "CPU" and "GPU".
    A "tpu" or "TPU" key raises ``ValueError``: no node of the port
    advertises TPUs, so such a trial would stay pending for ever."""
    rc = RunConfig(name=name, storage_path=storage_path, stop=stop)
    t = trainable
    if resources_per_trial:
        if {"tpu", "TPU"} & set(resources_per_trial):
            raise ValueError(
                "resources_per_trial: the port's nodes advertise CUDA cards "
                "as \"GPU\" and no TPU; ask for {\"gpu\": n}")
        res = {k.upper() if k in ("cpu", "gpu") else k: v
               for k, v in resources_per_trial.items()}
        t = with_resources(trainable, res)
    tuner = Tuner(
        t,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            search_alg=search_alg,
            scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials,
            time_budget_s=time_budget_s,
        ),
        run_config=rc,
    )
    return tuner.fit()
