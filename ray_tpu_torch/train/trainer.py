"""Trainers: BaseTrainer → DataParallelTrainer → TorchTrainer (and the
TensorflowTrainer and SklearnTrainer that wrap other libraries).

ray parity: python/ray/train/base_trainer.py:68 (BaseTrainer.fit:569),
data_parallel_trainer.py:58, torch/torch_trainer.py:16,
tensorflow/tensorflow_trainer.py:108, sklearn/sklearn_trainer.py. The flagship is
TorchTrainer, the reference's NCCL-DDP path: each worker owns one CUDA card,
the gang forms one process group, and gradient reduction runs inside the
step (DDP's reducer or FSDP2's reduce-scatter).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap this trainer as a Tune trainable (ray parity:
        base_trainer.py:828) so Tuner(trainer) works."""
        trainer = self

        def _trainable(config):
            import copy

            t = copy.copy(trainer)
            merged = dict(getattr(t, "train_loop_config", None) or {})
            merged.update(config.get("train_loop_config", config) or {})
            t.train_loop_config = merged

            # Relay worker reports up through the Tune session so schedulers
            # see intermediate results (falls through to the Train session
            # when no Tune trial is active).
            from ray_tpu_torch.tune import session as session_mod

            def cb(metrics, checkpoint):
                session_mod.report(metrics, checkpoint=checkpoint)

            result = t._fit_impl(result_callback=cb)
            if result.error:
                raise result.error
            return result.metrics or {}

        _trainable.__name__ = type(self).__name__
        return _trainable


class DataParallelTrainer(BaseTrainer):
    """ray parity: train/data_parallel_trainer.py:58."""

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        super().__init__(
            scaling_config=scaling_config, run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint, datasets=datasets,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config

    def _runtime_env(self) -> Optional[dict]:
        env_vars = getattr(self.backend_config, "env_vars", None)
        if env_vars:
            return {"env_vars": dict(env_vars)}
        return None

    def _fit_impl(self, result_callback=None) -> Result:
        executor = BackendExecutor(
            self.backend_config, self.scaling_config, self.run_config
        )
        try:
            executor.start(
                runtime_env=self._runtime_env(),
                checkpoint=self.resume_from_checkpoint,
            )
            cfg = dict(self.train_loop_config)
            if self.datasets:
                cfg["__datasets__"] = self._shard_datasets()
            result = executor.run(
                self.train_loop_per_worker, cfg, result_callback=result_callback
            )
            return result
        except Exception as e:
            from ray_tpu_torch.train.backend_executor import TrainingFailedError

            err = e if isinstance(e, TrainingFailedError) else TrainingFailedError(str(e))
            return Result(metrics=None, checkpoint=None, error=err,
                          path=executor.trial_dir)
        finally:
            executor.shutdown()

    def _shard_datasets(self):
        """Attach per-worker dataset shards (streaming_split analog)."""
        out = {}
        for name, ds in self.datasets.items():
            try:
                out[name] = ds.streaming_split(self.scaling_config.num_workers)
            except AttributeError:
                out[name] = [ds] * self.scaling_config.num_workers
        return out

    def fit(self) -> Result:
        from ray_tpu_torch.train.backend_executor import FailureBudgetExhaustedError

        result = self._fit_impl()
        failure_cfg = self.run_config.failure_config
        retries = failure_cfg.max_failures
        # Gang failures (rank death, wedge) are recovered IN-PLACE by the
        # BackendExecutor against the same budget; a budget-exhausted
        # outcome is terminal and must not be retried from scratch here.
        # This outer loop remains the from-scratch fallback for
        # application errors, which the in-place path does not retry.
        while (result.error is not None and retries != 0
               and not isinstance(result.error, FailureBudgetExhaustedError)):
            retries -= 1
            result = self._fit_impl()
        if result.error is not None and self.run_config.failure_config.fail_fast:
            raise result.error
        return result


class TorchTrainer(DataParallelTrainer):
    """The port's flagship data-parallel trainer (ray parity:
    train/torch/torch_trainer.py:16; the role JaxTrainer plays on a TPU).

    One worker per CUDA card, one ``torch.distributed`` process group over
    the gang (NCCL on cards, gloo on CPUs: ``TorchConfig``); the loop wraps
    its model with ``gpt2.shard_train_state`` (DDP or FSDP2 over a
    ``parallel.create_mesh`` mesh) and reads its rank from
    ``ray_tpu_torch.train.get_context()``. ``overlap_grads=True`` arms
    ``session.GradSync`` overlap on every worker, as JaxTrainer's does.
    """

    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None,
                 overlap_grads: bool = False, **kwargs):
        tc = torch_config or TorchConfig()
        if overlap_grads:
            # arm session.GradSync overlap on every worker: gradient
            # allreduces run chunk-pipelined under the step's compute
            tc.overlap_grads = True
        super().__init__(
            train_loop_per_worker,
            backend_config=tc,
            **kwargs,
        )


class TensorflowTrainer(DataParallelTrainer):
    """ray parity: train/tensorflow/tensorflow_trainer.py:108 — workers get
    TF_CONFIG so MultiWorkerMirroredStrategy forms the collective ring.
    (On GPU clusters the port's flagship is TorchTrainer; this keeps TF
    workloads runnable for migration.)"""

    def __init__(self, train_loop_per_worker, *,
                 tensorflow_config: Optional["TensorflowConfig"] = None,
                 **kwargs):
        from ray_tpu_torch.train.backend import TensorflowConfig

        super().__init__(
            train_loop_per_worker,
            backend_config=tensorflow_config or TensorflowConfig(),
            **kwargs,
        )


class SklearnTrainer(DataParallelTrainer):
    """ray parity: train/sklearn/sklearn_trainer.py — fit one sklearn
    estimator on the full dataset on a single worker (sklearn has no
    distributed fit; N workers would each fit a partial model on a shard);
    the fitted model ships back as the checkpoint."""

    def __init__(self, *, estimator, datasets: dict,
                 label_column: str,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 fit_params: Optional[dict] = None, **kwargs):
        import cloudpickle

        if not datasets or "train" not in datasets:
            raise ValueError("SklearnTrainer requires datasets={'train': ...}")
        if not label_column:
            raise ValueError("SklearnTrainer requires label_column")
        scaling_config = scaling_config or ScalingConfig(num_workers=1)
        if scaling_config.num_workers != 1:
            raise ValueError(
                "SklearnTrainer fits one estimator on the full dataset; "
                f"num_workers must be 1, got {scaling_config.num_workers}"
            )
        est_blob = cloudpickle.dumps(estimator)
        label = label_column
        fit_params = fit_params or {}

        def train_loop():
            import cloudpickle as cp
            import numpy as np

            from ray_tpu_torch import train as train_mod
            from ray_tpu_torch.air import Checkpoint

            est = cp.loads(est_blob)
            ds = train_mod.get_dataset_shard("train")
            Xs, ys = [], []
            for batch in ds.iter_batches(batch_size=4096,
                                         batch_format="pandas"):
                ys.append(batch[label].to_numpy())
                Xs.append(batch.drop(columns=[label]).to_numpy())
            X = np.concatenate(Xs)
            y = np.concatenate(ys)
            est.fit(X, y, **fit_params)
            score = float(est.score(X, y))
            train_mod.report(
                {"train_score": score},
                checkpoint=Checkpoint.from_dict({"model": cp.dumps(est)}),
            )

        super().__init__(
            train_loop,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            **kwargs,
        )
