"""Trainers: BaseTrainer → DataParallelTrainer → TorchTrainer.

ray parity: python/ray/train/base_trainer.py:68 (BaseTrainer.fit:569),
data_parallel_trainer.py:58, torch/torch_trainer.py:16. The flagship is
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
        base_trainer.py:828): waits for the port's Tune."""
        raise NotImplementedError(
            "as_trainable waits for the port's Tune (ROADMAP queue 1, "
            "\"Tune and Data\")")


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
