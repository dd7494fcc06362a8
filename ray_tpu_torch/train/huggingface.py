"""HuggingFace Transformers integration for Train.

Reference parity: ray python/ray/train/huggingface/transformers/ —
``prepare_trainer`` + ``RayTrainReportCallback`` bridge a user-built
``transformers.Trainer`` into the Train session (log lines become
``train.report`` calls; HF checkpoint saves travel as Train checkpoints),
and ``TransformersTrainer`` runs the whole thing per worker inside the
torch process group (NCCL when the workers lease a GPU, gloo otherwise)
— HF's own Trainer picks up RANK/WORLD_SIZE
from the backend's env wiring and wraps the model in DDP itself.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from transformers.trainer_callback import TrainerCallback

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train import session
from ray_tpu_torch.train.backend import TorchConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


class RayTrainReportCallback(TrainerCallback):
    """transformers.TrainerCallback → ray_tpu_torch.train.report bridge.

    Log events report metrics immediately. HF fires on_log BEFORE
    on_save within the same step, so a saved checkpoint is reported from
    on_save, paired with the metrics that step just logged — checkpoint
    scoring (CheckpointConfig.checkpoint_score_attribute) then ranks each
    checkpoint by its own step's metrics, not the next step's."""

    def __init__(self):
        self._last_logs: dict = {}

    def _metrics(self, state):
        metrics = dict(self._last_logs)
        metrics["step"] = state.global_step
        if state.epoch is not None:
            metrics["epoch"] = state.epoch
        return metrics

    def on_log(self, args, state, control, logs=None, **kwargs):
        self._last_logs = dict(logs or {})
        session.report(self._metrics(state))

    def on_save(self, args, state, control, **kwargs):
        path = os.path.join(args.output_dir,
                            f"checkpoint-{state.global_step}")
        if os.path.isdir(path):
            session.report(self._metrics(state),
                           checkpoint=Checkpoint(path=path))


def prepare_trainer(trainer):
    """Attach the report bridge if absent (ray parity:
    train.huggingface.transformers.prepare_trainer)."""
    has = any(
        isinstance(cb, RayTrainReportCallback)
        for cb in trainer.callback_handler.callbacks
    )
    if not has:
        trainer.add_callback(RayTrainReportCallback())
    return trainer


class TransformersTrainer(DataParallelTrainer):
    """ray parity: train/huggingface/transformers — each worker calls
    ``trainer_init_per_worker(config) -> transformers.Trainer`` inside the
    ``TorchConfig`` process group and runs ``.train()``; reports/checkpoints flow
    through RayTrainReportCallback."""

    def __init__(self, trainer_init_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        def train_loop(config=None):
            trainer = trainer_init_per_worker(config or {})
            prepare_trainer(trainer)
            trainer.train()

        super().__init__(
            train_loop,
            backend_config=torch_config or TorchConfig(),
            **kwargs,
        )
