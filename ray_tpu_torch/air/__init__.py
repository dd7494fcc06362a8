from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree, save_pytree
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.session import get_checkpoint, get_context, report

# ray parity: ray.air.session.report etc (air/session.py)
class session:  # noqa: N801 — module-style namespace for parity
    report = staticmethod(report)
    get_checkpoint = staticmethod(get_checkpoint)
    get_context = staticmethod(get_context)


__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "load_pytree",
    "save_pytree",
    "session",
]
