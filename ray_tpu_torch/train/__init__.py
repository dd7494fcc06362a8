from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  FailureBudgetExhaustedError,
                                                  TrainingFailedError)
from ray_tpu_torch.train.session import (GradSync, get_checkpoint, get_context,
                                         get_dataset_shard, report,
                                         set_overlap_grads, step_phase)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.predictor import (BatchPredictor, Predictor,
                                           SklearnPredictor, TorchPredictor,
                                           XGBoostPredictor)
from ray_tpu_torch.train.worker_group import WorkerGroup

# The reference's JaxTrainer/JaxConfig/JaxPredictor are TorchTrainer/
# TorchConfig/TorchPredictor here; its Sklearn, Tensorflow, GBDT and
# HuggingFace trainers are not ported yet (ROADMAP queue 1).
__all__ = [
    "BatchPredictor",
    "TorchPredictor",
    "Predictor",
    "SklearnPredictor",
    "XGBoostPredictor",
    "Backend",
    "BackendConfig",
    "BackendExecutor",
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureBudgetExhaustedError",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchConfig",
    "TorchTrainer",
    "TrainingFailedError",
    "WorkerGroup",
    "GradSync",
    "get_checkpoint",
    "get_dataset_shard",
    "get_context",
    "report",
    "set_overlap_grads",
    "step_phase",
]
