from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import (Backend, BackendConfig,
                                         TensorflowConfig, TorchConfig)
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  FailureBudgetExhaustedError,
                                                  TrainingFailedError)
from ray_tpu_torch.train.session import (GradSync, get_checkpoint, get_context,
                                         get_dataset_shard, report,
                                         set_overlap_grads, step_phase)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    SklearnTrainer,
    TensorflowTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.gbdt import LightGBMTrainer, XGBoostTrainer
from ray_tpu_torch.train.predictor import (BatchPredictor, Predictor,
                                           SklearnPredictor, TorchPredictor,
                                           XGBoostPredictor)
from ray_tpu_torch.train.worker_group import WorkerGroup

# The reference's JaxTrainer/JaxConfig/JaxPredictor are TorchTrainer/
# TorchConfig/TorchPredictor here.
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
    "TensorflowConfig",
    "TensorflowTrainer",
    "SklearnTrainer",
    "TrainingFailedError",
    "WorkerGroup",
    "GradSync",
    "get_checkpoint",
    "get_dataset_shard",
    "get_context",
    "report",
    "set_overlap_grads",
    "step_phase",
    "TransformersTrainer",
]


def __getattr__(name):
    # transformers imports are heavy; load the HF integration lazily
    if name == "TransformersTrainer":
        from ray_tpu_torch.train.huggingface import TransformersTrainer

        return TransformersTrainer
    raise AttributeError(name)
