from ray_tpu_torch.tune.schedulers.async_hyperband import (
    ASHAScheduler,
    AsyncHyperBandScheduler,
)
from ray_tpu_torch.tune.schedulers.hyperband import HyperBandForBOHB, HyperBandScheduler
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pbt import PB2, PopulationBasedTraining
from ray_tpu_torch.tune.schedulers.resource_changing import (
    DistributeResources,
    ResourceChangingScheduler,
)
from ray_tpu_torch.tune.schedulers.trial_scheduler import FIFOScheduler, TrialScheduler

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "FIFOScheduler",
    "HyperBandForBOHB",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "DistributeResources",
    "PB2",
    "PopulationBasedTraining",
    "ResourceChangingScheduler",
    "TrialScheduler",
]
