"""ray_tpu_torch.tune — hyperparameter search (ray parity: python/ray/tune/).

Trials are actors on the ray_tpu_torch runtime; a trial over a trainer leases
its workers' GPUs (e.g. {"CPU": 1, "GPU": 0.25} per worker packs four trials
onto one card), and those GPUs cap how many trials run at once.
"""

from ray_tpu_torch.tune.analysis import ExperimentAnalysis
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.logger import Callback, CSVLoggerCallback, JsonLoggerCallback
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search.sample import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    qlograndint,
    qloguniform,
    qrandint,
    qrandn,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.session import (
    get_checkpoint,
    get_trial_id,
    get_trial_name,
    get_trial_resources,
    report,
)
from ray_tpu_torch.tune.stopper import (
    CombinedStopper,
    FunctionStopper,
    MaximumIterationStopper,
    Stopper,
    TimeoutStopper,
    TrialPlateauStopper,
)
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.tune.tuner import (
    TuneConfig,
    Tuner,
    run,
    with_parameters,
    with_resources,
)

__all__ = [
    "ExperimentAnalysis",
    "Callback",
    "CSVLoggerCallback",
    "CombinedStopper",
    "FunctionStopper",
    "JsonLoggerCallback",
    "MaximumIterationStopper",
    "ResultGrid",
    "Stopper",
    "TimeoutStopper",
    "Trainable",
    "Trial",
    "TrialPlateauStopper",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_trial_id",
    "get_trial_name",
    "get_trial_resources",
    "grid_search",
    "lograndint",
    "loguniform",
    "qlograndint",
    "qloguniform",
    "qrandint",
    "qrandn",
    "quniform",
    "randint",
    "randn",
    "report",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
    "with_resources",
]
