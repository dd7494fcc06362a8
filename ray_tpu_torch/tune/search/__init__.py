from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
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
from ray_tpu_torch.tune.search.searcher import ConcurrencyLimiter, Repeater, Searcher
from ray_tpu_torch.tune.search.bohb import BOHBSearcher
from ray_tpu_torch.tune.search.external import ExternalSearcherAdapter, OptunaSearch
from ray_tpu_torch.tune.search.tpe import TPESearcher

__all__ = [
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "Repeater",
    "Searcher",
    "TPESearcher",
    "BOHBSearcher",
    "ExternalSearcherAdapter",
    "OptunaSearch",
    "choice",
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
    "sample_from",
    "uniform",
]
