"""Tune on the port's runtime. Port of ray_tpu/tune: search spaces and
searchers, trial schedulers, and the Tuner, whose trials are the port's
TrainWorker actors (a GPU in resources_per_trial leases a card or a
share of one). The reference's record_library_usage call is left out,
as in the port's other library packages: the port has no usage_stats
yet."""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    ExternalSearcher,
    OptunaSearch,
    Searcher,
    TPESearcher,
    bohb,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "ASHAScheduler", "FIFOScheduler",
    "HyperBandScheduler", "PopulationBasedTraining", "MedianStoppingRule",
    "ResourceChangingScheduler", "Searcher", "BasicVariantGenerator",
    "TPESearcher", "uniform", "loguniform", "choice", "randint", "quniform",
    "grid_search", "PB2", "ExternalSearcher", "OptunaSearch", "bohb",
]
