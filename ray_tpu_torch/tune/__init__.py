"""ray_tpu_torch.tune: hyperparameter search over the actor runtime.

ray: python/ray/tune/ (tuner.py:47 Tuner, execution/trial_runner.py:583,
schedulers/async_hyperband.py, schedulers/pbt.py, search/basic_variant.py).

The trial session re-uses the train session plumbing: `tune.report()` inside
a trial function is the same facade as `train.session.report()`, so a
DataParallelTrainer running inside a trial actor streams its rank-0 reports
up to the tune scheduler automatically.
"""

from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

# user-facing in-trial facade (ray: ray.air.session / ray.tune.report)
from ray_tpu_torch.train.session import (
    get_checkpoint,
    report,
)

ASHAScheduler = AsyncHyperBandScheduler  # reference alias

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "Trial",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "run",
    "sample_from",
    "uniform",
]
