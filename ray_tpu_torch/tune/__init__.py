"""ray_tpu_torch.tune — the experiment runner of the port (the JAX
package's ``ray_tpu.tune``; SURVEY.md §2.5, §7 step 7).

Hosts trainers and RL algorithms as trials: Tuner → TuneController → trial
processes (``util/procs.py``), with searchers (grid/random + pluggable
Searcher) and schedulers (FIFO/ASHA/MedianStopping/PBT). reference:
python/ray/tune.
"""
from .callbacks import (Callback, CSVLoggerCallback, JsonLoggerCallback,
                        TensorBoardLoggerCallback)
from .experiment import Trial
from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    Searcher,
    choice,
    grid_search,
    loguniform,
    qrandint,
    randint,
    randn,
    uniform,
)
from .trainable import FunctionTrainable, Trainable, get_checkpoint, report
from .tuner import ResultGrid, TrialResult, TuneConfig, Tuner, run, with_resources

__all__ = [
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "Callback",
    "ConcurrencyLimiter",
    "CSVLoggerCallback",
    "FIFOScheduler",
    "FunctionTrainable",
    "JsonLoggerCallback",
    "TensorBoardLoggerCallback",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "Trainable",
    "Trial",
    "TrialResult",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "qrandint",
    "randint",
    "randn",
    "report",
    "run",
    "uniform",
    "with_resources",
]
