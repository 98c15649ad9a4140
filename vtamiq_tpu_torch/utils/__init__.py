"""Host-side helpers: logging, metric accumulators, the scalar writer,
timers, seeding, retries, profiling, small iterators, image tools and the
measurement harness (port of ``vtamiq_tpu/utils``)."""

from .logging import Logger, FileLogger, log, log_warn, LogOnTaskComplete
from .accumulators import Mean, Max
from .timer import Timer
from .writer import SplitSummaryWriter
from .seeding import TemporaryNumpySeed, fold_seed
from .profiling import StepTimer, trace
from .iterators import looping_iterator, color_iterator, batched


def check_unused_kwargs(owner_name: str, **kwargs):
    """Warn on typo'd or unconsumed config keys."""
    if kwargs:
        log_warn(f"{owner_name}: unused kwargs: {sorted(kwargs.keys())}")


def float2str(value, precision: int = 4) -> str:
    return f"{float(value):.{precision}f}"


def float2str3(value) -> str:
    return float2str(value, 3)
