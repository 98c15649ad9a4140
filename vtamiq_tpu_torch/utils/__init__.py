"""Host-side helpers: logging, metric accumulators, the scalar writer,
timers, seeding, retries and small iterators (port of ``vtamiq_tpu/utils``)."""

from .logging import Logger, FileLogger, log, log_warn
from .accumulators import Mean, Max
from .timer import Timer
from .writer import SplitSummaryWriter


def check_unused_kwargs(owner_name: str, **kwargs):
    """Warn on typo'd or unconsumed config keys."""
    if kwargs:
        log_warn(f"{owner_name}: unused kwargs: {sorted(kwargs.keys())}")


def float2str(value, precision: int = 4) -> str:
    return f"{float(value):.{precision}f}"
