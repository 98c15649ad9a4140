"""Console and file logging.

Port of ``vtamiq_tpu/utils/logging.py``: ``Logger`` prints when verbose,
``FileLogger`` also appends every message to a file (``filepath=None``
disables the file, as debug runs do), ``log``/``log_warn`` print through one
process-wide logger, ``LogOnTaskComplete`` logs a named task's start, end
and seconds.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional


class Logger:
    """Callable logger printing to stdout when verbose."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose

    def __call__(self, *args, **kwargs):
        if self.verbose:
            print(*args, **kwargs)
            sys.stdout.flush()


class FileLogger(Logger):
    """Logger that also appends every message to ``filepath`` (None: no file)."""

    def __init__(self, filepath: Optional[str], verbose: bool = True):
        super().__init__(verbose=verbose)
        self.filepath = filepath
        if filepath is not None:
            directory = os.path.dirname(filepath)
            if directory:
                os.makedirs(directory, exist_ok=True)

    def __call__(self, *args, **kwargs):
        super().__call__(*args, **kwargs)
        if self.filepath is not None:
            with open(self.filepath, "a") as f:
                print(*args, file=f, **kwargs)


_global_logger = Logger(verbose=True)


def log(*args, **kwargs):
    _global_logger(*args, **kwargs)


def log_warn(*args, tag: str = "WARNING", **kwargs):
    _global_logger(f"[{tag}]", *args, **kwargs)


class LogOnTaskComplete:
    """Context manager logging the start and the end (with its seconds, and
    the exception's name on failure) of a named task."""

    def __init__(self, task_name: str, logger: Optional[Logger] = None):
        self.task_name = task_name
        self.logger = logger if logger is not None else _global_logger
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        self.logger(f"[{self.task_name}] started.")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self._t0
        status = "completed" if exc_type is None else f"FAILED ({exc_type.__name__})"
        self.logger(f"[{self.task_name}] {status} in {dt:.2f}s.")
        return False
