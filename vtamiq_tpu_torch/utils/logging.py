"""Console and file logging.

Port of ``vtamiq_tpu/utils/logging.py``: ``Logger`` prints when verbose,
``FileLogger`` also appends every message to a file (``filepath=None``
disables the file, as debug runs do), ``log``/``log_warn`` print through one
process-wide logger.
"""

from __future__ import annotations

import os
import sys
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
