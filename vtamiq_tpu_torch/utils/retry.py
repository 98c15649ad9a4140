"""Retry with backoff for transient faults, and the faults never to retry
(port of ``vtamiq_tpu/utils/retry.py``).

``retry_transient`` retries a call whose error text names a transient fault.
Steps that change no state (the eval step) are retried this way; the train
step updates the parameters and the optimizer's state in place, so the
engine does not retry it: it rebuilds both from the latest checkpoint and
redoes the batch (``train/engine.py``). A CUDA error that poisons the
process's context (``poisons_context``) is never retried or recovered:
every later launch fails, so the run ends with it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

# Substrings identifying retriable transient faults in the exception text.
# Deliberately narrow: out-of-memory or invalid-argument errors are real
# errors a retry cannot fix.
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Socket closed",
    "Connection reset",
)

# CUDA errors after which the context is unusable (cudaErrorIllegalAddress,
# cudaErrorLaunchFailure, cudaErrorAssert, ...).
CONTEXT_POISONING_MARKERS = (
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "uncorrectable ECC",
)


def poisons_context(exc: BaseException) -> bool:
    msg = str(exc)
    return any(m in msg for m in CONTEXT_POISONING_MARKERS)


def is_transient(exc: BaseException,
                 markers: Sequence[str] = TRANSIENT_MARKERS) -> bool:
    if poisons_context(exc):
        return False
    msg = str(exc)
    return any(m in msg for m in markers)


def retry_transient(fn: Callable, *args,
                    max_retries: int = 2,
                    base_delay: float = 1.0,
                    markers: Sequence[str] = TRANSIENT_MARKERS,
                    log: Optional[Callable[[str], None]] = None,
                    sleep: Callable[[float], None] = time.sleep,
                    **kwargs):
    """Call ``fn(*args, **kwargs)``; on a transient fault retry up to
    ``max_retries`` times with exponential backoff. Other errors and the
    final failed attempt propagate unchanged."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — filtered by marker below
            if attempt >= max_retries or not is_transient(e, markers):
                raise
            delay = base_delay * (2.0 ** attempt)
            attempt += 1
            if log is not None:
                log(f"Transient device fault (retry {attempt}/{max_retries} "
                    f"in {delay:.1f}s): {str(e)[:200]}")
            sleep(delay)
