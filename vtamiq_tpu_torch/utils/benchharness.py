"""Measurement harness (port of ``vtamiq_tpu/utils/benchharness.py``).

- ``timed_stats`` repeats a timed call and reports the median, min and max
  rate; each call's result is consumed by ``synchronize_on`` (a
  ``torch.cuda.synchronize`` on the devices that hold its tensors), so the
  host clock measures the device's work and not its enqueue;
- readings faster than the physical bound (``bound`` pairs per second, from
  the card's peak rates) are rejected as impossible, and ``ImplausiblyFast``
  is raised when no trial survives: a timing that beats physics measured
  nothing;
- ``fresh_pair_batch`` makes a time-seeded batch on the device, so no two
  calls time the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .profiling import synchronize_on

__all__ = ["fresh_pair_batch", "timed_median", "timed_stats", "ImplausiblyFast"]


class ImplausiblyFast(RuntimeError):
    """Every trial returned faster than the card's peak rates allow."""


def fresh_pair_batch(batch: int, h: int, w: int, seed_extra: int = 0, device="cuda"):
    """A time-seeded (batch, 2, h, w, 3) fp32 tensor of ref/dist raw images
    in [0, 1) on ``device``, and a ``torch.Generator`` seeded the same way.
    The copy to the device is finished before it returns."""
    s = (int(time.time_ns()) + seed_extra) & 0x7FFFFFFF
    r = np.random.default_rng(s)
    raw = torch.from_numpy(r.uniform(0, 1, (batch, 2, h, w, 3)).astype(np.float32)).to(device)
    synchronize_on(raw)
    return raw, torch.Generator().manual_seed(s)


def timed_stats(fn, pairs_per_call: float, bound: float, trials: int = 3) -> dict:
    """{median, min, max, trials} pairs per second over ``trials`` plausible
    timings of ``fn(t)``, t the trial index (callers may vary their inputs
    with it). ``fn`` returns its result (tensors, or lists, tuples and dicts
    of them), on which the timing synchronizes. Readings implying a rate
    past ``bound`` pairs per second are discarded; raises ImplausiblyFast if
    no trial survives (two spare attempts are allowed)."""
    min_dt = pairs_per_call / bound
    times = []
    for t in range(trials + 2):
        t0 = time.perf_counter()
        synchronize_on(fn(t))
        dt = time.perf_counter() - t0
        if dt >= min_dt:
            times.append(dt)
        if len(times) >= trials:
            break
    if not times:
        raise ImplausiblyFast(f"all trials faster than the bound of {bound} pairs/s")
    rates = sorted(pairs_per_call / dt for dt in times)
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "trials": len(rates)}


def timed_median(fn, pairs_per_call: float, bound: float, trials: int = 2) -> float:
    """Median pairs per second (see ``timed_stats``); with an even trial
    count, the upper middle rate."""
    return timed_stats(fn, pairs_per_call, bound, trials)["median"]
