"""Profiling and throughput helpers (port of ``vtamiq_tpu/utils/profiling.py``).

``trace(logdir)`` records a ``torch.profiler`` trace with CPU and, where a
card is present, CUDA activity, and writes it as a Chrome trace under
``logdir`` (viewable in Perfetto or ``chrome://tracing``). ``StepTimer``
meters items per second over steps, synchronizing on the device of a result
so that the time is the device's and not the enqueue's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .timer import Timer


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``<logdir>/trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def synchronize_on(obj):
    """Wait for the devices that hold the tensors of ``obj`` (a tensor, or
    lists, tuples and dicts of them): ``torch.cuda.synchronize(device)`` for
    each CUDA device, nothing for CPU tensors."""
    for device in {t.device for t in _tensors(obj) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


class StepTimer:
    """Throughput meter for steps: call ``tick(items)`` after each step;
    ``block_on`` (a result of the step) synchronizes on its device first,
    so the time is the device's.

    Example:
        st = StepTimer()
        for batch in loader:
            out = step(...)
            st.tick(len(batch), block_on=out)
        print(st.summary("pairs"))
    """

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self._steps = 0
        self._items = 0
        self._t0 = None
        self.timer = Timer("steps")

    def tick(self, num_items: int, block_on=None):
        if block_on is not None:
            synchronize_on(block_on)
        now = time.perf_counter()
        self._steps += 1
        if self._steps <= self.warmup_steps:
            self._t0 = now  # exclude warmup steps (first launches, kernel builds)
            return
        self._items += num_items
        self.timer.deltas.append(now - self._t0)
        self._t0 = now

    @property
    def items_per_sec(self) -> float:
        total = self.timer.total
        return self._items / total if total > 0 else 0.0

    @property
    def sec_per_step(self) -> float:
        return self.timer.avg

    def summary(self, unit: str = "items") -> str:
        return (f"{self.items_per_sec:.2f} {unit}/sec "
                f"({self.sec_per_step * 1e3:.1f} ms/step, "
                f"{len(self.timer.deltas)} timed steps)")
