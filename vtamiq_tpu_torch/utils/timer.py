"""Wall-clock timer with min/max/avg stats (port of ``vtamiq_tpu/utils/timer.py``)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, name: str = "Timer"):
        self.name = name
        self.reset()

    def reset(self):
        self._start = None
        self._elapsed = 0.0
        self.deltas = []

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is None:
            raise RuntimeError("Timer.stop() called before start().")
        delta = time.perf_counter() - self._start + self._elapsed
        self.deltas.append(delta)
        self._start = None
        self._elapsed = 0.0
        return delta

    def pause(self):
        if self._start is None:
            raise RuntimeError("Timer.pause() called before start().")
        self._elapsed += time.perf_counter() - self._start
        self._start = None

    def resume(self):
        self._start = time.perf_counter()

    @property
    def total(self):
        return sum(self.deltas)

    @property
    def avg(self):
        return self.total / len(self.deltas) if self.deltas else 0.0

    @property
    def min(self):
        return min(self.deltas) if self.deltas else 0.0

    @property
    def max(self):
        return max(self.deltas) if self.deltas else 0.0

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
