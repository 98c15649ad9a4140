"""Streaming metric accumulators (port of ``vtamiq_tpu/utils/accumulators.py``)."""

from __future__ import annotations


class Mean:
    """Running average accumulator."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def add(self, value, weight: float = 1.0):
        self.total += float(value) * weight
        self.count += weight
        return self.value()

    def value(self):
        if self.count == 0:
            return 0.0
        return self.total / self.count

    def reset(self):
        self.total = 0.0
        self.count = 0


class Max:
    """Running maximum. ``add`` returns True when the new value is a new max —
    this drives the best-checkpoint policy (reference: train.py:851,876)."""

    def __init__(self):
        self._value = None

    def add(self, value) -> bool:
        value = float(value)
        if self._value is None or self._value < value:
            self._value = value
            return True
        return False

    def value(self):
        return self._value

    def reset(self):
        self._value = None
