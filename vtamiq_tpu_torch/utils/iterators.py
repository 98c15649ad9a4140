"""Small iteration helpers (port of ``vtamiq_tpu/utils/iterators.py``)."""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, Sequence

DEFAULT_COLORS = ("b", "g", "r", "c", "m", "y", "k")


def looping_iterator(items: Sequence) -> Iterator:
    """Endlessly cycle over a sequence."""
    return itertools.cycle(items)


def color_iterator(colors: Sequence[str] = DEFAULT_COLORS) -> Iterator[str]:
    return looping_iterator(colors)


def batched(iterable: Iterable, n: int) -> Iterator[list]:
    """Yield lists of up to n consecutive items."""
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        yield batch
