"""Host-side RNG helpers (port of ``vtamiq_tpu/utils/seeding.py``).

``TemporaryNumpySeed`` pins numpy's global RNG for a block and restores its
state on exit; ``fold_seed`` derives a stable 31-bit seed from any parts.
"""

from __future__ import annotations

import zlib

import numpy as np


class TemporaryNumpySeed:
    """Context manager: save/restore the numpy global RNG around a seed.
    ``seed=None`` leaves the RNG untouched."""

    def __init__(self, seed=None):
        self.seed = seed
        self._state = None

    def __enter__(self):
        if self.seed is not None:
            self._state = np.random.get_state()
            np.random.seed(self.seed)
        return self

    def __exit__(self, *exc):
        if self._state is not None:
            np.random.set_state(self._state)
        return False


def fold_seed(*parts) -> int:
    """Derive a stable 31-bit seed from arbitrary hashable parts."""
    data = "|".join(str(p) for p in parts).encode()
    return zlib.crc32(data) & 0x7FFFFFFF
