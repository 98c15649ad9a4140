"""Split-namespaced scalar writer (port of ``vtamiq_tpu/utils/writer.py``).

Tags are namespaced ``<Split>/<n>.<tag>``; values are averaged between
writes and flushed every ``log_every_n_steps`` steps, or at once with
``force_add=True``. Every value goes to ``scalars.jsonl`` in the log
directory. Where tensorboardX is installed, the same values also go to a
TensorBoard event file; it is imported here, when a writer is made, and
its absence changes nothing else.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from .accumulators import Mean


def _tensorboard_writer(logdir: str, **tb_kwargs):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir=logdir, **tb_kwargs)


class SplitSummaryWriter:
    def __init__(self, logdir: str, log_every_n_steps: int = 10, **tb_kwargs):
        self.logdir = logdir
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        os.makedirs(logdir, exist_ok=True)
        self._tb = _tensorboard_writer(logdir, **tb_kwargs)
        self._jsonl_path = os.path.join(logdir, "scalars.jsonl")
        self._means: Dict[str, Mean] = {}
        self._tag_counters: Dict[str, int] = {}

    def _full_tag(self, split_name: str, tag: str) -> str:
        if tag not in self._tag_counters:
            self._tag_counters[tag] = len(self._tag_counters)
        return f"{split_name}/{self._tag_counters[tag]}.{tag}"

    def add_scalar(self, split_name: str, tag: str, value, step: int, force_add: bool = False):
        full_tag = self._full_tag(split_name, tag)
        mean = self._means.setdefault(full_tag, Mean())
        mean.add(float(value))
        if force_add or (step % self.log_every_n_steps == 0):
            self._write(full_tag, mean.value(), step)
            mean.reset()

    def _write(self, full_tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(full_tag, value, step)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps({"tag": full_tag, "value": value, "step": int(step)}) + "\n")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
