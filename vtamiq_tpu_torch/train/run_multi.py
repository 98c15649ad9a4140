"""Multi-run cross-validation: N train/val/test runs with random re-splits,
aggregated mean/median/std stats (port of ``vtamiq_tpu/train/run_multi.py``;
reference run_multi.py:9-65).

    python -m vtamiq_tpu_torch.train.run_multi
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..ops.correlations import SROCC_FIELD, KROCC_FIELD, PLCC_FIELD, RMSE_FIELD
from ..utils.logging import FileLogger
from . import config as C
from . import engine


def parse_runs(runs, logger):
    """Aggregate correlation stats across runs (reference run_multi.py:9-21)."""
    fields = [SROCC_FIELD, KROCC_FIELD, PLCC_FIELD, RMSE_FIELD]
    stats = {}
    for field in fields:
        result = np.asarray([run[field] for run in runs], float)
        stats[field] = dict(mean=float(np.mean(result)),
                            median=float(np.median(result)),
                            std=float(np.std(result)))
        logger("{}: mean=[{}], median=[{}], std.dev.=[{}]".format(
            field, stats[field]["mean"], stats[field]["median"], stats[field]["std"]))
    return stats


def main(num_runs: int = 20, dataset: str = C.DATASET_LIVE):
    g = C.global_config
    g["dataset"] = dataset
    C.dataset_split_config_base["split_type"] = C.SPLIT_TYPE_RANDOM

    g["do_train"] = True
    g["do_val"] = True
    g["do_test"] = True
    g["train_save_latest"] = True

    g["optimizer_learning_rate"] = 0.0001
    g["num_epochs"] = 20
    g["optimizer_decay_after_n_epochs"] = [10, 15]
    g["scheduler_type"] = "multistep"
    g["optimizer_learning_rate_decay_multistep"] = 0.1

    output_dir = "./output/{}-multirun-{}".format(int(time.time()), C.dataset_target())
    os.makedirs(output_dir, exist_ok=True)
    logger = FileLogger(f"{output_dir}/results.txt", verbose=True)

    runs = []
    for i in range(num_runs):
        logger("Starting run", i)
        g["output_dir"] = output_dir
        C.reset_configs_validation()  # re-validate: random split re-draws per run
        run = engine.train()
        logger("Finished run", i, ":", run)
        runs.append(run)

    return parse_runs(runs, logger)


if __name__ == "__main__":
    main()
