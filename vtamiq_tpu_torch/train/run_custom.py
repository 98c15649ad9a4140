"""Canned run entry points (port of ``vtamiq_tpu/train/run_custom.py``;
reference run_custom.py:5-62): mutate the config dicts, then call the
engine. They run on ``global_config["device"]`` ("cuda" unless set).

    python -m vtamiq_tpu_torch.train.run_custom
"""

from __future__ import annotations

import os

from . import config as C
from . import engine


def test_custom_vtamiq():
    """Test-only run on CSIQ with predefined split indices
    (reference run_custom.py:5-17)."""
    g = C.global_config
    g["load_checkpoint_file"] = None
    g["do_train"] = False
    g["do_val"] = False
    g["do_test"] = True
    g["dataset"] = C.DATASET_CSIQ
    C.dataset_split_config_base["split_type"] = C.SPLIT_TYPE_INDICES
    return engine.train()


def custom_test(checkpoint_file: str):
    """Evaluate a checkpoint on the PieAPP test set
    (reference run_custom.py:20-36)."""
    g = C.global_config
    g["load_checkpoint_file"] = checkpoint_file
    g["model"] = C.MODEL_VTAMIQ
    g["do_train"] = False
    g["do_val"] = False
    g["do_test"] = True
    g["dataset"] = C.DATASET_PIEAPP_TEST
    C.dataset_split_config_base["split_type"] = C.SPLIT_TYPE_INDICES
    return engine.train()


def custom_run():
    """Debug train+val+test on TID2013 (reference run_custom.py:39-58,
    the default __main__ path)."""
    g = C.global_config
    g["is_debug"] = True
    g["dataloader_num_workers"] = 1

    g["model"] = C.MODEL_VTAMIQ
    g["load_checkpoint_file"] = None
    g["do_train"] = True
    g["do_val"] = True
    g["do_test"] = True
    g["allow_use_full_dataset_test"] = False
    g["dataset"] = C.DATASET_TID2013
    g["num_epochs"] = 20
    g["optimizer_learning_rate"] = 0.0001
    g["scheduler_type"] = "lambda"
    return engine.train()


def pretrain_kadis_then_finetune(kadis_epochs: int = 1,
                                 finetune_dataset: str = None,
                                 finetune_epochs: int = 3):
    """The weak-label workflow: pretrain on KADIS-700k (weak VTAMIQ labels,
    kadis700k_vtamiq.csv), then fine-tune the saved checkpoint on a labeled
    dataset through the pretraining gates (pretraining_config). Returns
    (pretrain_checkpoint_path, finetune_correlations)."""
    g = C.global_config

    # --- phase 1: KADIS weak-label pretrain (train-only, full dataset) ---
    g["dataset"] = C.DATASET_KADIS700K
    C.dataset_split_config_base["split_type"] = C.SPLIT_TYPE_INDICES
    g["do_train"], g["do_val"], g["do_test"] = True, False, False
    g["num_epochs"] = kadis_epochs
    g["train_save_latest"] = True
    g["load_checkpoint_file"] = None
    engine.train()
    ckpt = os.path.join(g["output_dir_final"], "latest.npz")

    # --- phase 2: labeled fine-tune through the pretraining gates ---
    g["dataset"] = finetune_dataset or C.DATASET_TID2013
    C.dataset_split_config_base["split_type"] = C.SPLIT_TYPE_RANDOM
    g["do_train"], g["do_val"], g["do_test"] = True, True, True
    g["num_epochs"] = finetune_epochs
    g["load_checkpoint_file"] = ckpt
    correlations = engine.train()
    return ckpt, correlations


if __name__ == "__main__":
    custom_run()
