"""Layered run-configuration system.

Port of ``vtamiq_tpu/train/config.py``: the module-level mutable config
dicts with the reference's knob names (global_config, vit_config,
vtamiq_config, pretraining_config, freeze_config and the freeze dicts,
dataset_config_base, the dataloader configs, the split tables), the same
``validate_configs()`` derivation rules, the dataset and loader factories,
and the reproducibility dump (``save_configs``/``save_code``).

Run scripts mutate these dicts, then call
``vtamiq_tpu_torch.train.engine.train()``. ``global_config["device"]``
(default "cuda") is where the engine runs; pass "cpu" to run on the CPU.
The config dumps are YAML written by a small emitter of this module's own
(``to_yaml``), for the nested dicts, lists and scalars the configs hold.
"""

from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from copy import deepcopy
from typing import Dict

import json
import math

import numpy as np

from ..data import datasets as D
from ..data.pipeline import PatchDatasetLoader
from ..models.configs import (
    get_vit_config, VTAMIQConfig, VIT_VARIANT_B8, VIT_VARIANT_B16,
)
from ..ops.sampling import GRID_TYPE_PERTURBED_SIMPLE
from ..utils.logging import log, log_warn

# ************** CONSTANTS **************

DATASET_TID2013 = "TID2013"
DATASET_TID2008 = "TID2008"
DATASET_LIVE = "LIVE"
DATASET_CSIQ = "CSIQ"
DATASET_PIEAPP_TEST = "PieAPPTestset"
DATASET_PIEAPP_TRAIN = "PieAPPTrainset"
DATASET_PIPAL = "PIPAL"
DATASET_PIPAL_VAL = "PIPALVal"
DATASET_PIPAL_VAL22 = "PIPALVal22"
DATASET_PIPAL_TEST = "PIPALTest"
DATASET_PIPAL_TEST22 = "PIPALTest22"
DATASET_KADID10K = "KADID10k"
DATASET_KADIS700K = "KADIS700k"
DATASET_KONIQ10K = "KonIQ10k"

SPLIT_NAME_TRAIN = "Training"
SPLIT_NAME_VAL = "Validation"
SPLIT_NAME_TEST = "Testing"
SPLIT_NAME_FULL = "FullDataset"

SPLIT_TYPE_RANDOM = "random"
SPLIT_TYPE_INDICES = "indices"

PATCH_COUNT = "patch_count"
BATCH_SIZE = "batch_size"
SHUFFLE = "shuffle"
PATCH_FLIP = "allow_img_flip"
IMG_ZERO_ERROR_Q_PROB = "img_zero_error_q_prob"
USE_ALIGNED_PATCHES = "use_aligned_patches"
NUM_REPEATS_DATA = "num_repeats_data"
DATALOADER_PARAMS = "dataloader_params"
USE_DEFAULT_PARAMS = "use_default_params"

MODEL_VTAMIQ = "VTAMIQ"

MODEL_STATE_DICT = "model_state_dict"
PREF_MODULE_STATE_DICT = "pref_module_state_dict"

models_vtamiq = {MODEL_VTAMIQ}

# ************** CONFIGS **************

global_config = OrderedDict(
    is_debug=False,
    is_verbose=True,

    dataloader_num_workers=-1,   # -1: per-dataset table below (maps to
                                 # the loader's prefetch depth)
    dataloader_pin_memory=True,  # pinned host batches when the device is CUDA
    dataloader_persistent_workers=True,  # kept for API parity

    no_cuda=False,  # API parity; the device is global_config["device"]
    device="cuda",  # where the engine runs: "cuda" (default) or "cpu"

    do_train=False,
    do_val=False,
    do_test=True,

    num_repeats_val=1,
    num_repeats_test=4,

    train_save_latest=True,
    test_use_latest=True,

    model=MODEL_VTAMIQ,

    use_pu=False,
    use_pref_module=False,

    dataset=DATASET_TID2013,
    dataset_test=None,
    allow_use_full_dataset=True,
    allow_use_full_dataset_test=True,

    load_checkpoint_file=None,
    resume_checkpoint_file=None,  # full resume: params + optimizer + epoch
    # (new capability — the reference only reloads model weights and restarts
    # the schedule; requires the checkpoint to have been saved with
    # save_optimizer=True)
    vit_weights_path=None,  # ViT-B_16-layout .npz (ImageNet pretrain)

    seed=-1,

    num_epochs=20,

    optimizer="AdamW",
    optimizer_weight_decay=0.01,
    optimizer_learning_rate=0.00005,

    scheduler_step_per_batch=False,
    scheduler_type="lambda",
    optimizer_learning_rate_decay_multistep=0.1,
    optimizer_learning_rate_decay_lambda_goal=0.01,
    optimizer_learning_rate_decay_cosine=0.01,
    optimizer_decay_after_n_epochs=[10, 15],
    optimizer_sgd_momentum=0.9,
    optimizer_sgd_nesterov=True,

    grad_scale=256,  # API parity; bf16 needs no loss scaling

    weight_mae_loss=0.75,
    weight_rank_loss=1.0,
    weight_pears_loss=0.2,
    use_weighted_loss=False,  # reference behavior: weights ignored,
                              # optimized loss = rank + pears (train.py:387-395)

    weight_mae_loss_decay=1.0,
    weight_rank_loss_decay=1.0,
    weight_pears_loss_decay=1.0,

    print_flops=False,
    print_params=False,

    checkpoint_every_n_batches=3000,

    tensorlog_every_n_steps=10,
    num_batches_for_correlation=8,

    output_tag="",
    output_dir="./output",
    output_txt="output.txt",
    debug_txt="debug.txt",

    save_optimizer=False,
    save_code_folder="source_code",

    save_val_outputs=True,
    save_test_outputs=True,
    save_test_outputs_txt="output_qs.txt",

    # "bfloat16" | "mixed" | "float32". From-scratch small-batch/tiny-
    # dataset training should use "float32" AND, on variable-size datasets,
    # max_size_buckets > 0 so batches mix references: a bf16 stream
    # collapses a fraction of seeds there, "mixed" (fp32 residual stream,
    # bf16 matmuls) reduces the risk, and exact-size batching confines a
    # batch to one reference size with its q-spread down to 0, while the
    # rank and Pearson losses are batch-relative (docs/PARITY.md)
    compute_dtype="bfloat16",
    mesh_data=1,   # data / tensor / sequence parallel axis sizes of a
    mesh_model=1,  # multi-process mesh (parallel/); their product must be
    mesh_seq=1,    # the world size of the initialized process group, and
    # all 1 under a world > 1 means data = world. mesh_seq > 1 runs attention
    # through the ring; batch sizes are per data rank (global = batch * data)
    max_size_buckets=0,  # >0: pad variable-size images to <= this many
    # canonical (H, W) buckets (LIVE/KADIS); 0 = batch by exact size
    device_fault_retries=2,  # retries of an eval step on a transient fault
    # (utils/retry.py; 0 disables)

    config_validated=False,
)

vit_config = OrderedDict(
    variant=VIT_VARIANT_B16,
    use_cls_token=True,
    pretrained=True,
    num_keep_layers=6,
    num_adapters=0,
    num_scales=0,
    num_extra_tokens=8,
    use_layer_scale=True,
    path_drop_prob=0.1,
)

vtamiq_config = OrderedDict(
    vit_config=vit_config,
    calibrate=True,
    diff_scale=True,
    num_rgs=4,
    num_rcabs=4,
    ca_reduction=16,
    rg_path_drop=0.1,
    predictor_dropout=0.1,
)

pretraining_config = OrderedDict(
    allow_pretrained_vit=True,
    allow_pretrained_weights=True,
    allow_pretrained_weights_vit=True,
    allow_pretrained_weights_diffnet=True,
)

freeze_config = OrderedDict(
    freeze_vtamiq=False,
    freeze_conditional=False,
    freeze_end_after_epochs={
        DATASET_TID2013: 2,
        DATASET_TID2008: 2,
        DATASET_LIVE: 3,
        DATASET_CSIQ: 2,
        DATASET_PIPAL: 1,
        DATASET_PIPAL_VAL: 0,
        DATASET_PIPAL_VAL22: 0,
        DATASET_PIPAL_TEST: 0,
        DATASET_PIPAL_TEST22: 0,
        DATASET_PIEAPP_TRAIN: 1,
        DATASET_PIEAPP_TEST: 0,
        DATASET_KADID10K: 1,
        DATASET_KADIS700K: 1,
        DATASET_KONIQ10K: 1,
    },
)

freeze_dict_vit = OrderedDict(
    freeze_encoder=True,
    freeze_encoder_adapters=False,
    freeze_encoder_layerscale=False,
    freeze_embeddings_patch=True,
    freeze_embeddings_cls_token=True,
    freeze_embeddings_extra_tokens=True,
    freeze_embeddings_pos=True,
    freeze_embeddings_scale=False,
)

freeze_dict_vtamiq = OrderedDict(
    freeze_dict_vit=freeze_dict_vit,
    freeze_quality_decoder=False,
    freeze_q_predictor=False,
    freeze_w_predictor=False,
)

pref_module_config = OrderedDict(
    weight=6.0,
)

dataset_config_base = OrderedDict(
    full_reference=True,
    patch_dim=-1,  # derived by validate_configs()
    patch_num_scales=1,
    normalize=True,
    normalize_imagenet=False,
    patch_sampling_num_scales_ratio=1.75,
    # shuffle the final patch sequence across scales (reference
    # get_iqa_patches kwarg, patch_sampling.py:458; never enabled there)
    randomize_patch_scale_order=False,
    patch_sampler_config=OrderedDict(
        uniform_weight=0.1,
        grid_type=GRID_TYPE_PERTURBED_SIMPLE,
    ),
)

dataset_split_config_base = OrderedDict(
    split_type=SPLIT_TYPE_INDICES,
)

num_workers_config = {
    DATASET_LIVE: 6,
    DATASET_TID2008: 6,
    DATASET_CSIQ: 6,
    DATASET_TID2013: 8,
    DATASET_PIEAPP_TEST: 4,
    DATASET_KADIS700K: 8,
    DATASET_KADID10K: 8,
    DATASET_PIPAL: 8,
    DATASET_PIPAL_VAL: 8,
    DATASET_PIPAL_VAL22: 8,
    DATASET_PIPAL_TEST: 8,
    DATASET_PIPAL_TEST22: 8,
    DATASET_PIEAPP_TRAIN: 8,
    DATASET_KONIQ10K: 8,
}

dataloader_config_base = {
    SPLIT_NAME_TRAIN: {
        BATCH_SIZE: 16, SHUFFLE: True, PATCH_COUNT: 384, PATCH_FLIP: True,
        IMG_ZERO_ERROR_Q_PROB: -1, USE_ALIGNED_PATCHES: True, NUM_REPEATS_DATA: 1,
    },
    SPLIT_NAME_VAL: {
        BATCH_SIZE: 16, SHUFFLE: False, PATCH_COUNT: 1024, PATCH_FLIP: False,
        IMG_ZERO_ERROR_Q_PROB: -1, USE_ALIGNED_PATCHES: True, NUM_REPEATS_DATA: 1,
    },
    SPLIT_NAME_TEST: {
        BATCH_SIZE: 16, SHUFFLE: False, PATCH_COUNT: 1024, PATCH_FLIP: False,
        IMG_ZERO_ERROR_Q_PROB: -1, USE_ALIGNED_PATCHES: True, NUM_REPEATS_DATA: 1,
    },
    DATALOADER_PARAMS: {USE_DEFAULT_PARAMS: False},
}

dataloader_config_vtamiq = {
    SPLIT_NAME_TRAIN: {BATCH_SIZE: 16, PATCH_COUNT: 384},
    SPLIT_NAME_VAL: {BATCH_SIZE: 16, PATCH_COUNT: 512},
    SPLIT_NAME_TEST: {BATCH_SIZE: 16, PATCH_COUNT: 512},
}

# ************** SPLIT TABLES **************


def setup_split_indices(ind):
    if isinstance(ind, list):
        return ind
    if isinstance(ind, tuple):
        if len(ind) > 3:
            raise ValueError(f"Unsupported tuple format for split indices: [{ind}]")
        return list(range(*ind))
    if isinstance(ind, int):
        return [0] if ind == 0 else list(range(ind))
    raise ValueError(f"Unsupported index format for split indices: [{ind}]")


def setup_split_config(i_n1, i_n2, i_n3):
    return {
        SPLIT_NAME_TRAIN: setup_split_indices(i_n1),
        SPLIT_NAME_VAL: setup_split_indices(i_n2),
        SPLIT_NAME_TEST: setup_split_indices(i_n3),
    }


split_config_random = {SPLIT_NAME_TRAIN: 6, SPLIT_NAME_VAL: 2, SPLIT_NAME_TEST: 2}

split_config_tid2013 = setup_split_config(15, (15, 20), (20, 25))
split_config_tid2008 = deepcopy(split_config_tid2013)
split_config_live = setup_split_config(17, (17, 23), (23, 28))
split_config_csiq = setup_split_config(18, (18, 24), (24, 30))
split_config_pieapptrain = setup_split_config(130, (130, 135), (135, 140))
split_config_pieapptest = setup_split_config(0, 0, 40)
split_config_pipal = setup_split_config(160, (160, 200), (160, 200))
split_config_pipaltest = setup_split_config(0, 0, 25)
split_config_kadid10k = setup_split_config(49, (49, 65), (65, 81))
split_config_kadis700k = setup_split_config(134260, 0, 0)
split_config_koniq10k = setup_split_config(7000, (7000, 8000), (8000, 10073))

_DATASET_REGISTRY = {
    DATASET_TID2013: (D.TID2013Dataset, split_config_tid2013),
    DATASET_TID2008: (D.TID2008Dataset, split_config_tid2008),
    DATASET_LIVE: (D.LIVEDataset, split_config_live),
    DATASET_CSIQ: (D.CSIQDataset, split_config_csiq),
    DATASET_KADID10K: (D.KADID10kDataset, split_config_kadid10k),
    DATASET_KADIS700K: (D.KADIS700kDataset, split_config_kadis700k),
    DATASET_PIEAPP_TRAIN: (D.PieAPPTrainPairwise, split_config_pieapptrain),
    DATASET_PIEAPP_TEST: (D.PieAPPTestset, split_config_pieapptest),
    DATASET_PIPAL: (D.PIPAL, split_config_pipal),
    DATASET_PIPAL_VAL: (D.PIPALVal, split_config_pipaltest),
    DATASET_PIPAL_VAL22: (D.PIPALVal22, split_config_pipaltest),
    DATASET_PIPAL_TEST: (D.PIPALTest, split_config_pipaltest),
    DATASET_PIPAL_TEST22: (D.PIPALTest22, split_config_pipaltest),
    DATASET_KONIQ10K: (D.KonIQ10kDataset, split_config_koniq10k),
}

_SPLIT_CONFIG_DUMP_NAMES = {
    DATASET_TID2013: ("tid2013_split_config", split_config_tid2013),
    DATASET_TID2008: ("tid2008_split_config", split_config_tid2008),
    DATASET_LIVE: ("live_split_config", split_config_live),
    DATASET_KADID10K: ("kadid10k_split_config", split_config_kadid10k),
    DATASET_KADIS700K: ("kadis700k_split_config", split_config_kadis700k),
    DATASET_PIPAL: ("pipal_split_config", split_config_pipal),
    DATASET_PIPAL_TEST: ("pipaltest_split_config", split_config_pipaltest),
    DATASET_PIPAL_VAL: ("pipaltest_split_config", split_config_pipaltest),
    DATASET_PIPAL_VAL22: ("pipaltest_split_config", split_config_pipaltest),
    DATASET_PIPAL_TEST22: ("pipaltest_split_config", split_config_pipaltest),
    DATASET_CSIQ: ("csiq_split_config", split_config_csiq),
    DATASET_PIEAPP_TRAIN: ("pieapptrain_split_config", split_config_pieapptrain),
    DATASET_PIEAPP_TEST: ("pieapp_split_config", split_config_pieapptest),
    DATASET_KONIQ10K: ("koniq10k_split_config", split_config_koniq10k),
}

# ************** DERIVED HELPERS **************


def dataset_target():
    return global_config["dataset"]


def model_uses_scales():
    if global_config["model"] in models_vtamiq:
        return vit_config["num_scales"] > 1
    return False


def dataset_uses_scales():
    return dataset_config_base["patch_num_scales"] > 1


def training_run_uses_scales():
    return dataset_uses_scales() and model_uses_scales()


def dataset_is_pairwise(dataset_name):
    return dataset_name == DATASET_PIEAPP_TRAIN


def build_model_config() -> VTAMIQConfig:
    """Materialize the typed model config from the mutable dicts."""
    overrides = dict(
        num_keep_layers=vit_config["num_keep_layers"],
        num_extra_tokens=vit_config["num_extra_tokens"],
        num_scales=vit_config["num_scales"],
        num_adapters=vit_config["num_adapters"],
        use_cls_token=vit_config["use_cls_token"],
        use_layer_scale=vit_config["use_layer_scale"],
        path_drop_prob=vit_config["path_drop_prob"],
        vit_weights_path=global_config.get("vit_weights_path"),
    )
    # optional architecture overrides (scaled-down test configs; remat for
    # long patch sequences)
    for knob in ("hidden_size", "mlp_dim", "num_heads", "num_layers",
                 "img_dim", "remat"):
        if knob in vit_config:
            overrides[knob] = vit_config[knob]
    vc = get_vit_config(vit_config["variant"], **overrides)
    return VTAMIQConfig(
        vit=vc,
        calibrate=vtamiq_config["calibrate"],
        diff_scale=vtamiq_config["diff_scale"],
        num_rgs=vtamiq_config["num_rgs"],
        num_rcabs=vtamiq_config["num_rcabs"],
        ca_reduction=vtamiq_config["ca_reduction"],
        rg_path_drop=vtamiq_config["rg_path_drop"],
        predictor_dropout=vtamiq_config["predictor_dropout"],
    )


# ************** DATASET / LOADER FACTORIES **************


def get_dataset_splits(dataset_type, splits_config):
    split_type = dataset_split_config_base["split_type"]
    if split_type == SPLIT_TYPE_INDICES:
        return splits_config
    if split_type == SPLIT_TYPE_RANDOM:
        num_ref = dataset_type.num_ref_images
        num_total = sum(split_config_random.values())
        split_counts = {name: int(ratio / num_total * num_ref)
                        for name, ratio in split_config_random.items()}
        leftover = num_ref - sum(split_counts.values())
        split_counts[SPLIT_NAME_TRAIN] += leftover
        perm = np.random.permutation(num_ref)
        splits, total = {}, 0
        for name, count in split_counts.items():
            if count < 1:
                log_warn(f"get_dataset_splits(): split {name} got zero images.")
                continue
            splits[name] = sorted(int(i) for i in perm[total: total + count])
            total += count
        return splits
    raise ValueError(f"Unsupported split_type [{split_type}].")


def get_dataset_configs(dataset_name):
    validate_configs_check()
    if dataset_name not in _DATASET_REGISTRY:
        raise ValueError(f"Unexpected dataset [{dataset_name}].")
    dataset_type, splits_config = _DATASET_REGISTRY[dataset_name]
    return dataset_type, get_dataset_splits(dataset_type, splits_config)


def make_dataset_with_config_splits(dataset_name):
    validate_configs_check()
    dataset_config = deepcopy(dataset_config_base)
    dataset_type, split_config = get_dataset_configs(dataset_name)
    dataset = dataset_type(**dataset_config)

    dataset.add_split(None)  # FullDataset
    for split_name, indices in split_config.items():
        if len(indices) > 0:
            dataset.add_split(D.dataset_split(name=split_name, indices=indices))
    return dataset


class DatasetFactory:
    """Caches one dataset instance per name; serves per-split loaders
    (reference DatasetFactory, train_config.py:570-613)."""

    def get_dataset(self, dataset_name):
        if dataset_name not in self.dataset_cache:
            self.dataset_cache[dataset_name] = make_dataset_with_config_splits(dataset_name)
        return self.dataset_cache[dataset_name]

    def __init__(self, process_index: int = 0, process_count: int = 1):
        self.dataset_cache: Dict[str, object] = {}
        self.process_index, self.process_count = process_index, process_count

    def get_dataloader(self, dataset_name, split_name, dataloader_params):
        dataset = self.get_dataset(dataset_name)
        if not dataset.has_split(split_name):
            log_warn(f"Dataset {dataset.name} missing split [{split_name}]; loader=None.")
            return None
        prefetch = global_config["dataloader_num_workers"]
        pin = (global_config["dataloader_pin_memory"]
               and str(global_config["device"]).startswith("cuda"))
        return PatchDatasetLoader(
            dataset=dataset,
            split_name=split_name,
            batch_size=dataloader_params[BATCH_SIZE],
            patch_count=dataloader_params[PATCH_COUNT],
            allow_img_flip=dataloader_params[PATCH_FLIP],
            img_zero_error_q_prob=dataloader_params[IMG_ZERO_ERROR_Q_PROB],
            use_aligned_patches=dataloader_params[USE_ALIGNED_PATCHES],
            shuffle=dataloader_params[SHUFFLE],
            num_repeats_data=dataloader_params[NUM_REPEATS_DATA],
            seed=max(0, global_config["seed"]),
            prefetch=max(1, min(4, prefetch)),
            max_size_buckets=global_config.get("max_size_buckets", 0),
            pin_memory=pin,
            process_index=self.process_index,
            process_count=self.process_count,
        )


def get_dataloaders(use_full_dataset=False, dataloader_config=None,
                    process_index: int = 0, process_count: int = 1):
    """(train, val, test loaders, factory); ``process_index`` /
    ``process_count``: a mesh's data rank and data size (each loader
    yields this rank's slice of global batches, ``data/pipeline.py``)."""
    validate_configs_check()
    if dataloader_config is None:
        dataloader_config = deepcopy(dataloader_config_base)
    if use_full_dataset:
        log_warn("use_full_dataset=True; all loaders use the FULL dataset.")

    factory = DatasetFactory(process_index, process_count)
    name = dataset_target()
    pick = lambda split: SPLIT_NAME_FULL if use_full_dataset else split

    loader_train = factory.get_dataloader(name, pick(SPLIT_NAME_TRAIN),
                                          dataloader_config[SPLIT_NAME_TRAIN])
    loader_val = factory.get_dataloader(name, pick(SPLIT_NAME_VAL),
                                        dataloader_config[SPLIT_NAME_VAL])
    if global_config["dataset_test"] is not None:
        name = global_config["dataset_test"]
    use_full_test = use_full_dataset and global_config["allow_use_full_dataset_test"]
    loader_test = factory.get_dataloader(
        name, SPLIT_NAME_FULL if use_full_test else SPLIT_NAME_TEST,
        dataloader_config[SPLIT_NAME_TEST])
    return loader_train, loader_val, loader_test, factory


# ************** REPRODUCIBILITY DUMP **************


def dump_config_file(output_dir, config, name):
    with open(os.path.join(output_dir, f"{name}.yaml"), "w") as f:
        f.write(to_yaml(_yamlable(config)))


_YAML_WORDS = {"", "~", "null", "true", "false", "yes", "no", "on", "off", "y", "n"}


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mantissa, exponent = text.split("e")
            text = f"{mantissa}.0e{exponent}"  # YAML 1.1 floats need the dot
        return text
    text = str(v)
    plain = (text.lower() not in _YAML_WORDS and text == text.strip()
             and text[0] not in "-?:,[]{}#&*!|>'\"%@`0123456789.+"
             and all(c.isalnum() or c in "_-./ " for c in text))
    return text if plain else json.dumps(text)


def to_yaml(obj, indent: int = 0) -> str:
    """Block-style YAML for nested dicts, lists and scalars (what
    ``_yamlable`` yields), keys in insertion order."""
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            key = _yaml_scalar(k)
            if isinstance(v, (dict, list)) and v:
                child = indent if isinstance(v, list) else indent + 2
                out.append(f"{pad}{key}:\n{to_yaml(v, child)}")
            else:
                out.append(f"{pad}{key}: {to_yaml(v).strip()}\n")
        return "".join(out)
    if isinstance(obj, list):
        if not obj:
            return pad + "[]\n"
        out = []
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                body = to_yaml(v, indent + 2)
                out.append(f"{pad}- {body[indent + 2:]}")
            else:
                out.append(f"{pad}- {to_yaml(v).strip()}\n")
        return "".join(out)
    return pad + _yaml_scalar(obj) + "\n"


def _yamlable(obj):
    if isinstance(obj, (OrderedDict, dict)):
        return {k: _yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yamlable(v) for v in obj]
    return obj


def save_configs(output_dir):
    validate_configs_check()
    dump_config_file(output_dir, global_config, "config")
    dump_config_file(output_dir, vtamiq_config, "model_config")
    dump_config_file(output_dir, pretraining_config, "pretraining_config")
    if freeze_config["freeze_vtamiq"] and global_config["model"] in models_vtamiq:
        dump_config_file(output_dir, freeze_dict_vtamiq, "freeze_dict_vtamiq")
        dump_config_file(output_dir, freeze_config, "freeze_config")
    dump_config_file(output_dir, dataset_config_base, "dataset_config_base")
    dump_config_file(output_dir, dataloader_config_base, "dataloader_config_base")
    if global_config["use_pref_module"]:
        dump_config_file(output_dir, pref_module_config, "pref_module_config")

    used = {dataset_target(), global_config.get("dataset_test")}
    for ds_name, (dump_name, cfg) in _SPLIT_CONFIG_DUMP_NAMES.items():
        if ds_name in used:
            dump_config_file(output_dir, cfg, dump_name)
            break


_CODE_SNAPSHOT_FILES = [
    "ops/sampling.py",
    "ops/extraction.py",
    "models/vit.py",
    "models/vtamiq.py",
    "train/steps.py",
    "train/engine.py",
]


def save_code(output_dir):
    """Snapshot the package's core source files into the run dir
    (reference save_code, train_config.py:725-746)."""
    validate_configs_check()
    dst = os.path.join(output_dir, global_config["save_code_folder"])
    os.makedirs(dst, exist_ok=True)
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in _CODE_SNAPSHOT_FILES:
        src = os.path.join(package_root, rel)
        if os.path.isfile(src):
            shutil.copyfile(src, os.path.join(dst, os.path.basename(rel)))


# ************** VALIDATION **************


def validate_configs_check():
    if not global_config["config_validated"]:
        raise RuntimeError("Configs must be validated (call validate_configs()).")


def validate_configs():
    log("*** Validating config files...")

    if (global_config["model"] in models_vtamiq
            and vit_config["variant"] == VIT_VARIANT_B8):
        dataset_config_base["patch_dim"] = 8
    else:
        dataset_config_base["patch_dim"] = 16

    vit_config["num_scales"] = max(1, vit_config["num_scales"])
    dataset_config_base["patch_num_scales"] = max(1, dataset_config_base["patch_num_scales"])

    if model_uses_scales() != dataset_uses_scales():
        raise ValueError(
            "Mismatch between model/dataset use of scales: model "
            f"{'uses' if model_uses_scales() else 'does not use'} scales while dataset "
            f"{'uses' if dataset_uses_scales() else 'does not use'} scales.")

    log(f"Set dataset_config_base['patch_dim']={dataset_config_base['patch_dim']}.")

    if dataloader_config_base[DATALOADER_PARAMS][USE_DEFAULT_PARAMS]:
        log_warn("Using default batch size / patch count.")
    else:
        data_config = (dataloader_config_vtamiq
                       if global_config["model"] in models_vtamiq
                       else dataloader_config_base)
        for split in (SPLIT_NAME_TRAIN, SPLIT_NAME_VAL, SPLIT_NAME_TEST):
            dataloader_config_base[split][BATCH_SIZE] = data_config[split][BATCH_SIZE]
            dataloader_config_base[split][PATCH_COUNT] = data_config[split][PATCH_COUNT]

    log("Using train/val/test batch_size=[{}, {}, {}], patch_count=[{}, {}, {}].".format(
        *(dataloader_config_base[s][BATCH_SIZE] for s in
          (SPLIT_NAME_TRAIN, SPLIT_NAME_VAL, SPLIT_NAME_TEST)),
        *(dataloader_config_base[s][PATCH_COUNT] for s in
          (SPLIT_NAME_TRAIN, SPLIT_NAME_VAL, SPLIT_NAME_TEST))))

    if global_config["dataloader_num_workers"] == -1:
        global_config["dataloader_num_workers"] = num_workers_config[dataset_target()]

    if dataset_target() == DATASET_PIEAPP_TRAIN:
        log_warn("Training with PieAPP train dataset; pairwise mode will be used.")

    if global_config["use_pu"]:
        log_warn("PU encoding mode: dataset normalization disabled.")
        dataset_config_base["normalize"] = False
        dataset_config_base["normalize_imagenet"] = False

    assert not (dataset_target() == DATASET_KADIS700K and
                dataset_split_config_base["split_type"] == SPLIT_TYPE_RANDOM), (
        f"split_type must be '{SPLIT_TYPE_INDICES}' when using KADIS700k.")

    log("*** Config files successfully validated.")
    global_config["config_validated"] = True


def reset_configs_validation():
    """Allow re-validation after mutating configs (multi-run workflows)."""
    global_config["config_validated"] = False
