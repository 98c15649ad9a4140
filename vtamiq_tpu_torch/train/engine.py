"""Training / evaluation engine: the ``train()`` orchestrator.

Port of ``vtamiq_tpu/train/engine.py``: the same phase gating
(do_train/do_val/do_test), output-dir naming, freeze-until-epoch schedule,
best/latest checkpoint policy driven by SROCC maxima, loss-weight decay,
eval repeats with prediction averaging, scalar logging (with the
reference's per-batch SROCC for batches > 4), prediction dumps, full resume
with the run state, and ``checkpoint_every_n_batches``.

What differs from the JAX engine:

- **Device.** ``global_config["device"]`` (default "cuda"); a CUDA device
  with no card raises. Batches go to it from pinned host tensors with
  ``non_blocking`` copies.
- **Seed.** ``seed=-1`` resolves from the clock (rank 0's, broadcast under
  a mesh).
- **Randomness.** Patch draws come from a CPU ``torch.Generator`` seeded
  with the seed, dropout and DropPath from a generator on the device; under
  a mesh every rank draws for the global batch and keeps its rows.
- **Mesh.** ``mesh_data``, ``mesh_model`` and ``mesh_seq`` lay a (data,
  model, seq) mesh (``parallel/``) over the ranks of the process group,
  which ``parallel.distributed.initialize`` (or torchrun) started before
  ``train()``; a world above 1 with every size 1 is data = world. Each rank
  runs on the device ``initialize`` gave it, loads its data rank's slice of
  every global batch (batch sizes count per data rank), holds its TP shard
  of the model, and computes the single-process step of the global batch
  (``train/steps.py``); predictions are all-gathered, so every rank's
  correlations and checkpoint decisions agree. Only rank 0 writes
  checkpoints (the TP shards gathered first, so the file is a
  single-process one), logs, YAML dumps and scalars; the test phase's
  checkpoint is read by rank 0 and broadcast.
- **Recovery.** Steps update the parameters and the optimizer's state in
  place (no buffer donation), so a transient fault in a train step leaves
  them half-updated: ``recover_from_latest`` rebuilds both from
  ``latest.npz`` and the batch is redone. A CUDA error that poisons the
  context (illegal address, launch failure) is raised, never recovered;
  under a mesh a train step's fault is raised (the other ranks would wait
  in a collective for the step).
- **Preference module.** With ``use_pref_module`` the module hangs off the
  model as ``pref_module`` (the JAX package keeps it in the same parameter
  tree), so one optimizer trains and decays ``pref_module.p`` with the
  model; checkpoints store it apart, under ``pref_module_state_dict``.

After a run, ``last_run_stats`` holds per-epoch host timings of each phase
(batches, pairs, seconds, seconds waiting on the loader, decode seconds).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..inference import resolve_device
from ..models.checkpoint import (
    MODEL_STATE_DICT, OPT_LEAVES, PREF_MODULE_STATE_DICT, apply_pretraining_gates,
    load_checkpoint, merge_params, params_from_jax, params_to_jax, restore_opt_state,
    save_checkpoint,
)
from ..models.configs import VTAMIQConfig
from ..models.preference import attach_preference_module
from ..models.vit import load_vit_npz
from ..models.vtamiq import VTAMIQ, init_vtamiq_params
from ..ops.correlations import (
    KROCC_FIELD, PLCC_FIELD, PLCC_NOFIT_FIELD, RMSE_FIELD, RMSE_NOFIT_FIELD, SROCC_FIELD,
    compute_correlations_flat,
)
from ..ops.sampling import PatchSampler
from ..parallel.comm import all_gather
from ..parallel.mesh import (DATA_AXIS, Mesh, make_mesh, param_shardings, shard_params,
                             shard_tensors, unshard_params, unshard_tensors)
from ..utils import FileLogger, Logger, Max, SplitSummaryWriter
from ..utils.logging import log, log_warn
from ..utils.retry import is_transient, poisons_context, retry_transient
from . import config as C
from .optim import build_freeze_mask, make_optimizer
from .steps import ExtractConfig, make_eval_step, make_train_step

CHECKPOINT_EXT = "npz"
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "mixed": "mixed"}

# per-epoch host timings of the last train() call: {"train": [...],
# "val": [...], "test": [...]}, one dict per pass (see _PhaseTimer)
last_run_stats: Dict[str, list] = {}


# --------------------------------------------------------------------------
# model construction / checkpoint IO
# --------------------------------------------------------------------------

def get_model_params(cfg: VTAMIQConfig, checkpoint_file: Optional[str] = None,
                     force_load_pretrained: bool = False, seed: int = 0,
                     use_pref_module: bool = False,
                     preloaded_ckpt: Optional[Dict] = None, device="cpu") -> VTAMIQ:
    """A VTAMIQ model on ``device``: weights drawn from a CPU generator
    seeded with ``seed``, ImageNet ViT weights from ``cfg.vit.vit_weights_path``
    (under ``allow_pretrained_vit``), the preference module (initial weight
    ``pref_module_config``) with ``use_pref_module``, then a framework
    checkpoint merged in through the pretraining gates (unless
    ``force_load_pretrained``), its preference module too. ``preloaded_ckpt``
    skips the file read when the caller holds ``load_checkpoint``'s result."""
    params = init_vtamiq_params(cfg, torch.Generator().manual_seed(seed))
    vit_npz = cfg.vit.vit_weights_path
    if C.pretraining_config["allow_pretrained_vit"] and vit_npz and os.path.isfile(vit_npz):
        log(f"ViT: loading pretrained transformer weights from {vit_npz}")
        with np.load(vit_npz) as npz:
            load_vit_npz(npz, cfg.vit, params.vit)
    elif vit_npz:
        log_warn(f"ViT weights path [{vit_npz}] not found; using random init.")
    if use_pref_module:
        attach_preference_module(params, **C.pref_module_config)
    if checkpoint_file is not None or preloaded_ckpt is not None:
        ckpt = preloaded_ckpt
        if ckpt is None:
            log(f"Loading checkpoint file '{checkpoint_file}'")
            ckpt = load_checkpoint(checkpoint_file)
        state = ckpt.get(MODEL_STATE_DICT, {})
        if not force_load_pretrained:
            state = apply_pretraining_gates(
                state,
                allow_vit=C.pretraining_config["allow_pretrained_weights_vit"],
                allow_diffnet=C.pretraining_config["allow_pretrained_weights_diffnet"],
                log=log)
        merge_params(params, params_from_jax(state), strict=False, log=log)
        _merge_pref_module(params, ckpt)
    else:
        log_warn("Model used without framework checkpoint weights.")
    return params.to(device)


def _merge_pref_module(params: VTAMIQ, ckpt: Dict):
    if hasattr(params, "pref_module") and PREF_MODULE_STATE_DICT in ckpt:
        merge_params(params.pref_module, params_from_jax(ckpt[PREF_MODULE_STATE_DICT]),
                     log=log)


def _named(params: VTAMIQ) -> Dict[str, torch.Tensor]:
    return {n: p.detach() for n, p in params.named_parameters()}


def _save(output_dir: str, filename: str, params: VTAMIQ, epoch: int, srocc: float,
          opt_state=None, extra_meta: Optional[Dict] = None, mesh: Optional[Mesh] = None):
    """A checkpoint of the model, with the preference module apart. Under a
    mesh every rank calls it: the TP shards of the model and the optimizer
    moments are gathered, then rank 0 alone writes."""
    opt_state = opt_state if C.global_config["save_optimizer"] else None
    state = params
    if mesh is not None:
        state = unshard_params(params, mesh)
        if opt_state is not None:
            opt_state = _map_moments(opt_state, unshard_tensors,
                                     param_shardings(params, mesh), mesh)
        if dist.get_rank() != 0:
            return
    leaves = params_to_jax(state)
    models = {MODEL_STATE_DICT: {k: v for k, v in leaves.items()
                                 if not k.startswith("pref_module|")}}
    if hasattr(params, "pref_module"):
        models[PREF_MODULE_STATE_DICT] = {k[len("pref_module|"):]: v for k, v in leaves.items()
                                          if k.startswith("pref_module|")}
    save_checkpoint(output_dir, filename, models, epoch, srocc, opt_state=opt_state,
                    extra_meta=extra_meta)


def _map_moments(opt_state: Dict, fn, specs, mesh: Mesh) -> Dict:
    """A copy of an optimizer state with each moment dict passed through
    ``fn(moments, specs, mesh)`` (``shard_tensors`` / ``unshard_tensors``)."""
    return {k: fn(v, specs, mesh) if isinstance(v, dict) else v for k, v in opt_state.items()}


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def _engine_mesh(g: Dict) -> Optional[Mesh]:
    """The mesh of ``mesh_data`` x ``mesh_model`` x ``mesh_seq`` over the
    initialized process group (a world above 1 with every size 1: data =
    world); None for one process."""
    d, m, s = int(g["mesh_data"]), int(g["mesh_model"]), int(g.get("mesh_seq", 1))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if d * m * s == 1 and world == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(
            f"mesh_data x mesh_model x mesh_seq = {d}x{m}x{s} needs {d * m * s} processes: "
            "start them with torchrun, or call "
            "vtamiq_tpu_torch.parallel.distributed.initialize() in each, before "
            "engine.train()")
    if d * m * s == 1:
        d = world
    elif d * m * s != world:
        raise ValueError(
            f"mesh {d}x{m}x{s} needs a world of {d * m * s} processes; the initialized "
            f"process group has {world} (parallel.distributed.initialize, torchrun)")
    mesh = make_mesh(data=d, model=m, seq=s)
    if torch.device(g["device"]).type != mesh.device.type:
        raise ValueError(f"global_config['device'] {g['device']} but this rank runs on "
                         f"{mesh.device} (parallel.distributed.initialize's local_device)")
    log(f"Using a mesh of {world} processes: data={d} model={m} seq={s}")
    return mesh


def _broadcast_int(value: int, mesh: Optional[Mesh]) -> int:
    """Rank 0's ``value`` on every rank (itself without a mesh)."""
    if mesh is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=0)
    return int(t.item())


@torch.no_grad()
def _broadcast_params(params: VTAMIQ):
    """Every parameter set to rank 0's, in place."""
    for p in params.parameters():
        dist.broadcast(p.data, src=0)


# --------------------------------------------------------------------------
# epoch loops
# --------------------------------------------------------------------------

def _batch_tensors(batch, device):
    """(raw, qs, img_hw) of one host batch on ``device``; pinned host
    tensors copy without blocking the host."""
    move = lambda t: None if t is None else t.to(device, non_blocking=True)
    return move(batch.imgs_raw), move(batch.qs), move(batch.img_hw)


def _collect_predictions(batch, q_p, mesh: Optional[Mesh] = None):
    """This batch's (labels, predictions) restricted to the real items.
    Under a mesh ``q_p`` is the global batch's (the steps gather it) and the
    labels are all-gathered over "data", so every rank holds the same
    global lists and its epoch correlations agree with every other's."""
    if mesh is None:
        v, qs = batch.valid, batch.qs
    else:
        v, qs = batch.global_valid, all_gather(batch.qs.to(q_p.device), mesh.group(DATA_AXIS))
    return (qs[:v].cpu().numpy().astype(float),
            q_p[:v].detach().float().cpu().numpy().astype(float))


def _step_valid(batch) -> int:
    """The valid count a step masks its loss with: the global batch's under
    a mesh."""
    return batch.valid if batch.global_valid is None else batch.global_valid


class _PhaseTimer:
    """Host timings of one pass over a loader: wall seconds (ended by the
    device sync of the epoch's predictions), seconds blocked on the loader,
    the loader's decode seconds, batches and real pairs."""

    def __init__(self, loader):
        self.loader, self.decode0 = loader, len(loader.decode_seconds)
        self.t0 = time.perf_counter()
        self.wait = 0.0
        self.batches = self.pairs = 0

    def batches_of(self, iterable):
        it = iter(iterable)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            self.wait += time.perf_counter() - t
            if batch is None:
                return
            self.batches += 1
            self.pairs += batch.valid
            yield batch

    def result(self, **extra) -> Dict:
        return {"batches": self.batches, "pairs": self.pairs,
                "seconds": time.perf_counter() - self.t0, "wait_seconds": self.wait,
                "decode_seconds": float(sum(self.loader.decode_seconds[self.decode0:])),
                **extra}


def _scalars(metrics: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    """The named metrics as floats, read back in one transfer."""
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


def do_training(train_step, params, opt_state, mask, loader, generators,
                loss_weights, *, writer, logger, is_pairwise, is_debug,
                output_dir, checkpoint_every_n_batches, epoch, step, device,
                recover_fn=None, stats=None, mesh=None):
    """One training epoch; returns (params, opt_state, step, correlations).

    ``generators``: (CPU generator for the patch draws, device generator for
    dropout). ``recover_fn``: optional () -> (params, opt_state) | None
    rebuilding the training state from the latest checkpoint, called when a
    transient fault interrupts a step; the batch is then redone.
    ``mesh``: the steps are mesh steps; skips and saves follow the global
    batch, so every rank takes them together."""
    q_vals, qp_vals = [], []
    sample_gen, dropout_gen = generators
    timer = _PhaseTimer(loader)

    for batch_i, batch in enumerate(timer.batches_of(loader)):
        raw, qs, hw = _batch_tensors(batch, device)
        valid = _step_valid(batch)
        if valid < 2:
            log_warn("Batch has < 2 valid items; skipping current batch.")
            continue

        def dispatch(p, o):
            return train_step(p, o, mask, raw, qs, valid, loss_weights, sample_gen,
                              dropout_gen, hw)

        try:
            metrics, q_p = dispatch(params, opt_state)
        except Exception as e:  # noqa: BLE001 — classified below
            if recover_fn is None or poisons_context(e) or not is_transient(e):
                raise
            log_warn(f"Transient fault in a train step ({str(e)[:120]}); restoring "
                     "params/optimizer from the latest checkpoint and redoing the batch.")
            restored = recover_fn()
            if restored is None:
                raise
            params, opt_state = restored
            metrics, q_p = dispatch(params, opt_state)

        y_b, yp_b = _collect_predictions(batch, q_p, mesh)
        q_vals.append(y_b)
        qp_vals.append(yp_b)
        v = len(y_b)

        if not is_debug and writer is not None:
            if is_pairwise:
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "mae_loss",
                                  float(metrics["loss"]), step)
            else:
                m = _scalars(metrics, ("loss", "mae", "rank", "pears"))
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "loss", m["loss"], step)
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "mae_loss", m["mae"], step)
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "rank_loss", m["rank"], step)
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "pears_loss", m["pears"], step)
            if v > 4:  # correlations need enough points (reference train.py:546)
                cors = compute_correlations_flat([q_vals[-1]], [qp_vals[-1]], warn=None)
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "SROCC_batch_s",
                                  cors[SROCC_FIELD], step)

        if not is_debug and (batch_i + 1) % checkpoint_every_n_batches == 0:
            logger(f"Saving latest model during training: epoch=[{epoch}], "
                   f"batch_i=[{batch_i}]")
            _save(output_dir, f"latest.{CHECKPOINT_EXT}", params, epoch, -1, opt_state,
                  mesh=mesh)

        step += 1

    correlations = compute_correlations_flat(q_vals, qp_vals, warn=log_warn)
    if stats is not None:
        stats.append(timer.result(epoch=epoch))
    if not is_debug and writer is not None:
        _writer_log_correlations(writer, C.SPLIT_NAME_TRAIN, correlations, epoch)
    return params, opt_state, step, correlations


def do_validation(eval_step, params, loader, sample_gen, loss_weights, *,
                  split_name, writer, logger, is_pairwise, is_debug, device,
                  num_repeats=1, step=0, epoch=0, output_logger=None, tag="",
                  stats=None, mesh=None):
    """Validation/test pass with patch-resampling repeats; predictions are
    averaged across repeats (reference do_validation, train.py:583-644)."""
    ys, yps = [], []
    for repeat in range(num_repeats):
        timer = _PhaseTimer(loader)
        for i, batch in enumerate(timer.batches_of(loader)):
            raw, qs, hw = _batch_tensors(batch, device)
            metrics, q_p = retry_transient(
                eval_step, params, raw, qs, _step_valid(batch), loss_weights, sample_gen, hw,
                max_retries=0 if mesh is not None else
                C.global_config.get("device_fault_retries", 2), log=log_warn)

            y_b, yp_b = _collect_predictions(batch, q_p, mesh)
            ys.append(y_b)
            yps.append(yp_b)

            if writer is not None and not is_debug:
                prefix = f"{tag}-" if tag else ""
                m = _scalars(metrics, ("loss",) if is_pairwise
                             else ("loss", "mae", "rank", "pears"))
                writer.add_scalar(split_name, prefix + "loss", m["loss"], step, force_add=True)
                if not is_pairwise:
                    for name in ("mae", "rank", "pears"):
                        writer.add_scalar(split_name, f"{prefix}{name}_loss", m[name], step,
                                          force_add=True)
            if output_logger is not None:
                output_logger(i, tag, ",".join(str(x) for x in yps[-1]))
            step += 1
        if stats is not None:
            stats.append(timer.result(epoch=epoch, repeat=repeat))

    correlations = compute_correlations_flat(ys, yps, num_repeats, warn=log_warn) \
        if ys else None
    if writer is not None and not is_debug and correlations is not None:
        _writer_log_correlations(writer, split_name, correlations, epoch, tag=tag)
    return step, correlations


def _writer_log_correlations(writer, split_name, correlations, step, tag=""):
    prefix = f"{tag}-" if tag else ""
    for field in (SROCC_FIELD, KROCC_FIELD, PLCC_FIELD, RMSE_FIELD):
        writer.add_scalar(split_name, prefix + field, correlations[field], step,
                          force_add=True)


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

def train():
    """Full training/eval run driven by the config dicts; returns the test
    correlations dict (reference train(), train.py:652-953)."""
    C.validate_configs()
    g = C.global_config

    is_debug = g["is_debug"]
    is_verbose = g["is_verbose"]
    is_pairwise = C.dataset_is_pairwise(C.dataset_target())
    do_train_ = g["do_train"]
    do_val_ = g["do_val"]
    do_test_ = g["do_test"]
    is_test_only = not do_train_ and not do_val_ and do_test_
    use_pref_module = g["use_pref_module"]

    log(f"Current run with do_train={do_train_}, do_val={do_val_}, do_test={do_test_}.")
    assert not (is_debug and is_test_only), "Debug mode disables saving; can't run test-only."
    assert do_train_ or do_test_, "Run must have at least training or testing stage."
    assert not (not do_train_ and do_val_), "Validation requires training."
    mesh = _engine_mesh(g)
    device = resolve_device(g["device"]) if mesh is None else mesh.device
    # rank 0 writes every file; the others run the same decisions silently
    writes = not is_debug and (mesh is None or dist.get_rank() == 0)

    cfg = C.build_model_config()
    checkpoint_file = g["load_checkpoint_file"]

    seed = g["seed"]
    if seed == -1:
        seed = _broadcast_int(int(time.time()) % (2 ** 31), mesh)
    # written back: the loaders read global_config["seed"] and save_configs
    # records the resolved value
    g["seed"] = seed
    np.random.seed(seed)
    sample_gen = torch.Generator().manual_seed(seed)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    params = get_model_params(cfg, checkpoint_file, seed=seed,
                              use_pref_module=use_pref_module, device=device)

    # output dir naming (reference train.py:680-731)
    output_dir = g["output_dir"] + "/{}".format(_broadcast_int(int(time.time()), mesh))
    output_dir += "-" + C.dataset_target() + "-" + g["model"]
    output_dir += "-{}-{}L-{}R".format(cfg.vit.variant, cfg.vit.effective_num_layers,
                                       C.vtamiq_config["num_rcabs"])
    if is_test_only:
        output_dir += "-TESTSET-" + str(C.dataloader_config_base[C.SPLIT_NAME_TEST][C.PATCH_COUNT])
    else:
        output_dir += "-{}e-{}b-{}p".format(
            g["num_epochs"],
            C.dataloader_config_base[C.SPLIT_NAME_TRAIN][C.BATCH_SIZE],
            C.dataloader_config_base[C.SPLIT_NAME_TRAIN][C.PATCH_COUNT])
    if use_pref_module:
        output_dir += "-pref"

    # freeze schedule (reference train.py:707-726)
    allow_freeze = C.freeze_config["freeze_vtamiq"]
    freeze_model = not is_test_only and (
        allow_freeze or
        (C.freeze_config["freeze_conditional"] and
         (checkpoint_file is None or C.dataset_target() not in str(checkpoint_file))))
    freeze_end_after_epochs = C.freeze_config["freeze_end_after_epochs"][C.dataset_target()]
    if freeze_model:
        output_dir += "-frz"
    if g["output_tag"]:
        output_dir += f"-{g['output_tag']}"
    g["output_dir_final"] = output_dir

    save_val_outputs = g["save_val_outputs"] and writes
    save_test_outputs = g["save_test_outputs"] and writes
    output_qs_path = output_dir + "/" + g["save_test_outputs_txt"]
    val_logger = FileLogger(output_qs_path if save_val_outputs else None, verbose=False)
    test_logger = FileLogger(output_qs_path if save_test_outputs else None, verbose=False)

    if not writes:
        logger_run = Logger(verbose=is_verbose and is_debug)
        writer = None
    else:
        os.makedirs(output_dir, exist_ok=True)
        logger_run = FileLogger(f"{output_dir}/{g['output_txt']}", verbose=is_verbose)
        writer = SplitSummaryWriter(logdir=output_dir,
                                    log_every_n_steps=g["tensorlog_every_n_steps"])
        logger_run(f"tensorboard --logdir='{output_dir}'")

    if (do_val_ or do_test_) and not do_train_:
        g["num_epochs"] = 1

    # loaders (full-dataset override: reference train.py:769-773)
    train_xor = (do_train_ ^ do_val_ ^ do_test_) and not (do_train_ and do_val_ and do_test_)
    use_full_dataset = train_xor and g["allow_use_full_dataset"]
    loader_train, loader_val, loader_test, _factory = C.get_dataloaders(
        use_full_dataset=use_full_dataset,
        process_index=0 if mesh is None else mesh.index(DATA_AXIS),
        process_count=1 if mesh is None else mesh.size(DATA_AXIS))

    checkpoint_every_n_batches = g["checkpoint_every_n_batches"]
    if checkpoint_every_n_batches <= 0:
        checkpoint_every_n_batches = 999999999999

    compute_dtype = COMPUTE_DTYPES[g["compute_dtype"]]
    sampler = PatchSampler(**C.dataset_config_base["patch_sampler_config"])

    # model-input normalization is fused into the device step
    _probe_loader = loader_train or loader_val or loader_test
    norm_mean, norm_std = _probe_loader.dataset.get_norm_mean_std()

    def make_ecfg(split):
        return ExtractConfig(
            patch_count=C.dataloader_config_base[split][C.PATCH_COUNT],
            patch_dim=C.dataset_config_base["patch_dim"],
            patch_num_scales=C.dataset_config_base["patch_num_scales"],
            scale_num_samples_ratio=C.dataset_config_base["patch_sampling_num_scales_ratio"],
            use_aligned_patches=bool(
                C.dataloader_config_base[split][C.USE_ALIGNED_PATCHES]),
            randomize_patch_scale_order=bool(
                C.dataset_config_base.get("randomize_patch_scale_order", False)),
            norm_mean=tuple(norm_mean) if norm_mean is not None else None,
            norm_std=tuple(norm_std) if norm_std is not None else None,
            # an fp32 run must not round its model inputs to bf16 in the
            # fused gather; "mixed" gathers bf16 for its bf16 patch matmul
            gather_dtype="float32" if compute_dtype == torch.float32 else "bfloat16",
            pu_display_encode=bool(g["use_pu"]))

    steps_per_epoch = len(loader_train) if loader_train is not None else 1
    optimizer, lr_schedule = make_optimizer(g, steps_per_epoch)
    opt_state = optimizer.init(_named(params))

    # full resume: params + optimizer state + epoch (needs a checkpoint
    # written with save_optimizer=True for the optimizer part)
    start_epoch = 1
    resume_meta: Dict = {}
    resume_file = g.get("resume_checkpoint_file")
    if resume_file:
        log(f"Resuming from checkpoint '{resume_file}'")
        ckpt = load_checkpoint(resume_file)
        merge_params(params, params_from_jax(ckpt.get(MODEL_STATE_DICT, {})), log=log)
        _merge_pref_module(params, ckpt)
        if OPT_LEAVES in ckpt:
            restore_opt_state(opt_state, ckpt[OPT_LEAVES])
            log("Optimizer state restored.")
        else:
            log_warn("Resume checkpoint has no optimizer state; "
                     "fresh optimizer (schedule restarts).")
        start_epoch = int(ckpt.get("epoch", 0)) + 1
        resume_meta = ckpt.get("meta", {})
        log(f"Resuming at epoch {start_epoch}.")

    train_step = eval_step_val = eval_step_test = None
    if do_train_:
        train_step = make_train_step(
            cfg, sampler, make_ecfg(C.SPLIT_NAME_TRAIN), optimizer,
            is_pairwise=is_pairwise, use_pref_module=use_pref_module,
            weighted_loss=g["use_weighted_loss"], compute_dtype=compute_dtype, mesh=mesh)
    if do_val_:
        eval_step_val = make_eval_step(
            cfg, sampler, make_ecfg(C.SPLIT_NAME_VAL), is_pairwise=is_pairwise,
            use_pref_module=use_pref_module, weighted_loss=g["use_weighted_loss"],
            compute_dtype=compute_dtype, mesh=mesh)
    if do_test_:
        eval_step_test = make_eval_step(
            cfg, sampler, make_ecfg(C.SPLIT_NAME_TEST), is_pairwise=is_pairwise,
            use_pref_module=use_pref_module, weighted_loss=g["use_weighted_loss"],
            compute_dtype=compute_dtype, mesh=mesh)

    # freeze state
    frozen_model = False
    mask = build_freeze_mask(params, False, None)
    if freeze_model:
        logger_run("Model freezing params...")
        frozen_model = True
        mask = build_freeze_mask(params, True, C.freeze_dict_vtamiq)

    # model info: param table / FLOPs (reference train.py:786-789)
    from ..models.utils import print_parameters, print_flops, save_model_params
    log(f"Model {g['model']} info:")
    if g["print_flops"]:
        print_flops(cfg, C.dataloader_config_base[C.SPLIT_NAME_TRAIN][C.PATCH_COUNT], log=log)
    print_parameters(params, full=g["print_params"] or is_debug, log=log)
    if writes:
        save_model_params(params, output_dir)
    if mesh is not None:
        # the full model and optimizer state (resumed above) cut to this
        # rank's tensor-parallel shard
        specs = param_shardings(params, mesh)
        opt_state = _map_moments(opt_state, shard_tensors, specs, mesh)
        params = shard_params(params, mesh)

    logger_run("Configuration completed.")

    w_mae = g["weight_mae_loss"]
    w_rank = g["weight_rank_loss"]
    w_pears = g["weight_pears_loss"]

    def recover_from_latest():
        """(params, opt_state) rebuilt from latest.npz after a transient
        fault in a train step; None when no checkpoint exists yet."""
        path = os.path.join(output_dir, f"latest.{CHECKPOINT_EXT}")
        if is_debug or mesh is not None or not os.path.isfile(path):
            return None
        ckpt = load_checkpoint(path)
        p = get_model_params(cfg, path, force_load_pretrained=True, seed=seed,
                             use_pref_module=use_pref_module, preloaded_ckpt=ckpt,
                             device=device)
        o = optimizer.init(_named(p))
        if OPT_LEAVES in ckpt:
            restore_opt_state(o, ckpt[OPT_LEAVES])
        else:
            log_warn("Recovery checkpoint has no optimizer state; "
                     "optimizer restarts from init.")
        return p, o

    best_spearman_train = Max()
    best_spearman_val = Max()
    best_spearman = -1.0

    correlations = None
    global_step_train = 0
    global_step_val = 0

    if resume_file and resume_meta:
        # restore the run state, not just params + optimizer: best-SROCC
        # trackers, decayed loss weights and the scalar step counters
        if "best_srocc_train" in resume_meta:
            best_spearman_train.add(float(resume_meta["best_srocc_train"]))
        if "best_srocc_val" in resume_meta:
            best_spearman_val.add(float(resume_meta["best_srocc_val"]))
        best_spearman = float(resume_meta.get("best_srocc", best_spearman))
        # the meta holds the weights the saved epoch trained with (saved
        # before the end-of-epoch decay); the run resumes at epoch + 1
        if "w_mae" in resume_meta:
            w_mae = float(resume_meta["w_mae"]) * g["weight_mae_loss_decay"]
        if "w_rank" in resume_meta:
            w_rank = float(resume_meta["w_rank"]) * g["weight_rank_loss_decay"]
        if "w_pears" in resume_meta:
            w_pears = float(resume_meta["w_pears"]) * g["weight_pears_loss_decay"]
        global_step_train = int(resume_meta.get("global_step_train", 0))
        global_step_val = int(resume_meta.get("global_step_val", 0))
        log("Run state restored from checkpoint meta (best SROCC trackers, "
            "loss-weight decay, step counters).")

    def run_meta():
        """Run-state snapshot stored in every checkpoint's meta."""
        meta = {"w_mae": w_mae, "w_rank": w_rank, "w_pears": w_pears,
                "global_step_train": global_step_train,
                "global_step_val": global_step_val,
                "best_srocc": best_spearman}
        if best_spearman_train.value() is not None:
            meta["best_srocc_train"] = best_spearman_train.value()
        if best_spearman_val.value() is not None:
            meta["best_srocc_val"] = best_spearman_val.value()
        return meta

    if writes:
        C.save_configs(output_dir)
        C.save_code(output_dir)

    stats = {"train": [], "val": [], "test": []}
    last_run_stats.clear()
    last_run_stats.update(stats)

    for epoch in range(start_epoch, g["num_epochs"] + 1):
        logger_run("Beginning epoch {:03d}".format(epoch))

        if frozen_model and freeze_end_after_epochs < epoch:
            logger_run("VTAMIQ: Unfreezing params...")
            mask = build_freeze_mask(params, False, None)
            frozen_model = False

        is_best_so_far = False

        if do_train_:
            log("Starting Training loop...")
            params, opt_state, global_step_train, correlations = do_training(
                train_step, params, opt_state, mask, loader_train, (sample_gen, dropout_gen),
                (w_mae, w_rank, w_pears), writer=writer, logger=logger_run,
                is_pairwise=is_pairwise, is_debug=is_debug, output_dir=output_dir,
                checkpoint_every_n_batches=checkpoint_every_n_batches,
                epoch=epoch, step=global_step_train, device=device,
                recover_fn=recover_from_latest, stats=stats["train"], mesh=mesh)

            if not is_debug and writer is not None:
                # the LR this epoch's updates used (the schedule reads the
                # pre-increment update count)
                lr_log_step = (global_step_train
                               if g["scheduler_step_per_batch"]
                               else max(0, global_step_train - 1))
                writer.add_scalar(C.SPLIT_NAME_TRAIN, "LR",
                                  float(lr_schedule(lr_log_step)), epoch,
                                  force_add=True)

            is_best_so_far = best_spearman_train.add(correlations[SROCC_FIELD])
            if is_best_so_far:
                best_spearman = best_spearman_train.value()
                logger_run(f"Best training SROCC {correlations[SROCC_FIELD]}!")
            else:
                logger_run(f"Current training SROCC {correlations[SROCC_FIELD]} "
                           f"(best={best_spearman_train.value()}).")
            if not is_debug and g["train_save_latest"]:
                logger_run(f"Saving latest model: epoch=[{epoch}], "
                           f"SROCC=[{correlations[SROCC_FIELD]}]")
                _save(output_dir, f"latest.{CHECKPOINT_EXT}", params, epoch,
                      correlations[SROCC_FIELD], opt_state, extra_meta=run_meta(), mesh=mesh)

        if do_val_:
            log("Starting Validation loop...")
            global_step_val, correlations = do_validation(
                eval_step_val, params, loader_val, sample_gen, (w_mae, w_rank, w_pears),
                split_name=C.SPLIT_NAME_VAL, writer=writer, logger=logger_run,
                is_pairwise=is_pairwise, is_debug=is_debug, device=device,
                num_repeats=g["num_repeats_val"], step=global_step_val,
                epoch=epoch, output_logger=val_logger, tag="val", stats=stats["val"],
                mesh=mesh)

            is_best_so_far = best_spearman_val.add(correlations[SROCC_FIELD])
            if is_best_so_far:
                best_spearman = best_spearman_val.value()
                logger_run(f"Best validation SROCC {correlations[SROCC_FIELD]}!")
            else:
                logger_run(f"Current validation SROCC {correlations[SROCC_FIELD]} "
                           f"(best={best_spearman_val.value()}).")

        if not is_test_only:
            logger_run(f"Completed epoch {epoch}")
            if is_best_so_far:
                logger_run(f"Best SROCC {best_spearman}!")
                if not is_debug:
                    logger_run(f"Saving best model: epoch=[{epoch}], SROCC=[{best_spearman}]")
                    _save(output_dir, f"best.{CHECKPOINT_EXT}", params, epoch,
                          best_spearman, opt_state, extra_meta=run_meta(), mesh=mesh)
            elif correlations is not None:
                logger_run(f"Current SROCC {correlations[SROCC_FIELD]}.")

        # loss-weight decay (reference train.py:899-901)
        w_mae *= g["weight_mae_loss_decay"]
        w_rank *= g["weight_rank_loss_decay"]
        w_pears *= g["weight_pears_loss_decay"]

    if do_test_:
        log("Doing Test.")
        if do_train_ and not is_debug:
            # the model alone is reloaded for the test: the preference
            # module keeps its final epoch's in-memory state, as in the
            # reference and the JAX engine
            pref_keep = (params.pref_module.p.detach().clone()
                         if hasattr(params, "pref_module") else None)
            saved = "{}/{}.{}".format(
                output_dir,
                "latest" if (g["test_use_latest"] and g["train_save_latest"]) else "best",
                CHECKPOINT_EXT)
            if mesh is None:
                params = get_model_params(cfg, saved, force_load_pretrained=True, seed=seed,
                                          use_pref_module=use_pref_module, device=device)
            else:  # the checkpoint is rank 0's: it reads it and broadcasts
                params = get_model_params(cfg, saved if writes else None,
                                          force_load_pretrained=True, seed=seed,
                                          use_pref_module=use_pref_module, device=device)
                _broadcast_params(params)
                params = shard_params(params, mesh)
            if pref_keep is not None:
                with torch.no_grad():
                    params.pref_module.p.copy_(pref_keep)

        _, correlations = do_validation(
            eval_step_test, params, loader_test, sample_gen, (w_mae, w_rank, w_pears),
            split_name=C.SPLIT_NAME_TEST, writer=writer, logger=logger_run,
            is_pairwise=is_pairwise, is_debug=is_debug, device=device,
            num_repeats=g["num_repeats_test"], output_logger=test_logger,
            tag="test", stats=stats["test"], mesh=mesh)

        if correlations is not None:
            logger_run(
                "Test stats:\n" +
                "".join(f"{f}={correlations[f]}\n" for f in (
                    SROCC_FIELD, KROCC_FIELD, PLCC_FIELD, RMSE_FIELD,
                    PLCC_NOFIT_FIELD, RMSE_NOFIT_FIELD)))

    if writer is not None:
        writer.close()

    return correlations
