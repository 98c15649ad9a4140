"""The port's training engine (``vtamiq_tpu_torch.train.engine.train``)
against the JAX package's on the CPU, and its own end-to-end behaviour.

Parity: both engines train a tiny model (1 layer, hidden 32) in fp32 with
dropout and DropPath off, from the same initial weights (a JAX checkpoint
loaded through ``load_checkpoint_file``), on one synthetic TID2013 tree, for
two epochs of train and val, then test. The port reads the patches that
JAX's extraction drew for the same batch: the test records them inside
JAX's jitted steps and hands them to the port's steps in order, after
checking that the port's batch holds the same images bit for bit. Per-step
losses (every step logged) and the test correlations agree to 1e-4; fp32 on
both sides, sums in other orders. Each parity test runs alone in a fresh
interpreter (``tests/test_torch_process_state.py``).
"""

import dataclasses
import json
import os
from copy import deepcopy

import numpy as np
import jax
import pytest
import torch

from test_datasets import make_tid
from test_torch_process_state import rerun_in_fresh_process

from vtamiq_tpu.data.datasets import TID2013Dataset as JTID2013Dataset
from vtamiq_tpu.models.checkpoint import load_checkpoint as jload_checkpoint
from vtamiq_tpu.models.checkpoint import save_checkpoint as jsave_checkpoint
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.train import config as JC
from vtamiq_tpu.train import engine as jengine
from vtamiq_tpu.train import steps as jsteps
from vtamiq_tpu_torch.data.datasets import TID2013Dataset
from vtamiq_tpu_torch.models.checkpoint import OPT_LEAVES, load_checkpoint
from vtamiq_tpu_torch.train import config as C
from vtamiq_tpu_torch.train import engine
from vtamiq_tpu_torch.train import steps as tsteps

TOL = 1e-4  # fp32 in both packages; losses, correlations and weights
NUM_REF, NUM_DIST = 5, 4
CONFIG_DICTS = ("global_config", "vit_config", "vtamiq_config", "pretraining_config",
                "freeze_config", "dataset_config_base", "dataset_split_config_base",
                "dataloader_config_base")


def _snapshot(mod):
    snaps = {name: deepcopy(getattr(mod, name)) for name in CONFIG_DICTS}
    registry = dict(mod._DATASET_REGISTRY)

    def restore():
        for name, value in snaps.items():
            target = getattr(mod, name)
            target.clear()
            target.update(value)
        mod._DATASET_REGISTRY.clear()
        mod._DATASET_REGISTRY.update(registry)
    return restore


@pytest.fixture
def configs():
    """Snapshot and restore both packages' module-level config dicts."""
    restores = [_snapshot(JC), _snapshot(C)]
    yield
    for restore in restores:
        restore()


def setup_tiny(mod, base_cls, root, out, **global_overrides):
    """Point the TID2013 registry entry of config module ``mod`` at the tiny
    tree under ``root`` and scale the model and loaders down."""
    class TinyTID(base_cls):
        num_ref_images = NUM_REF
        num_dist_images = NUM_DIST

        def __init__(self, **kwargs):
            kwargs.setdefault("datasets_root", root)
            super().__init__(**kwargs)

    mod._DATASET_REGISTRY[mod.DATASET_TID2013] = (TinyTID, mod.setup_split_config(3, (3, 4), (4, 5)))
    g = mod.global_config
    g.update(dataset=mod.DATASET_TID2013, output_dir=out, num_epochs=2, num_repeats_test=2,
             compute_dtype="float32", config_validated=False, seed=7)
    if mod is C:
        g["device"] = "cpu"
    g.update(global_overrides)
    mod.vit_config.update(num_keep_layers=1, num_extra_tokens=2, hidden_size=32, mlp_dim=64,
                          num_heads=2, path_drop_prob=0.0)
    mod.vtamiq_config.update(num_rgs=1, num_rcabs=1, ca_reduction=4, rg_path_drop=0.0,
                             predictor_dropout=0.0)
    mod.dataloader_config_base[mod.DATALOADER_PARAMS][mod.USE_DEFAULT_PARAMS] = True
    for split in (mod.SPLIT_NAME_TRAIN, mod.SPLIT_NAME_VAL, mod.SPLIT_NAME_TEST):
        mod.dataloader_config_base[split][mod.BATCH_SIZE] = 4
        mod.dataloader_config_base[split][mod.PATCH_COUNT] = 16


@pytest.fixture
def tid_root(tmp_path):
    root = str(tmp_path / "data")
    make_tid(root, num_ref=NUM_REF, num_dist=NUM_DIST)
    return root


def _scalars(out_dir):
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _record_jax_draws(monkeypatch, queue):
    """JAX's extraction, recording (images, patches, pos, scales) of every
    step it runs from inside the jitted step (scales: empty for one scale)."""
    orig = jsteps.make_extract_fn

    def make_extract_fn(sampler, ecfg):
        extract = orig(sampler, ecfg)

        def recording(imgs_raw, key, img_hw=None):
            out = extract(imgs_raw, key, img_hw)
            scales = jax.numpy.zeros(0) if out[2] is None else out[2]
            jax.debug.callback(lambda *a: queue.append([np.array(x) for x in a]),
                               imgs_raw, out[0], out[1], scales, ordered=True)
            return out
        return recording

    monkeypatch.setattr(jsteps, "make_extract_fn", make_extract_fn)


def _feed_jax_draws(monkeypatch, queue):
    """The port's steps take JAX's patches in turn, for the same images."""
    it = iter(queue)

    def make_extract_fn(sampler, ecfg):
        def extract(imgs_raw, generator, img_hw=None):
            raw, patches, pos, scales = next(it)
            np.testing.assert_array_equal(imgs_raw.numpy(), raw)
            return (torch.from_numpy(patches), torch.from_numpy(pos),
                    torch.from_numpy(scales) if scales.size else None)
        return extract

    monkeypatch.setattr(tsteps, "make_extract_fn", make_extract_fn)
    return it


# the engine's quirks on top of the plain run: the freeze schedule (frozen
# in epoch 1, "-frz" in the directory name), loss-weight decay, the
# per-batch LR schedule, weighted losses and periodic checkpoints; and
# three-scale patches with the scale embedding on 160x160 images (12
# pairs an epoch, as the others: on 8, the 5-parameter logistic fit behind
# PLCC has 3 degrees of freedom and turned fp32 rounding into 4e-3)
VARIANTS = {
    "plain": {},
    "freeze_decay_periodic": dict(
        glob=dict(weight_mae_loss_decay=0.5, weight_pears_loss_decay=0.8,
                  scheduler_step_per_batch=True, use_weighted_loss=True,
                  checkpoint_every_n_batches=2),
        freeze=True),
    "multiscale": dict(glob=dict(do_val=False), scales=3),
}


def _apply_variant(mod, variant, root):
    mod.global_config.update(variant.get("glob", {}))
    if variant.get("freeze"):
        mod.freeze_config["freeze_vtamiq"] = True
        mod.freeze_config["freeze_end_after_epochs"][mod.DATASET_TID2013] = 1
    if variant.get("scales"):
        mod.vit_config["num_scales"] = variant["scales"]
        mod.dataset_config_base.update(patch_num_scales=variant["scales"],
                                       patch_sampling_num_scales_ratio=2.0)
        base = mod._DATASET_REGISTRY[mod.DATASET_TID2013][0]
        one_ref = type("OneRef", (base,), {"num_ref_images": 1, "num_dist_images": 12})
        mod._DATASET_REGISTRY[mod.DATASET_TID2013] = (
            one_ref, mod.setup_split_config([0], [0], [0]))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_matches_jax(request, configs, tid_root, tmp_path, monkeypatch, variant):
    if rerun_in_fresh_process(request):  # see tests/test_torch_process_state.py
        return
    if VARIANTS[variant].get("scales"):  # big enough for 3 pyramid levels
        from vtamiq_tpu_torch.data import synth
        tid_root = str(tmp_path / "big")
        synth.generate_tid2013(f"{tid_root}/tid2013", hw=(160, 160), image_refs=1)
    init = str(tmp_path / "init")
    setup_tiny(JC, JTID2013Dataset, tid_root, str(tmp_path / "jax_out"))
    _apply_variant(JC, VARIANTS[variant], tid_root)
    JC.validate_configs()
    jsave_checkpoint(init, "init.npz", {JC.MODEL_STATE_DICT: jinit(
        jax.random.PRNGKey(3), JC.build_model_config())}, 0, -1.0)
    common = dict(do_train=True, do_val=True, do_test=True, save_optimizer=True,
                  tensorlog_every_n_steps=1, load_checkpoint_file=f"{init}/init.npz")
    JC.global_config.update(common, config_validated=False)
    _apply_variant(JC, VARIANTS[variant], tid_root)
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "torch_out"), **common)
    _apply_variant(C, VARIANTS[variant], tid_root)

    queue = []
    _record_jax_draws(monkeypatch, queue)
    jcors = jengine.train()
    jdir = JC.global_config["output_dir_final"]
    rest = _feed_jax_draws(monkeypatch, queue)
    cors = engine.train()
    tdir = C.global_config["output_dir_final"]
    assert next(rest, None) is None  # every recorded step was replayed

    # 3 train + 1 val batches per epoch, 2 epochs, then 2 test repeats
    # (one reference of 12 pairs for the multiscale run: 2 x 3 + 2 x 3, no val)
    assert len(queue) == (2 * 3 + 2 * 3 if variant == "multiscale" else 2 * (3 + 1) + 2)
    if variant == "multiscale":
        assert len(np.unique(queue[0][3])) == 3  # the scale ids of three scales
    assert os.path.basename(tdir).split("-", 1)[1] == os.path.basename(jdir).split("-", 1)[1]
    assert ("-frz" in tdir) == bool(VARIANTS[variant].get("freeze"))
    jfiles = {f for f in os.listdir(jdir) if not f.startswith("events.out")}
    assert sorted(f for f in os.listdir(tdir) if not f.startswith("events.out")) == sorted(jfiles)
    assert sorted(os.listdir(os.path.join(tdir, "source_code"))) == \
        sorted(os.listdir(os.path.join(jdir, "source_code")))
    with open(os.path.join(tdir, "model_params.txt")) as f, \
            open(os.path.join(jdir, "model_params.txt")) as g:
        assert f.read() == g.read()

    jscalars, tscalars = _scalars(jdir), _scalars(tdir)
    assert [(s["tag"], s["step"]) for s in tscalars] == [(s["tag"], s["step"]) for s in jscalars]
    for t, j in zip(tscalars, jscalars):
        assert t["value"] == pytest.approx(j["value"], rel=TOL, abs=TOL), t["tag"]
    train_steps = 6
    assert sum("Training/0.loss" == s["tag"] for s in tscalars) == train_steps
    for field in ("SROCC", "KROCC", "PLCC", "RMSE"):
        assert cors[field] == pytest.approx(jcors[field], abs=TOL), field

    # the checkpoints: the same leaves, weights and optimizer state to 1e-4
    jck, tck = jload_checkpoint(os.path.join(jdir, "latest.npz")), \
        load_checkpoint(os.path.join(tdir, "latest.npz"))
    jflat = jax.tree_util.tree_flatten_with_path(jck[C.MODEL_STATE_DICT])[0]
    assert len(jflat) == len(tck[C.MODEL_STATE_DICT])
    for path, leaf in jflat:
        key = "|".join(str(k.key) for k in path)
        np.testing.assert_allclose(tck[C.MODEL_STATE_DICT][key], np.asarray(leaf),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert len(tck[OPT_LEAVES]) == len(jck["__opt_leaves__"])
    assert int(tck[OPT_LEAVES][0]) == int(jck["__opt_leaves__"][0]) == train_steps
    assert tck["epoch"] == jck["epoch"] == 2
    for key in ("w_mae", "w_rank", "w_pears", "global_step_train", "global_step_val"):
        assert tck["meta"][key] == jck["meta"][key], key


def test_resume_carries_epoch_optimizer_and_run_state(configs, tid_root, tmp_path):
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=True, do_test=False, num_epochs=1, save_optimizer=True,
               weight_rank_loss_decay=0.5, allow_use_full_dataset=False)
    engine.train()
    first = load_checkpoint(os.path.join(C.global_config["output_dir_final"], "latest.npz"))
    assert int(first[OPT_LEAVES][0]) == 3 and first["meta"]["global_step_train"] == 3

    C.global_config.update(num_epochs=2, config_validated=False,
                           resume_checkpoint_file=os.path.join(
                               C.global_config["output_dir_final"], "latest.npz"))
    engine.train()
    assert [s["epoch"] for s in engine.last_run_stats["train"]] == [2]
    second = load_checkpoint(os.path.join(C.global_config["output_dir_final"], "latest.npz"))
    assert second["epoch"] == 2
    assert int(second[OPT_LEAVES][0]) == 6  # the optimizer's count went on
    assert second["meta"]["global_step_train"] == 6
    assert second["meta"]["w_rank"] == pytest.approx(first["meta"]["w_rank"] * 0.5)


def test_compute_dtype_mixed_runs(configs, tid_root, tmp_path):
    """compute_dtype "mixed" (fp32 stream, bf16 matmul inputs) runs through
    the engine; the gather then cuts bf16 patches."""
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=False, do_test=True, compute_dtype="mixed", num_epochs=1,
               allow_use_full_dataset_test=False)
    cors = engine.train()
    assert np.isfinite(cors["PLCC"])


def test_debug_run_writes_nothing(configs, tid_root, tmp_path):
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), is_debug=True,
               do_train=True, do_val=False, do_test=True, num_epochs=1)
    assert engine.train() is not None
    assert not os.path.exists(str(tmp_path / "out"))


def test_test_only_uses_full_dataset_override(configs, tid_root, tmp_path):
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=False,
               do_val=False, do_test=True, allow_use_full_dataset=True)
    assert engine.train() is not None
    # the FULL dataset, 5 refs x 4 dists, in each of the 2 test repeats
    assert [s["pairs"] for s in engine.last_run_stats["test"]] == [20, 20]
    assert "TESTSET-16" in C.global_config["output_dir_final"]


def test_recovery_from_latest_after_a_transient_fault(configs, tid_root, tmp_path,
                                                      monkeypatch):
    """A transient fault in a train step rebuilds params and optimizer from
    latest.npz and redoes the batch; a context-poisoning CUDA error is
    raised."""
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=False, do_test=False, num_epochs=1, save_optimizer=True,
               checkpoint_every_n_batches=1, allow_use_full_dataset=False)
    orig = tsteps.make_train_step
    calls = {"n": 0, "fault_at": 2, "msg": "UNAVAILABLE: device error"}

    def make_train_step(*args, **kwargs):
        step = orig(*args, **kwargs)

        def faulty(*a, **k):
            calls["n"] += 1
            if calls["n"] == calls["fault_at"]:
                raise RuntimeError(calls["msg"])
            return step(*a, **k)
        return faulty

    monkeypatch.setattr(engine, "make_train_step", make_train_step)
    engine.train()
    assert calls["n"] == 4  # 3 batches, the second one twice
    assert engine.last_run_stats["train"][0]["batches"] == 3

    calls.update(n=0, msg="CUDA error: an illegal memory access was encountered")
    C.global_config["config_validated"] = False
    with pytest.raises(RuntimeError, match="illegal memory access"):
        engine.train()
    assert calls["n"] == 2


def test_unported_options_and_missing_card_raise(configs, tid_root, tmp_path):
    """A mesh with no process group raises ValueError naming the way to
    start one (meshes run in tests/test_torch_parallel.py); PU input, the
    preference module and ImageNet ViT weights run (below); with no card the
    default device raises."""
    for overrides in (dict(mesh_data=2), dict(mesh_model=2), dict(mesh_seq=2)):
        defaults = {k: C.global_config[k] for k in overrides}
        setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
                   **overrides)
        with pytest.raises(ValueError, match="parallel.distributed.initialize"):
            engine.train()
        C.global_config.update(defaults)
    if not torch.cuda.is_available():
        setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.train()


def test_custom_run_debug(configs, tid_root, tmp_path, monkeypatch):
    from vtamiq_tpu_torch.train import run_custom
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"))
    orig = run_custom.engine.train

    def short_train():  # custom_run sets 20 epochs; one is enough here
        C.global_config.update(num_epochs=1, num_repeats_test=1)
        return orig()

    monkeypatch.setattr(run_custom.engine, "train", short_train)
    assert run_custom.custom_run() is not None
    assert C.global_config["is_debug"] and not os.path.exists(str(tmp_path / "out"))


def test_run_multi_two_runs(configs, tid_root, tmp_path, monkeypatch):
    from vtamiq_tpu_torch.train import run_multi
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), num_repeats_test=1)
    orig = run_multi.engine.train

    def short_train():
        C.global_config["num_epochs"] = 1
        return orig()

    monkeypatch.setattr(run_multi.engine, "train", short_train)
    monkeypatch.chdir(tmp_path)  # run_multi writes ./output
    stats = run_multi.main(num_runs=2, dataset=C.DATASET_TID2013)
    assert set(stats) == {"SROCC", "KROCC", "PLCC", "RMSE"}
    assert all(np.isfinite(stats[f]["mean"]) for f in stats)
    multirun = [d for d in os.listdir(tmp_path / "output") if "multirun" in d]
    assert len(multirun) == 1
    runs = [d for d in os.listdir(tmp_path / "output" / multirun[0])
            if os.path.isdir(tmp_path / "output" / multirun[0] / d)]
    assert len(runs) >= 1 and os.path.isfile(tmp_path / "output" / multirun[0] / "results.txt")


def test_cross_database_test_set(configs, tid_root, tmp_path):
    """dataset_test: train on one dataset (a tiny KADID-10k tree, PNG), test
    on another (the TID2013 tree, BMP); the run is named after the first."""
    from test_datasets import make_kadid
    from vtamiq_tpu_torch.data.datasets import KADID10kDataset
    make_kadid(tid_root, num_ref=3, num_dist=4)

    class TinyKADID(KADID10kDataset):
        num_ref_images, num_dist_images = 3, 4

        def __init__(self, **kw):
            kw.setdefault("datasets_root", tid_root)
            super().__init__(**kw)

    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=True, do_test=True, num_epochs=1, num_repeats_test=1,
               dataset=C.DATASET_KADID10K, dataset_test=C.DATASET_TID2013)
    C._DATASET_REGISTRY[C.DATASET_KADID10K] = (TinyKADID, C.setup_split_config(2, [2], [2]))
    assert np.isfinite(engine.train()["SROCC"])
    assert "-KADID10k-" in C.global_config["output_dir_final"]
    assert [s["pairs"] for s in engine.last_run_stats["train"]] == [8]
    assert [s["pairs"] for s in engine.last_run_stats["test"]] == [4]  # TID ref 4


def test_pretrain_kadis_then_finetune_through_gates(configs, tmp_path):
    """run_custom's weak-label workflow: a KADIS-700k pretrain writes a
    checkpoint, the labeled fine-tune starts from it through the
    pretraining gates: the ViT is carried over verbatim, re-initialized when
    its gate is closed, while the DiffNet gate still loads the decoder."""
    from vtamiq_tpu_torch.data import synth
    from vtamiq_tpu_torch.data.datasets import KADIS700kDataset
    from vtamiq_tpu_torch.models.checkpoint import params_to_jax
    from vtamiq_tpu_torch.train.run_custom import pretrain_kadis_then_finetune
    root = str(tmp_path)
    synth.generate_kadis700k(f"{root}/kadis700k", num_refs=8, hw=(64, 96))
    synth.generate_tid2013(f"{root}/tid2013", num_refs=6, num_types=6, num_levels=4,
                           hw=(64, 96), seed=77)

    class TinyKADIS(KADIS700kDataset):
        num_ref_images, num_dist_images = 8, 5

        def __init__(self, **kw):
            kw.setdefault("datasets_root", root)
            super().__init__(**kw)

    setup_tiny(C, TID2013Dataset, root, str(tmp_path / "out"), num_repeats_test=1,
               optimizer_learning_rate=1e-3, is_verbose=False, seed=11)
    C._DATASET_REGISTRY[C.DATASET_TID2013] = (type("TinyTID", (C._DATASET_REGISTRY[
        C.DATASET_TID2013][0],), {"num_ref_images": 6, "num_dist_images": 24}),
        C.setup_split_config(4, (4, 5), (5, 6)))
    C._DATASET_REGISTRY[C.DATASET_KADIS700K] = (TinyKADIS, C.setup_split_config(8, 0, 0))
    for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
        C.dataloader_config_base[split][C.BATCH_SIZE] = 8

    ckpt, cors = pretrain_kadis_then_finetune(kadis_epochs=1,
                                              finetune_dataset=C.DATASET_TID2013,
                                              finetune_epochs=1)
    assert os.path.isfile(ckpt) and np.isfinite(cors["SROCC"])
    saved = load_checkpoint(ckpt)[C.MODEL_STATE_DICT]
    cfg = C.build_model_config()
    loaded = params_to_jax(engine.get_model_params(cfg, ckpt, seed=11))
    cold = params_to_jax(engine.get_model_params(cfg, None, seed=11))
    vit = [k for k in saved if k.startswith("vit|")]
    assert vit and all(np.array_equal(loaded[k], saved[k]) for k in vit)
    assert any(not np.array_equal(loaded[k], cold[k]) for k in vit)
    C.pretraining_config["allow_pretrained_weights_vit"] = False
    gated = params_to_jax(engine.get_model_params(cfg, ckpt, seed=11))
    assert all(np.array_equal(gated[k], cold[k]) for k in vit)
    decoder = [k for k in saved if k.startswith("quality_decoder|")]
    assert decoder and all(np.array_equal(gated[k], saved[k]) for k in decoder)


def test_pairwise_training_raises(configs, tid_root, tmp_path):
    """PieAPP's pairwise train set parses and trains through the engine
    (pairwise losses, finite correlations); a K = 3 batch handed to the
    two-tower forward raises."""
    from test_datasets import make_pieapp_train
    from vtamiq_tpu_torch.data.datasets import PieAPPTrainPairwise
    from vtamiq_tpu_torch.models.vtamiq import vtamiq_forward
    make_pieapp_train(tid_root, num_ref=2, num_pairs=3)

    class TinyPieAPP(PieAPPTrainPairwise):
        num_ref_images, num_dist_images = 2, 3

        def __init__(self, **kw):
            kw.setdefault("datasets_root", tid_root)
            super().__init__(**kw)

    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=False, do_test=False, dataset=C.DATASET_PIEAPP_TRAIN, num_epochs=1)
    C._DATASET_REGISTRY[C.DATASET_PIEAPP_TRAIN] = (TinyPieAPP, C.setup_split_config(2, 0, 0))
    assert engine.train() is not None
    assert [s["pairs"] for s in engine.last_run_stats["train"]] == [6]
    params = engine.get_model_params(C.build_model_config(), seed=0)
    with pytest.raises(ValueError, match="2 towers"):
        vtamiq_forward(params, C.build_model_config(), torch.zeros(1, 3, 4, 16, 16, 3),
                       torch.zeros(1, 3, 4, 2))


# --------------------------------------------------------------------------
# the PieAPP pretraining recipe: pairwise preference training
# --------------------------------------------------------------------------

PIEAPP_REFS, PIEAPP_PAIRS = 6, 4


def _setup_pieapp(mod, base_cls, root, out, **overrides):
    """A tiny PieAPP tree (6 references, 4 pairs each, 48x64): train on 4
    references, val and test on one each."""
    setup_tiny(mod, TID2013Dataset if mod is C else JTID2013Dataset, root, out, **overrides)

    class TinyPieAPP(base_cls):
        num_ref_images, num_dist_images = PIEAPP_REFS, PIEAPP_PAIRS

        def __init__(self, **kw):
            kw.setdefault("datasets_root", root)
            super().__init__(**kw)

    mod._DATASET_REGISTRY[mod.DATASET_PIEAPP_TRAIN] = (
        TinyPieAPP, mod.setup_split_config(4, [4], [5]))
    mod.global_config.update(dataset=mod.DATASET_PIEAPP_TRAIN)


@pytest.fixture
def pieapp_root(tmp_path):
    from vtamiq_tpu_torch.data import synth
    root = str(tmp_path / "pieapp")
    synth.generate_pieapp(f"{root}/PieAPP_dataset", train_refs=PIEAPP_REFS,
                          pairs_per_ref=PIEAPP_PAIRS, test_refs=1, test_dist=2, hw=(48, 64),
                          image_refs=None, image_test_refs=1)
    return root


@pytest.mark.parametrize("use_pref_module", [True, False])
def test_pairwise_engine_matches_jax(request, configs, pieapp_root, tmp_path, monkeypatch,
                                     use_pref_module):
    """engine.train() on PieAPP pairs against JAX's: train, val and test,
    two epochs, on JAX's recorded patches; per-step losses, correlations,
    the checkpoint's model, preference module and optimizer to 1e-4."""
    if rerun_in_fresh_process(request):  # see tests/test_torch_process_state.py
        return
    from vtamiq_tpu.data.datasets import PieAPPTrainPairwise as JPieAPP
    from vtamiq_tpu_torch.data.datasets import PieAPPTrainPairwise
    init = str(tmp_path / "init")
    common = dict(do_train=True, do_val=True, do_test=True, save_optimizer=True,
                  tensorlog_every_n_steps=1, use_pref_module=use_pref_module,
                  load_checkpoint_file=f"{init}/init.npz")
    _setup_pieapp(JC, JPieAPP, pieapp_root, str(tmp_path / "jax_out"))
    JC.validate_configs()
    jsave_checkpoint(init, "init.npz", {JC.MODEL_STATE_DICT: jinit(
        jax.random.PRNGKey(3), JC.build_model_config())}, 0, -1.0)
    JC.global_config.update(common, config_validated=False)
    _setup_pieapp(C, PieAPPTrainPairwise, pieapp_root, str(tmp_path / "torch_out"), **common)

    queue = []
    _record_jax_draws(monkeypatch, queue)
    jcors = jengine.train()
    jdir = JC.global_config["output_dir_final"]
    rest = _feed_jax_draws(monkeypatch, queue)
    cors = engine.train()
    tdir = C.global_config["output_dir_final"]
    assert next(rest, None) is None
    # 16 train pairs: 4 batches, 4 val and 4 test pairs: 1 batch each
    assert len(queue) == 2 * (4 + 1) + 2 and queue[0][0].shape[1] == 3  # K = 3 towers
    assert os.path.basename(tdir).split("-", 1)[1] == os.path.basename(jdir).split("-", 1)[1]
    assert tdir.endswith("-pref") == use_pref_module
    with open(os.path.join(tdir, "model_params.txt")) as f, \
            open(os.path.join(jdir, "model_params.txt")) as g:
        assert f.read() == g.read()
    jscalars, tscalars = _scalars(jdir), _scalars(tdir)
    assert [(s["tag"], s["step"]) for s in tscalars] == [(s["tag"], s["step"]) for s in jscalars]
    for t, j in zip(tscalars, jscalars):
        if not use_pref_module and t["tag"].startswith("Training/") and \
                t["tag"].endswith(("PLCC", "RMSE")):
            # without the module's scale of 6 the 16 train preferences sit
            # near 0.5, and the 5-parameter logistic behind PLCC and RMSE
            # is ill-conditioned there: fp32 rounding moves its optimum
            # (0.39 against 0.22 in one run, with every loss, SROCC and
            # KROCC equal to 1e-4)
            assert np.isfinite(t["value"]), t["tag"]
            continue
        assert t["value"] == pytest.approx(j["value"], rel=TOL, abs=TOL), t["tag"]
    for field in ("SROCC", "KROCC", "PLCC", "RMSE"):
        assert cors[field] == pytest.approx(jcors[field], abs=TOL), field

    jck, tck = jload_checkpoint(os.path.join(jdir, "latest.npz")), \
        load_checkpoint(os.path.join(tdir, "latest.npz"))
    for name in (C.MODEL_STATE_DICT, C.PREF_MODULE_STATE_DICT):
        assert (name in tck) == (name in jck) == (
            use_pref_module or name == C.MODEL_STATE_DICT)
        if name not in jck:
            continue
        jflat = dict((("|".join(str(k.key) for k in path)), np.asarray(leaf)) for path, leaf in
                     jax.tree_util.tree_flatten_with_path(jck[name])[0])
        assert sorted(jflat) == sorted(tck[name])
        for key, leaf in jflat.items():
            np.testing.assert_allclose(tck[name][key], leaf, rtol=TOL, atol=TOL, err_msg=key)
    assert len(tck[OPT_LEAVES]) == len(jck["__opt_leaves__"])
    if use_pref_module:
        assert float(tck[C.PREF_MODULE_STATE_DICT]["p"]) != 6.0


def test_preference_module_save_resume_and_test(configs, pieapp_root, tmp_path):
    """The preference module is saved apart from the model, reloaded bit for
    bit on resume (and trains on), and the test after training keeps the
    final epoch's in-memory module over the reloaded best checkpoint's."""
    from vtamiq_tpu_torch.data.datasets import PieAPPTrainPairwise
    _setup_pieapp(C, PieAPPTrainPairwise, pieapp_root, str(tmp_path / "out"), do_train=True,
                  do_val=True, do_test=False, num_epochs=1, save_optimizer=True,
                  use_pref_module=True, optimizer_learning_rate=1e-2)
    engine.train()
    latest = os.path.join(C.global_config["output_dir_final"], "latest.npz")
    first = load_checkpoint(latest)
    p1 = float(first[C.PREF_MODULE_STATE_DICT]["p"])
    assert p1 != 6.0 and not any(k.startswith("pref_module") for k in first[C.MODEL_STATE_DICT])

    restored = {}
    orig = engine.do_training

    def capture(train_step, params, *args, **kwargs):
        restored["p"] = params.pref_module.p.detach().clone()
        return orig(train_step, params, *args, **kwargs)

    C.global_config.update(num_epochs=2, config_validated=False, resume_checkpoint_file=latest,
                           do_test=True)
    engine.do_training = capture
    tested = {}
    orig_val = engine.do_validation

    def capture_test(eval_step, params, *args, **kwargs):
        if kwargs.get("tag") == "test":
            tested["p"] = float(params.pref_module.p.detach())
        return orig_val(eval_step, params, *args, **kwargs)

    engine.do_validation = capture_test
    try:
        engine.train()
    finally:
        engine.do_training, engine.do_validation = orig, orig_val
    assert restored["p"].dtype == torch.float32 and float(restored["p"]) == p1
    out = C.global_config["output_dir_final"]
    second = load_checkpoint(os.path.join(out, "latest.npz"))
    p2 = float(second[C.PREF_MODULE_STATE_DICT]["p"])
    assert p2 != p1
    assert tested["p"] == p2  # the final epoch's module, whatever best.npz holds
    recovered = engine.get_model_params(C.build_model_config(), os.path.join(out, "latest.npz"),
                                        force_load_pretrained=True, use_pref_module=True)
    assert float(recovered.pref_module.p.detach()) == p2


def test_use_pu_run(configs, tid_root, tmp_path, monkeypatch):
    """use_pu: the normalization is off and the extraction PU-encodes the
    images; a run trains and tests with finite correlations, its gathered
    patches in the encoded [0, 1] range (fp32)."""
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"), do_train=True,
               do_val=False, do_test=True, num_epochs=1, use_pu=True, num_repeats_test=1)
    seen = []
    orig = tsteps.make_extract_fn

    def make_extract_fn(sampler, ecfg):
        assert ecfg.pu_display_encode and ecfg.norm_mean is None
        extract = orig(sampler, ecfg)

        def spy(imgs_raw, generator, img_hw=None):
            out = extract(imgs_raw, generator, img_hw)
            seen.append((float(out[0].min()), float(out[0].max())))
            return out
        return spy

    monkeypatch.setattr(tsteps, "make_extract_fn", make_extract_fn)
    cors = engine.train()
    assert np.isfinite(cors["SROCC"]) and seen
    assert all(0.0 <= lo and hi <= 1.0 for lo, hi in seen)


def test_vit_weights_path_loads_imagenet_weights(configs, tid_root, tmp_path):
    """vit_weights_path: get_model_params loads a ViT-B_16-layout file
    under allow_pretrained_vit (a missing file warns and keeps the random
    ViT)."""
    from vtamiq_tpu_torch.data import synth
    setup_tiny(C, TID2013Dataset, tid_root, str(tmp_path / "out"))
    cfg = C.build_model_config()
    path = synth.write_vit_npz(str(tmp_path / "vit.npz"), hidden=32, heads=2, mlp=64,
                               layers=1, grid=14, seed=5)
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, vit_weights_path=path))
    kernel = synth.vit_npz_arrays(hidden=32, heads=2, mlp=64, layers=1, grid=14, seed=5)[
        "Transformer/encoderblock_0/MlpBlock_3/Dense_0/kernel"]
    loaded = engine.get_model_params(cfg, seed=0)
    assert np.array_equal(loaded.vit.encoder.layers.layer_0.mlp.fc1.kernel.detach().numpy(),
                          kernel)
    C.pretraining_config["allow_pretrained_vit"] = False
    closed = engine.get_model_params(cfg, seed=0)
    assert not np.array_equal(closed.vit.encoder.layers.layer_0.mlp.fc1.kernel.detach().numpy(),
                              kernel)
