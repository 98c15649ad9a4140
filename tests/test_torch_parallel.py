"""The port's parallel package (``vtamiq_tpu_torch/parallel/``), the
loader's per-process views and ``engine.train()`` on a mesh, on the CPU.

- The loader's views (``process_index`` / ``process_count``) bit for bit
  against the JAX package's on the same trees, fixed-size and bucketed (the
  cases of ``tests/test_multihost.py``); ``process_shard`` against JAX's.
- ``param_specs`` against JAX's ``_param_spec`` for every parameter name.
- ``shard_params`` then ``unshard_params`` gives back the same tensors, and
  each shard is its slice (worlds of 2 and 4 processes over gloo).
- The extraction's ``batch_rows``: each rank's rows of a global batch get
  the patches one process draws for them.
- ``engine.train()`` with ``mesh_data = 2`` (and with ``mesh_model = 2``,
  ``mesh_seq = 2``) in a world of 2 against the port's single-process
  ``engine.train()`` on the same tree and global batch: every logged scalar
  (per-step losses, the epochs' correlations) to 1e-4, with the encoder
  frozen for the first epoch, test correlations equal on both ranks, files written by rank 0 alone, a checkpoint in the
  single-process layout; then the same for a resumed run.
- A world size that does not match the mesh, and NCCL asked for two ranks
  on one device, raise; so does a mesh with no process group.

The worlds are spawned once for the file (``tests/torch_mesh_worker.py``).
"""

import json
import os
import subprocess
import sys
from copy import deepcopy

import jax
import numpy as np
import pytest
import torch

from test_datasets import make_tid
from test_torch_datasets import _assert_same_batches
from test_torch_train_step import HEAD_KW, VIT_KW
from test_varsize import make_multisize_tid
from torch_mesh_worker import spawn_world
from vtamiq_tpu.data.pipeline import PatchDatasetLoader as JLoader
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.parallel.distributed import process_shard as jprocess_shard
from vtamiq_tpu.parallel.mesh import MODEL_AXIS as JMODEL_AXIS
from vtamiq_tpu.parallel.mesh import _param_spec, _path_str
from vtamiq_tpu_torch.data import datasets as D
from vtamiq_tpu_torch.data.pipeline import PatchDatasetLoader
from vtamiq_tpu_torch.models.checkpoint import MODEL_STATE_DICT, OPT_LEAVES, load_checkpoint
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, init_vtamiq_params
from vtamiq_tpu_torch.ops.extraction import get_iqa_patches
from vtamiq_tpu_torch.ops.sampling import (DIFF_TYPE_MAGNITUDE, GRID_TYPE_PERTURBED,
                                           PatchSampler)
from vtamiq_tpu_torch.parallel import distributed as TD
from vtamiq_tpu_torch.parallel.mesh import (Mesh, make_mesh, param_shardings, param_specs,
                                            shard_batch, shard_params)
from vtamiq_tpu_torch.train import config as C
from vtamiq_tpu_torch.train import engine

TOL = 1e-4  # fp32 on every rank and in the single process; sums in other orders
NUM_REF, NUM_DIST = 5, 4
ENGINE = dict(num_ref=NUM_REF, num_dist=NUM_DIST, splits=[[0, 1, 2], [3], [4]], patches=16,
              vit=dict(num_keep_layers=1, num_extra_tokens=2, hidden_size=32, mlp_dim=64,
                       num_heads=2, path_drop_prob=0.0),
              head=dict(num_rgs=1, num_rcabs=1, ca_reduction=4, rg_path_drop=0.1,
                        predictor_dropout=0.1),
              # the encoder frozen for the first epoch: the freeze schedule's
              # masks on TP shards and its switch under every mesh
              freeze=dict(freeze_vtamiq=True, freeze_end_after_epochs={"TID2013": 1}))
ENGINE_GLOBAL = dict(num_epochs=2, num_repeats_test=2, compute_dtype="float32", seed=7,
                     tensorlog_every_n_steps=1, save_optimizer=True, do_train=True,
                     do_val=True, do_test=True, is_debug=False, is_verbose=False)


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

# name -> (mesh_data, mesh_model, mesh_seq); the batch of a data rank is the
# single process's 4 over mesh_data
ENGINE_MESHES = {"engine_dp": (2, 1, 1), "engine_tp": (1, 2, 1), "engine_seq": (1, 1, 2)}


def _engine_case(root, out, name):
    d, m, s = ENGINE_MESHES[name]
    return {"kind": "engine", "name": name, "root": root, "batch": 4 // d,
            "global": dict(ENGINE_GLOBAL, output_dir=out, mesh_data=d, mesh_model=m,
                           mesh_seq=s), "rank_dirs": True, **ENGINE}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    data = str(root / "data")
    make_tid(data, num_ref=NUM_REF, num_dist=NUM_DIST)
    small = dict(vit=dict(VIT_KW), head=dict(HEAD_KW))
    cases2 = [{"kind": "nccl_same_device", "name": "nccl"},
              {"kind": "mesh_errors", "name": "errors", "data": 3},
              {"kind": "shard_roundtrip", "name": "roundtrip", "model": 2, **small},
              *(_engine_case(data, str(root / name), name) for name in ENGINE_MESHES)]
    cases4 = [{"kind": "shard_roundtrip", "name": "roundtrip", "model": 2, **small}]
    started = {2: spawn_world(2, cases2, {}, str(root / "w2")),
               4: spawn_world(4, cases4, {}, str(root / "w4"))}
    torchrun = _start_multihost_train(root, data)
    single = _single_engine(data, str(root / "single_out"))
    out, _ = torchrun.communicate(timeout=300)
    assert torchrun.returncode == 0, out
    results = {w: s.results() for w, s in started.items()}
    multihost = {"root": root, "ranks": []}
    for rank in range(2):
        with open(root / f"multihost.json.rank{rank}.json") as f:
            multihost["ranks"].append(json.load(f))
    return results, single, multihost


def _start_multihost_train(root, data):
    """``multihost_train`` under torchrun (two CPU ranks over gloo, model =
    2), on the engine test's tree and model."""
    spec = {"root": data, "output_dir": str(root / "multihost_out"),
            "argv": ["--device", "cpu", "--backend", "gloo", "--epochs", "1",
                     "--batch-size", "4", "--model", "2"], **ENGINE}
    path = str(root / "multihost.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         worker, "--multihost-train", path],
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _configure(root, out, batch):
    class TinyTID(D.TID2013Dataset):
        num_ref_images = NUM_REF
        num_dist_images = NUM_DIST

        def __init__(self, **kwargs):
            kwargs.setdefault("datasets_root", root)
            super().__init__(**kwargs)

    C._DATASET_REGISTRY[C.DATASET_TID2013] = (TinyTID, C.setup_split_config(*ENGINE["splits"]))
    C.global_config.update(ENGINE_GLOBAL, dataset=C.DATASET_TID2013, device="cpu",
                           output_dir=out, config_validated=False)
    C.vit_config.update(ENGINE["vit"])
    C.vtamiq_config.update(ENGINE["head"])
    C.freeze_config.update(ENGINE["freeze"])
    C.dataloader_config_base[C.DATALOADER_PARAMS][C.USE_DEFAULT_PARAMS] = True
    for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
        C.dataloader_config_base[split][C.BATCH_SIZE] = batch
        C.dataloader_config_base[split][C.PATCH_COUNT] = ENGINE["patches"]


def _single_engine(root, out):
    """The port's single-process engine on the global batch (2 x 2), then
    a resumed run: (correlations, output dir) of each."""
    names = ("global_config", "vit_config", "vtamiq_config", "freeze_config",
             "dataloader_config_base")
    snaps = {n: deepcopy(getattr(C, n)) for n in names}
    registry = dict(C._DATASET_REGISTRY)
    try:
        _configure(root, out, batch=4)
        first = engine.train(), C.global_config["output_dir_final"]
        C.global_config.update(num_epochs=3, config_validated=False,
                               resume_checkpoint_file=os.path.join(first[1], "latest.npz"))
        return first, (engine.train(), C.global_config["output_dir_final"])
    finally:
        for n, v in snaps.items():
            getattr(C, n).clear()
            getattr(C, n).update(v)
        C._DATASET_REGISTRY.clear()
        C._DATASET_REGISTRY.update(registry)


def _scalars(out_dir):
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["first", "resumed"])
@pytest.mark.parametrize("name", sorted(ENGINE_MESHES))
def test_engine_on_a_mesh_matches_single_process(worlds, name, run):
    """Data parallel (2 x 2 pairs), tensor parallel and sequence parallel
    (4 pairs on both ranks) against one process on the same 4 pairs."""
    results, single, _ = worlds
    (_, v0), (_, v1) = results[2]
    i = 0 if run == "first" else 1
    mesh0, mesh1 = v0[name]["runs"][i], v1[name]["runs"][i]
    cors, single_dir = single[i]
    # every rank ends with the same correlations: predictions are gathered
    assert mesh0["correlations"] == mesh1["correlations"]
    for key, want in cors.items():
        assert mesh0["correlations"][key] == pytest.approx(float(want), rel=TOL, abs=TOL), key
    want, got = _scalars(single_dir), _scalars(mesh0["output_dir_final"])
    assert [(s["tag"], s["step"]) for s in got] == [(s["tag"], s["step"]) for s in want]
    for g, w in zip(got, want):
        if g["tag"].startswith("Training/") and g["tag"].endswith(("PLCC", "RMSE")):
            # the 5-parameter logistic behind PLCC and RMSE is ill-conditioned
            # on 12 training predictions with a near-zero SROCC: fp32
            # rounding (1e-7 here) moves its optimum by up to 6e-3, with
            # every loss, SROCC and KROCC equal to 1e-6
            # (tests/test_torch_engine.py sees the same against JAX)
            assert np.isfinite(g["value"]), g["tag"]
            continue
        assert g["value"] == pytest.approx(w["value"], rel=TOL, abs=TOL), g["tag"]
    # 3 global batches an epoch: two epochs, then one resumed
    assert sum(s["tag"] == "Training/0.loss" for s in got) == (6 if run == "first" else 3)
    # rank 0 alone writes: rank 1's output root was never created
    assert {"latest.npz", "scalars.jsonl", "config.yaml"} <= set(mesh0["files"])
    assert ("best.npz" in mesh0["files"]) == ("best.npz" in os.listdir(single_dir))
    assert mesh0["output_dir_final"].endswith("-frz") and single_dir.endswith("-frz")
    assert not os.path.exists(os.path.dirname(mesh1["output_dir_final"]))
    if run == "resumed":
        assert [s["epoch"] for s in mesh0["train_stats"]] == [3]
    # the checkpoint of a mesh run is a single-process one: the TP shards
    # of the model and of the optimizer's moments are gathered before saving
    got = load_checkpoint(os.path.join(mesh0["output_dir_final"], "latest.npz"))
    want = load_checkpoint(os.path.join(single_dir, "latest.npz"))
    for key in (MODEL_STATE_DICT, OPT_LEAVES):
        assert type(got[key]) is type(want[key])
    for k, w in want[MODEL_STATE_DICT].items():
        np.testing.assert_allclose(got[MODEL_STATE_DICT][k], w, rtol=TOL, atol=TOL, err_msg=k)
    assert len(got[OPT_LEAVES]) == len(want[OPT_LEAVES])
    for g, w in zip(got[OPT_LEAVES], want[OPT_LEAVES]):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert got["epoch"] == want["epoch"]


def test_multihost_train_runs_under_torchrun(worlds):
    """The script's ranks (torchrun's environment, the rendezvous from it)
    train, test and agree on the correlations; one output directory."""
    multihost = worlds[2]
    got = multihost["ranks"]
    assert got[0] == got[1] and np.isfinite(got[0]["SROCC"])
    runs = os.listdir(multihost["root"] / "multihost_out")
    assert len(runs) == 1 and "best.npz" in os.listdir(multihost["root"] / "multihost_out"
                                                        / runs[0])


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

def test_a_world_that_does_not_match_the_mesh_raises(worlds):
    results, _, _ = worlds
    for _, values in results[2]:
        assert values["errors"]["make_mesh"] == "Mesh 3x1x1 needs 3 devices; have 2."
        assert "needs a world of 3 processes" in values["errors"]["engine"]
        assert "torchrun" in values["errors"]["engine"]


def test_nccl_with_two_ranks_on_one_device_raises(worlds):
    results, _, _ = worlds
    for _, values in results[2]:
        assert "NCCL cannot run two ranks on one device" in values["nccl"]
        assert "backend='gloo'" in values["nccl"]


def test_a_mesh_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="initialize"):
        make_mesh(data=2)
    with pytest.raises(RuntimeError, match="initialize"):
        TD.rank_device()
    assert TD.is_coordinator() and TD.process_count() == 1


# --------------------------------------------------------------------------
# tensor-parallel rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_unshard_gives_back_the_model(worlds, world):
    results, _, _ = worlds
    for _, values in results[world]:
        r = values["roundtrip"]
        assert r["slices_match"] and r["roundtrip_equal"]
        assert len(r["sharded"]) == 10 * VIT_KW["num_keep_layers"]


def test_param_specs_match_jax_param_spec():
    """Every parameter splits over "model" along the dimension JAX's
    ``_param_spec`` names, except the q predictor's fc1 and fc2 (and, with
    adapters, the attention adapters' kernels), which JAX's path-substring
    rule also splits: GSPMD places any layout's collectives by itself, the
    port writes them out for the encoder's Megatron pairs only and keeps
    those replicated."""
    vit = dict(VIT_KW, num_adapters=1)
    jp = jinit(jax.random.PRNGKey(0), JVTAMIQConfig(vit=jget_vit_config(**vit), **HEAD_KW))
    jspecs = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]:
        spec = tuple(_param_spec(_path_str(path)))
        dim = spec.index(JMODEL_AXIS) if JMODEL_AXIS in spec else None
        jspecs[_path_str(path).replace("/", ".")] = dim
    specs = param_specs(VTAMIQ(VTAMIQConfig(vit=get_vit_config(**vit), **HEAD_KW)))
    assert sorted(specs) == sorted(jspecs)
    differ = {n for n in specs if specs[n] != jspecs[n]}
    assert differ == {"q_predictor.fc1.kernel", "q_predictor.fc1.bias",
                      "q_predictor.fc2.kernel"} | {
        f"vit.encoder.layers.layer_{i}.adapters.adapter_0.attn.{d}.kernel"
        for i in range(vit["num_keep_layers"]) for d in ("down", "up")}
    assert all(specs[n] is None for n in differ)
    assert sum(d is not None for d in specs.values()) == 10 * vit["num_keep_layers"]


def test_param_shardings_replicate_without_a_model_axis():
    module = VTAMIQ(VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW))
    assert set(param_shardings(module, _fake_mesh(2, 0)).values()) == {None}


@pytest.mark.parametrize("n,count", [(17, 4), (5, 1), (16, 2), (3, 4)])
def test_process_shard_matches_jax(n, count):
    idx = np.arange(n)
    parts = [TD.process_shard(idx, i, count) for i in range(count)]
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part, jprocess_shard(idx, i, count))
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)), idx)


# --------------------------------------------------------------------------
# the loader's per-process views
# --------------------------------------------------------------------------

def _tid(root, kind):
    if kind in ("fixed", "per_sample"):
        jds = make_tid(root, num_ref=3, num_dist=4)
        num_ref, num_dist, img_dim = 3, 4, D.TID2013Dataset.img_dim
    else:
        jds = make_multisize_tid(root, sizes=[(64, 96), (80, 64), (64, 96), (96, 96),
                                              (64, 96)], num_dist=3)
        num_ref, num_dist, img_dim = 5, 3, None

    class Tiny(D.TID2013Dataset):
        num_ref_images = num_ref
        num_dist_images = num_dist

    Tiny.img_dim = img_dim
    tds = Tiny(datasets_root=root)
    if kind == "per_sample":  # a decode-time hook: both loaders decode sample by sample
        def half(self, img):
            return img * 0.5
        jds = type("JHalf", (type(jds),), {"img_pretransform": half})(datasets_root=root)
        tds = type("THalf", (Tiny,), {"img_pretransform": half})(datasets_root=root)
    jds.add_split()
    tds.add_split()
    return jds, tds


@pytest.mark.parametrize("kind,kw", [
    ("fixed", dict(batch_size=2, shuffle=True, allow_img_flip=True, seed=3)),
    ("fixed", dict(batch_size=5, shuffle=False, num_repeats_data=2, seed=1)),
    ("buckets", dict(batch_size=2, shuffle=True, allow_img_flip=True, max_size_buckets=2,
                     seed=11)),
    ("per_sample", dict(batch_size=5, shuffle=True, allow_img_flip=True, seed=4)),
], ids=["fixed_flips", "fixed_partial_repeats", "buckets", "per_sample_flips"])
def test_loader_process_views_equal_jax(tmp_path, kind, kw):
    jds, tds = _tid(str(tmp_path), kind)
    seen = []
    for p in range(2):
        args = dict(patch_count=16, prefetch=0, process_index=p, process_count=2, **kw)
        jl, tl = JLoader(jds, "FullDataset", **args), PatchDatasetLoader(tds, "FullDataset",
                                                                          **args)
        assert len(tl) == len(jl)
        assert tl._use_native_batch_decode() == (kind != "per_sample")
        for _epoch in range(2):
            tb, jb = list(tl), list(jl)
            _assert_same_batches(tb, jb)
            assert [b.global_valid for b in tb] == [b.global_valid for b in jb]
            seen.extend(int(i) for b in tb for i in b.indices[:b.valid])
    n = len(tds.split_indices("FullDataset")) * kw.get("num_repeats_data", 1)
    assert len(seen) == 2 * n  # two epochs, every item once an epoch over the views


def test_loader_rejects_a_process_index_outside_the_count(tmp_path):
    _, tds = _tid(str(tmp_path), "fixed")
    with pytest.raises(ValueError, match="outside"):
        PatchDatasetLoader(tds, "FullDataset", batch_size=2, patch_count=4, process_index=2,
                           process_count=2)


# --------------------------------------------------------------------------
# the extraction's global-batch draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,scales,shuffle", [
    (PatchSampler(), 1, False),
    (PatchSampler(), 2, True),
    (PatchSampler(diff_weight=1.0, uniform_weight=0.1, grid_type=GRID_TYPE_PERTURBED,
                  diff_type=DIFF_TYPE_MAGNITUDE), 1, False),
], ids=["uniform", "uniform_two_scales_shuffled", "weighted"])
def test_batch_rows_get_the_single_process_patches(sampler, scales, shuffle):
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.uniform(0, 1, (6, 2, 64, 80, 3)).astype(np.float32))
    kw = dict(patch_count=24, patch_dim=16, patch_sampler=sampler, patch_num_scales=scales,
              randomize_patch_scale_order=shuffle, tile_norm=((0.5,) * 3, (0.5,) * 3,
                                                              torch.float32))
    whole = get_iqa_patches(imgs, torch.Generator().manual_seed(2), **kw)
    for first, rows in ((0, 2), (2, 2), (4, 2), (3, 3)):
        part = get_iqa_patches(imgs[first:first + rows], torch.Generator().manual_seed(2),
                               batch_rows=(first, 6), **kw)
        for got, want in zip(part, whole):
            if want is not None:
                assert torch.equal(got, want[first:first + rows])


def _fake_mesh(data, index):
    """A mesh object for the functions that read only its sizes, index and
    device (no process group)."""
    return Mesh({"data": data, "model": 1, "seq": 1}, {"data": index, "model": 0, "seq": 0},
                torch.device("cpu"), None, {})


def test_batch_helpers_split_rows_by_data_rank():
    x = torch.arange(8 * 3).reshape(8, 3)
    for index in range(2):
        mesh = _fake_mesh(2, index)
        rows, none = shard_batch((x, None), mesh)
        assert none is None and torch.equal(rows, x[4 * index:4 * index + 4])
        assert mesh.batch_rows(4) == (4 * index, 8)
        got, = TD.global_batch(mesh, (rows.numpy(),), 8)
        assert torch.equal(got, rows) and got.device.type == "cpu"
        assert TD.local_batch_size(8, mesh) == 4
    with pytest.raises(ValueError, match="rows"):
        TD.global_batch(_fake_mesh(2, 0), (x,), 8)
    with pytest.raises(ValueError, match="not divisible"):
        TD.local_batch_size(7, _fake_mesh(2, 0))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch((x[:7],), _fake_mesh(2, 0))


def test_tensor_parallel_refuses_what_it_cannot_split():
    """num_heads and mlp_dim must divide by the model ranks; an int8
    model is never tensor-parallel (JAX never combines the two)."""
    from vtamiq_tpu_torch.ops.quant import quantize_params_int8
    mesh = Mesh({"data": 1, "model": 3, "seq": 1}, {"data": 0, "model": 0, "seq": 0},
                torch.device("cpu"), None, {})
    module = VTAMIQ(VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW))
    with pytest.raises(ValueError, match="divide by model=3"):
        shard_params(module, mesh)
    mesh = Mesh({"data": 1, "model": 2, "seq": 1}, {"data": 0, "model": 0, "seq": 0},
                torch.device("cpu"), None, {})
    quantized = quantize_params_int8(init_vtamiq_params(
        VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW), torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="int8"):
        shard_params(quantized, mesh)
