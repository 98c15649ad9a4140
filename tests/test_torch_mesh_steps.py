"""The port's mesh train and eval steps in worlds of 2 and 4 CPU processes
over gloo, against the JAX package's ``make_train_step`` /
``make_eval_step`` on the matching ``make_mesh`` of the conftest's virtual
devices, and against the port's own single-process steps.

Data (2), tensor (2), data x tensor (2 x 2) and sequence (2) parallel, fp32,
on the patches JAX's extraction draws (each rank gets its rows), with the
SGD settings and tolerances of ``tests/test_torch_train_step.py``: a step's
loss, grad_norm, q of every item and every updated parameter. The steps
with DropPath and dropout active, and the step that draws its own patches
from raw images, hold the mesh against the port's single-process step from
the same generator states (JAX's draws cannot be matched). Each world is
spawned once per file (``tests/torch_mesh_worker.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_train_step import FREEZE, GCONF, HEAD_KW, JCFG, LW, RTOL, ATOL, VIT_KW
from torch_mesh_worker import spawn_world
from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.ops import PatchSampler as JPatchSampler
from vtamiq_tpu.parallel.mesh import make_mesh as jmake_mesh
from vtamiq_tpu.parallel.mesh import shard_batch as jshard_batch
from vtamiq_tpu.parallel.mesh import shard_params as jshard_params
from vtamiq_tpu.train import optim as joptim
from vtamiq_tpu.train import steps as jsteps
from vtamiq_tpu_torch.ops import sampling as ts

B, IMG_H, IMG_W, PATCHES = 4, 64, 96, 500
VALID = B - 1  # the batch carries one padded item
# name -> (world, (data, model, seq), step kind)
MESH_CASES = {
    "dp_train": (2, (2, 1, 1), "train"),
    "tp_train": (2, (1, 2, 1), "train"),
    "tp_eval": (2, (1, 2, 1), "eval"),
    "seq_train": (2, (1, 1, 2), "train"),
    "seq_eval": (2, (1, 1, 2), "eval"),
    "dp_tp_train": (4, (2, 2, 1), "train"),
}
# port mesh vs port single process, with draws: name -> (world, mesh, step kind)
PORT_CASES = {
    "dp_dropout": (2, (2, 1, 1), "train"),
    "tp_seq_dropout": (4, (1, 2, 2), "train"),
    "dp_raw_weighted": (2, (2, 1, 1), "raw"),
}
DROP_HEAD = dict(HEAD_KW, rg_path_drop=0.3, predictor_dropout=0.3)
DROP_VIT = dict(VIT_KW, path_drop_prob=0.3, vit_path_drop_active=True)
WEIGHTED = dict(diff_weight=1.0, uniform_weight=0.1, grid_type=ts.GRID_TYPE_PERTURBED,
                diff_type=ts.DIFF_TYPE_MAGNITUDE)


def _batch():
    rng = np.random.default_rng(21)
    raw = rng.uniform(0, 1, (B, 2, IMG_H, IMG_W, 3)).astype(np.float32)
    return raw, rng.uniform(0, 1, B).astype(np.float32)


def _jax_case(mesh_shape, kind, jp, raw, qs, key):
    """JAX's mesh step on the global batch: (metrics, q, updated params)."""
    mesh = jmake_mesh(*mesh_shape)
    ecfg = jsteps.ExtractConfig(patch_count=PATCHES, gather_dtype="float32")
    hw = jnp.tile(jnp.asarray([IMG_H, IMG_W], jnp.int32)[None], (B, 1))
    sraw, sqs, shw = jshard_batch((jnp.asarray(raw), jnp.asarray(qs), hw), mesh)
    sp = jshard_params(jp, mesh)
    if kind == "eval":
        step = jsteps.make_eval_step(JCFG, JPatchSampler(), ecfg, compute_dtype=jnp.float32,
                                     mesh=mesh)(jp)
        metrics, q = step(sp, sraw, sqs, jnp.asarray(VALID), key, jnp.asarray(LW), shw)
        return metrics, q, None
    jopt, _ = joptim.make_optimizer(GCONF, 4)
    jmask = joptim.build_freeze_mask(jp, True, FREEZE)
    jstate = jopt.init(jp)
    step = jsteps.make_train_step(JCFG, JPatchSampler(), ecfg, jopt, compute_dtype=jnp.float32,
                                  mesh=mesh)(jp, jstate, jmask)
    new_p, _, metrics, q = step(sp, jstate, jmask, sraw, sqs, jnp.asarray(VALID), key,
                                jnp.asarray(LW), shw)
    return metrics, q, _flatten(new_p)


def _spec(name, mesh_shape, kind, vit=VIT_KW, head=HEAD_KW, **extra):
    return {"kind": "steps", "name": name, "mesh": list(mesh_shape), "step": kind,
            "params": "params", "vit": vit, "head": head, "gconf": GCONF, "freeze": FREEZE,
            "patch_count": PATCHES, "n_steps": 1, "valid": [VALID], **extra}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_steps")
    raw, qs = _batch()
    key = jax.random.PRNGKey(31)
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    patches, pos, scales = jax.jit(jsteps.make_extract_fn(
        JPatchSampler(), jsteps.ExtractConfig(patch_count=PATCHES, gather_dtype="float32"))
    )(jnp.asarray(raw), jax.random.split(key)[0])
    inputs = {f"params/{k}": np.asarray(v) for k, v in _flatten(jp).items()}
    for name, (_, _, kind) in {**MESH_CASES, **PORT_CASES}.items():
        if kind == "raw":
            inputs[f"{name}/0/raw"] = raw
        else:
            # the train step draws its patches with the first half of the
            # key; the eval step with the whole key
            ekey = key if kind == "eval" else jax.random.split(key)[0]
            p, u, s = (patches, pos, scales) if kind == "train" else jax.jit(
                jsteps.make_extract_fn(JPatchSampler(), jsteps.ExtractConfig(
                    patch_count=PATCHES, gather_dtype="float32")))(jnp.asarray(raw), ekey)
            inputs[f"{name}/0/patches"] = np.asarray(p)
            inputs[f"{name}/0/pos"] = np.asarray(u)
            if s is not None:
                inputs[f"{name}/0/scales"] = np.asarray(s)
        inputs[f"{name}/0/qs"] = qs
    started = {}
    for world in (2, 4):
        cases = [_spec(n, m, k) for n, (w, m, k) in MESH_CASES.items() if w == world]
        for n, (w, m, k) in PORT_CASES.items():
            if w != world:
                continue
            if k == "raw":
                cases.append(_spec(n, m, k, generator_seed=4, sample_seed=9,
                                   sampler=WEIGHTED, ecfg={"randomize_patch_scale_order": True,
                                                           "patch_num_scales": 2}))
            else:
                cases.append(_spec(n, m, k, vit=DROP_VIT, head=DROP_HEAD, generator_seed=4))
        started[world] = spawn_world(world, cases, inputs, str(root / f"w{world}"))
    refs = {name: _jax_case(mesh, kind, jp, raw, qs, key)
            for name, (_, mesh, kind) in MESH_CASES.items()}
    return {world: w.results() for world, w in started.items()}, refs


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _check_ranks_agree(res, name):
    """Every rank holds the global batch's q and the same metrics."""
    for arrays, _ in res[1:]:
        for k, v in res[0][0].items():
            if k.startswith(f"{name}/0/"):
                np.testing.assert_array_equal(arrays[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_step_matches_jax_mesh_step(worlds, name):
    results, refs = worlds
    world, mesh_shape, kind = MESH_CASES[name]
    res = results[world]
    _check_ranks_agree(res, name)
    arrays = res[0][0]
    jmetrics, jq, jparams = refs[name]
    _close(arrays[f"{name}/0/q"], np.asarray(jq), "q")
    keys = ("loss", "mae", "rank", "pears") + (("grad_norm",) if kind == "train" else ())
    for key in keys:
        _close(arrays[f"{name}/0/{key}"], np.asarray(jmetrics[key]), key)
        # and the port's single-process step on the whole batch
        _close(arrays[f"{name}/0/{key}"], arrays[f"{name}/single/0/{key}"], "single " + key)
    _close(arrays[f"{name}/0/q"], arrays[f"{name}/single/0/q"], "single q")
    if jparams is not None:
        for path, want in jparams.items():
            got = arrays[f"{name}/param/{path.replace('|', '.')}"]
            _close(got, np.asarray(want), path)


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_mesh_step_with_draws_matches_single_process(worlds, name):
    """DropPath, dropout and the patch draws are made for the global batch:
    the mesh step equals the single-process step from the same generators."""
    results, _ = worlds
    res = results[PORT_CASES[name][0]]
    _check_ranks_agree(res, name)
    arrays = res[0][0]
    single = {k[len(f"{name}/single/"):]: v for k, v in arrays.items()
              if k.startswith(f"{name}/single/")}
    assert single
    for k, want in single.items():
        _close(arrays[f"{name}/{k}"], want, k)
