"""One rank of a multi-process world for the port's mesh tests.

    python tests/torch_mesh_worker.py <rank> <world> <job dir>
    torchrun --standalone --nproc-per-node N tests/torch_mesh_worker.py \
        --multihost-train <spec.json>

The job dir holds ``cases.json`` (the cases every rank runs, in order) and
``inputs.npz``; the ranks meet over gloo through a ``file://`` store in the
job dir (no ports, so parallel test workers cannot collide), run on the CPU
unless a case says otherwise, one thread each, and each writes
``out_<rank>.npz`` (arrays, keyed ``<case name>/<key>``) and
``out_<rank>.json`` (numbers and error texts). Imports only torch, numpy
and the port; ``spawn_world`` starts a world from a test.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from vtamiq_tpu_torch.models.checkpoint import params_from_jax  # noqa: E402
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config  # noqa: E402
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, init_vtamiq_params  # noqa: E402
from vtamiq_tpu_torch.ops import flash_kernel  # noqa: E402
from vtamiq_tpu_torch.ops.attention import flash_attention  # noqa: E402
from vtamiq_tpu_torch.ops.sampling import PatchSampler  # noqa: E402
from vtamiq_tpu_torch.parallel import distributed as D  # noqa: E402
from vtamiq_tpu_torch.parallel.mesh import (make_mesh, param_specs, shard_batch,  # noqa: E402
                                            shard_params, unshard_params)
from vtamiq_tpu_torch.parallel.ring_attention import make_ring_attention, shard_seq  # noqa: E402
from vtamiq_tpu_torch.train import optim, steps  # noqa: E402

LW = (0.75, 1.0, 0.2)


# --------------------------------------------------------------------------
# the parent's side
# --------------------------------------------------------------------------

class World:
    """Processes of one world; ``results()`` waits for them and returns
    each rank's (arrays, values)."""

    def __init__(self, procs, job_dir):
        self.procs, self.job_dir = procs, job_dir

    def results(self, timeout: float = 300):
        logs = []
        for p in self.procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise
            logs.append(out)
        if any(p.returncode != 0 for p in self.procs):
            raise AssertionError("a rank failed:\n" + "\n---\n".join(logs))
        out = []
        for r in range(len(self.procs)):
            with np.load(os.path.join(self.job_dir, f"out_{r}.npz")) as npz:
                arrays = {k: npz[k] for k in npz.files}
            with open(os.path.join(self.job_dir, f"out_{r}.json")) as f:
                out.append((arrays, json.load(f)))
        return out


def spawn_world(world: int, cases, inputs, job_dir: str) -> World:
    """Start ``world`` ranks on ``cases`` with ``inputs`` (a dict of
    arrays); returns at once."""
    os.makedirs(job_dir, exist_ok=True)
    np.savez(os.path.join(job_dir, "inputs.npz"), **inputs)
    with open(os.path.join(job_dir, "cases.json"), "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               job_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return World(procs, job_dir)


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------

def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().float().cpu().numpy()


def case_ring(spec, inputs, arrays, values):
    """The ring over this rank's rows and tokens: out, dq, dk, dv."""
    name, source = spec["name"], spec["inputs"]
    mesh = make_mesh(data=spec["data"], model=1, seq=spec["seq"])
    mask = inputs.get(f"{source}/mask")

    def local(x):
        return shard_seq(shard_batch((_t(x),), mesh)[0], mesh)

    q, k, v = (local(inputs[f"{source}/{n}"]).requires_grad_() for n in "qkv")
    out = make_ring_attention(mesh, fused_bwd=spec["fused"])(
        q, k, v, None if mask is None else local(mask))
    out.backward(local(inputs[f"{source}/g"]))
    for key, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        arrays[f"{name}/{key}"] = _np(t)
    values[name] = {"coords": mesh.coords, "finite": bool(torch.isfinite(out).all())}


def case_ring_indivisible(spec, inputs, arrays, values):
    mesh = make_mesh(data=1, model=1, seq=spec["seq"])
    try:
        shard_seq(torch.zeros(1, spec["tokens"], 1, 1), mesh)
        values[spec["name"]] = None
    except ValueError as e:
        values[spec["name"]] = str(e)


def case_ring_vs_flash(spec, inputs, arrays, values):
    """The ring on ``spec["device"]`` against ``ops/attention.py::
    flash_attention`` over the whole sequence on the same device: relative
    errors of out, dq, dk, dv and the flash launches of one ring call."""
    device = torch.device(spec["device"])
    dtype = getattr(torch, spec["dtype"])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, model=1, seq=spec["seq"], device=device)
    g = torch.Generator().manual_seed(spec["seed"])
    b, s, h, d = spec["shape"]
    q, k, v, go = (torch.randn(b, s, h, d, generator=g).to(device, dtype) for _ in range(4))
    mask = torch.arange(s) < spec["valid"]
    mask = mask[None].expand(b, s).contiguous().to(device)
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention(*full, mask)
    ref.backward(go)
    loc = [shard_seq(t, mesh).clone().requires_grad_() for t in (q, k, v)]
    flash_kernel.reset_launches()
    out = make_ring_attention(mesh)(*loc, shard_seq(mask, mesh))
    out.backward(shard_seq(go, mesh))
    launches = dict(flash_kernel.launches)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))

    errs = {"out": rel(out, shard_seq(ref, mesh))}
    for key, a, f in zip(("dq", "dk", "dv"), loc, full):
        errs[key] = rel(a.grad, shard_seq(f.grad, mesh))
    values[spec["name"]] = {"errors": errs, "launches": launches,
                            "finite": bool(torch.isfinite(out).all())}


def _model(spec, inputs):
    cfg = VTAMIQConfig(vit=get_vit_config(**spec["vit"]), **spec["head"])
    module = VTAMIQ(cfg)
    prefix = f"{spec['params']}/"
    module.load_state_dict(params_from_jax(
        {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}), strict=True)
    return cfg, module


def _run_steps(spec, inputs, cfg, module, mesh, generator_seed):
    """The spec's steps on ``module`` (its TP shard under a mesh): metrics
    and q of each step, then the full updated parameters."""
    name, kind = spec["name"], spec["step"]
    patch_count = spec["patch_count"]
    attention_fn = steps._mesh_attention_fn(mesh, patch_count)
    out = {}
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    if kind == "train":
        opt, _ = optim.make_optimizer(spec["gconf"], 4)
        state = opt.init({n: p.detach() for n, p in module.named_parameters()})
        mask = optim.build_freeze_mask(module, True, spec["freeze"])
        step = steps.make_train_step_on_patches(cfg, opt, compute_dtype=torch.float32,
                                                attention_fn=attention_fn, mesh=mesh)
    elif kind == "eval":
        step = steps.make_eval_step_on_patches(cfg, compute_dtype=torch.float32,
                                               attention_fn=attention_fn, mesh=mesh)
    else:  # "raw": make_train_step on raw images, patches drawn by the port
        opt, _ = optim.make_optimizer(spec["gconf"], 4)
        state = opt.init({n: p.detach() for n, p in module.named_parameters()})
        mask = optim.build_freeze_mask(module, False)
        sampler = PatchSampler(**spec.get("sampler", {}))
        ecfg = steps.ExtractConfig(patch_count=patch_count, gather_dtype="float32",
                                   **spec.get("ecfg", {}))
        step = steps.make_train_step(cfg, sampler, ecfg, opt, compute_dtype=torch.float32,
                                     mesh=mesh)
        sample_gen = torch.Generator().manual_seed(spec["sample_seed"])
    for i in range(spec["n_steps"]):
        keys = ("raw", "qs") if kind == "raw" else ("patches", "pos", "scales", "qs")
        batch = [_t(inputs.get(f"{name}/{i}/{k}")) for k in keys]
        if mesh is not None:
            batch = list(shard_batch(batch, mesh))
        valid = spec["valid"][i]
        if kind == "train":
            metrics, q = step(module, state, mask, *batch, valid, LW, gen)
        elif kind == "eval":
            metrics, q = step(module, *batch, valid, LW)
        else:
            metrics, q = step(module, state, mask, *batch, valid, LW, sample_gen, gen)
        out[f"{i}/q"] = _np(q)
        for key, val in metrics.items():
            out[f"{i}/{key}"] = np.asarray(float(val))
    full = unshard_params(module, mesh) if mesh is not None else \
        {n: p.detach() for n, p in module.named_parameters()}
    out.update({f"param/{n}": _np(t) for n, t in full.items()})
    return out


def case_steps(spec, inputs, arrays, values):
    """Mesh steps on each rank's rows; rank 0 also runs the single-process
    steps on the whole batch (``single/...``)."""
    name = spec["name"]
    mesh = make_mesh(*spec["mesh"])
    cfg, module = _model(spec, inputs)
    single = copy.deepcopy(module)
    shard_params(module, mesh)
    seed = spec.get("generator_seed")
    for k, v in _run_steps(spec, inputs, cfg, module, mesh, seed).items():
        arrays[f"{name}/{k}"] = v
    if torch.distributed.get_rank() == 0:
        for k, v in _run_steps(spec, inputs, cfg, single, None, seed).items():
            arrays[f"{name}/single/{k}"] = v
    values[name] = {"coords": mesh.coords}


def case_shard_roundtrip(spec, inputs, arrays, values):
    """A full model cut to this rank's TP shard and gathered back."""
    mesh = make_mesh(data=-1, model=spec["model"])
    cfg = VTAMIQConfig(vit=get_vit_config(**spec["vit"]), **spec["head"])
    module = init_vtamiq_params(cfg, torch.Generator().manual_seed(3))
    full = {n: p.detach().clone() for n, p in module.named_parameters()}
    specs = param_specs(module)
    shard_params(module, mesh)
    m, i = mesh.size("model"), mesh.index("model")
    sliced = all(torch.equal(p, full[n] if specs[n] is None else
                             full[n].chunk(m, dim=specs[n])[i])
                 for n, p in module.named_parameters())
    back = unshard_params(module, mesh)
    values[spec["name"]] = {
        "slices_match": sliced,
        "roundtrip_equal": sorted(back) == sorted(full)
        and all(torch.equal(back[n], full[n]) for n in full),
        "sharded": sorted(n for n, d in specs.items() if d is not None)}


def case_mesh_errors(spec, inputs, arrays, values):
    """Errors a mesh of the wrong size raises: make_mesh and engine.train()."""
    from vtamiq_tpu_torch.train import config as C, engine
    out = {}
    try:
        make_mesh(data=spec["data"])
        out["make_mesh"] = None
    except ValueError as e:
        out["make_mesh"] = str(e)
    C.global_config.update(mesh_data=spec["data"], device="cpu", config_validated=False)
    try:
        engine.train()
        out["engine"] = None
    except ValueError as e:
        out["engine"] = str(e)
    values[spec["name"]] = out


def case_engine(spec, inputs, arrays, values):
    """engine.train() on a tiny TID2013 tree at the spec's settings, then a
    run resumed from rank 0's latest.npz for one more epoch. With
    ``rank_dirs`` each rank's output root is its own subdirectory."""
    from vtamiq_tpu_torch.data.datasets import TID2013Dataset
    from vtamiq_tpu_torch.train import config as C, engine
    num_ref, num_dist, root = spec["num_ref"], spec["num_dist"], spec["root"]
    rank = torch.distributed.get_rank()

    class TinyTID(TID2013Dataset):
        num_ref_images = num_ref
        num_dist_images = num_dist

        def __init__(self, **kwargs):
            kwargs.setdefault("datasets_root", root)
            super().__init__(**kwargs)

    C._DATASET_REGISTRY[C.DATASET_TID2013] = (TinyTID, C.setup_split_config(*spec["splits"]))
    out = spec["global"]["output_dir"]
    if spec["rank_dirs"]:
        out = os.path.join(out, f"rank{rank}")
    C.global_config.update(spec["global"], dataset=C.DATASET_TID2013, device="cpu",
                           output_dir=out, config_validated=False, resume_checkpoint_file=None)
    C.vit_config.update(spec["vit"])
    C.vtamiq_config.update(spec["head"])
    C.freeze_config.update(spec["freeze"])
    C.dataloader_config_base[C.DATALOADER_PARAMS][C.USE_DEFAULT_PARAMS] = True
    for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
        C.dataloader_config_base[split][C.BATCH_SIZE] = spec["batch"]
        C.dataloader_config_base[split][C.PATCH_COUNT] = spec["patches"]

    def run():
        cors = engine.train()
        out_dir = C.global_config["output_dir_final"]
        return {"correlations": {k: float(v) for k, v in cors.items()},
                "output_dir_final": out_dir,
                "files": sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else [],
                "train_stats": engine.last_run_stats["train"]}

    runs = [run()]
    latest = [os.path.join(runs[0]["output_dir_final"], "latest.npz")]
    torch.distributed.broadcast_object_list(latest, src=0)
    C.global_config.update(num_epochs=spec["global"]["num_epochs"] + 1,
                           resume_checkpoint_file=latest[0], config_validated=False)
    runs.append(run())
    values[spec["name"]] = {"runs": runs}


def case_nccl_same_device(spec, store, rank, world, values):
    """NCCL asked for two ranks on one device: initialize raises."""
    try:
        D.initialize(f"file://{store}", world, rank, local_device="cuda:0", backend="nccl")
        values[spec["name"]] = None
    except ValueError as e:
        values[spec["name"]] = str(e)


CASES = {"ring": case_ring, "ring_indivisible": case_ring_indivisible,
         "ring_vs_flash": case_ring_vs_flash, "steps": case_steps,
         "shard_roundtrip": case_shard_roundtrip, "mesh_errors": case_mesh_errors,
         "engine": case_engine}


def multihost_train_rank(spec_path):
    """A rank of ``train/multihost_train.py`` under torchrun, on the tiny
    tree and model of the spec (its config set before ``main`` runs)."""
    from vtamiq_tpu_torch.data.datasets import TID2013Dataset
    from vtamiq_tpu_torch.train import config as C, multihost_train
    with open(spec_path) as f:
        spec = json.load(f)
    num_ref, num_dist, root = spec["num_ref"], spec["num_dist"], spec["root"]

    class TinyTID(TID2013Dataset):
        num_ref_images = num_ref
        num_dist_images = num_dist

        def __init__(self, **kwargs):
            kwargs.setdefault("datasets_root", root)
            super().__init__(**kwargs)

    C._DATASET_REGISTRY[C.DATASET_TID2013] = (TinyTID, C.setup_split_config(*spec["splits"]))
    C.vit_config.update(spec["vit"])
    C.vtamiq_config.update(spec["head"])
    C.freeze_config.update(spec["freeze"])
    C.global_config.update(output_dir=spec["output_dir"], compute_dtype="float32")
    for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
        C.dataloader_config_base[split][C.PATCH_COUNT] = spec["patches"]
    cors = multihost_train.main(spec["argv"])
    rank = int(os.environ["RANK"])
    with open(f"{spec_path}.rank{rank}.json", "w") as f:
        json.dump({k: float(v) for k, v in cors.items()}, f)


def main():
    if sys.argv[1] == "--multihost-train":
        torch.set_num_threads(1)
        multihost_train_rank(sys.argv[2])
        return
    rank, world, job_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(job_dir, "cases.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(job_dir, "inputs.npz")) as npz:
        inputs = {k: npz[k] for k in npz.files}
    arrays, values = {}, {}
    for spec in cases:
        if spec["kind"] == "nccl_same_device":
            case_nccl_same_device(spec, os.path.join(job_dir, "store_nccl"), rank, world,
                                  values)
    D.initialize(f"file://{os.path.join(job_dir, 'store')}", world, rank,
                 local_device=cases[0].get("device", "cpu") if cases else "cpu",
                 backend="gloo")
    try:
        for spec in cases:
            if spec["kind"] != "nccl_same_device":
                CASES[spec["kind"]](spec, inputs, arrays, values)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        np.savez(os.path.join(job_dir, f"out_{rank}.npz"), **arrays)
        with open(os.path.join(job_dir, f"out_{rank}.json"), "w") as f:
            json.dump(values, f)
        D.shutdown()


if __name__ == "__main__":
    main()
