"""Gradient gap between flash and quadratic attention in an fp32 training
gradient, in the JAX package and in the port, on the same inputs.

    JAX_PLATFORMS=cpu python3 tools/torch_grad_gap.py [--patches 2048]
        [--hidden 64] [--layers 2] [--heads 4] [--extra-tokens 2]
        [--image 96 128] [--smooth | --smoke-inputs] [--batch 2] [--seed 0]
    python3 tools/torch_grad_gap.py --device cuda --hidden 768 --layers 6
        --heads 12 --extra-tokens 8 --patches 5000 --image 384 512
        [--smooth | --smoke-inputs]

The gradient is the one ``chip_smoke.py``'s fp32 train check takes: the
MAE loss alone (weighted loss, weights (1, 0, 0)) against targets far above
every score, so d loss / d q is -1/B in every run, over pairs of two
unrelated images (uniform noise; with ``--smooth`` smooth synthetic
images; with ``--smoke-inputs`` the very pairs and patch draws of that
check); dropout off; the ViT narrowed by the options (MLP 4x the
width), the DiffNet head at its default size. The patches are drawn once,
by the port's uniform sampler.

On the CPU (``--device cpu``, the default) each package computes it with
its flash attention (JAX: its blockwise online-softmax reference; the port:
its kernels' plain versions) and with plain quadratic attention, from the
same weights (JAX's initialization, read into the port), and JAX's
quadratic path once more in float64 as the reference. Prints one JSON
line: each run's relative error ||g - g_float64|| / ||g_float64|| over the
whole gradient, the encoder's and the head's; each package's flash against
quadratic gap; and the gaps between the packages.

On a card (``--device cuda``; the card machine has no JAX) the port alone,
weights from a seeded generator, TF32 off: flash and quadratic, each run
twice; the gaps between the runs, between the CLS differences that the
head reads, and between the moves of an SGD step with learning rate 1 read
back from the fp32 parameters; between the moves of one train step of
``make_train_step_on_patches`` (SGD, learning rate 1), as
``chip_smoke.py``'s check takes them; the tensors with the largest flash
against quadratic gaps; and the head alone, fed the two runs' CLS
differences, and the quadratic one moved by noise of the same size.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config  # noqa: E402
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, init_vtamiq_params, vtamiq_forward  # noqa: E402
from vtamiq_tpu_torch.ops import attention as tattention  # noqa: E402
from vtamiq_tpu_torch.ops.extraction import get_iqa_patches  # noqa: E402
from vtamiq_tpu_torch.ops.losses import loss_func_iqa  # noqa: E402
from vtamiq_tpu_torch.ops.sampling import PatchSampler  # noqa: E402

FAR_TARGET = 10.0
LOSS_WEIGHTS = (1.0, 0.0, 0.0)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def gaps(got, ref):
    """Relative gaps of two {name: gradient} dicts (dotted names)."""
    names = sorted(ref)

    def part(g, keep):
        return np.concatenate([g[n].ravel() for n in names if keep(n)])

    def enc(n):
        return n.startswith("vit.")

    return {"whole": rel(part(got, lambda n: True), part(ref, lambda n: True)),
            "encoder": rel(part(got, enc), part(ref, enc)),
            "head": rel(part(got, lambda n: not enc(n)), part(ref, lambda n: not enc(n)))}


def worst_tensors(got, ref, k=5):
    """The ``k`` tensors with the largest gaps, with each one's share of
    the whole gradient's norm."""
    total = np.sqrt(sum(float((r ** 2).sum()) for r in ref.values()))
    per = sorted(((rel(got[n], ref[n]), n) for n in ref if np.linalg.norm(ref[n]) > 0),
                 reverse=True)[:k]
    return [{"tensor": n, "gap": g, "norm_share": float(np.linalg.norm(ref[n])) / total,
             "abs_gap_share": float(np.linalg.norm(got[n] - ref[n])) / total}
            for g, n in per]


def smooth_images(rng, n, h, w):
    """Smooth random images, sums of 6 random sinusoids plus fine noise
    (``chip_smoke.py``'s synthetic references), (n, h, w, 3) in [0, 1]."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    out = []
    for _ in range(n):
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(6):
            fy, fx, ph = rng.uniform(1, 12), rng.uniform(1, 12), rng.uniform(0, 2 * np.pi)
            img += (rng.uniform(0.05, 0.2, 3) *
                    np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)[..., None]).astype(np.float32)
        out.append(np.clip(img + 0.5 + rng.normal(0, 0.02, img.shape), 0, 1))
    return np.stack(out).astype(np.float32)


def smoke_inputs(batch):
    """The pairs of ``chip_smoke.py``'s fp32 train check: references of its
    synthetic pairs, two unrelated images a pair."""
    import faulthandler

    import chip_smoke
    faulthandler.cancel_dump_traceback_later()   # the script's watchdog
    refs, _ = chip_smoke.synthetic_pairs(2 * batch)
    return np.stack(refs).reshape((batch, 2) + refs[0].shape)


def sgd_deltas(module, grads):
    """{name: (p - g) - p} in fp32: what an SGD step with learning rate 1
    moves each parameter by, read back from the parameter."""
    out = {}
    for n, p in module.named_parameters():
        p = p.detach()
        out[n] = ((p - torch.from_numpy(grads[n]).to(p.device)) - p).cpu().numpy()
    return out


def port_grad(module, cfg, patches, pos, scales, attention_fn):
    """(loss, {name: gradient}) of the port's fp32 forward."""
    named = dict(module.named_parameters())
    q = vtamiq_forward(module, cfg, patches, pos, scales, compute_dtype=torch.float32,
                       attention_fn=attention_fn)
    b = q.shape[0]
    targets = torch.full((b,), FAR_TARGET, device=q.device)
    loss = loss_func_iqa(q, targets, *LOSS_WEIGHTS, weighted=True, valid=b)[0]
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), {
        n: np.zeros(tuple(p.shape), np.float32) if g is None else g.detach().cpu().numpy()
        for (n, p), g in zip(named.items(), grads)}


def cls_difference(module, cfg, patches, pos, attention_fn):
    """cls_ref - cls_dist, (B, H): what the head reads."""
    with torch.no_grad():
        tokens = module.vit(patches.flatten(0, 1), pos.flatten(0, 1),
                            compute_dtype=torch.float32, attention_fn=attention_fn)
    tokens = tokens.reshape(patches.shape[0], 2, -1, tokens.shape[-1])
    return (tokens[:, 0, cfg.token_num] - tokens[:, 1, cfg.token_num]).cpu().numpy()


def run_cpu(args, cfg, vit_kw, patches, pos, scales):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from vtamiq_tpu.models.checkpoint import _flatten
    from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
    from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
    from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
    from vtamiq_tpu.models.vtamiq import vtamiq_forward as jforward
    from vtamiq_tpu.ops import attention as jattention
    from vtamiq_tpu.ops.losses import loss_func_iqa as jloss
    from vtamiq_tpu_torch.models.checkpoint import params_from_jax

    jcfg = JVTAMIQConfig(vit=jget_vit_config(**vit_kw))
    jp = jinit(jax.random.PRNGKey(args.seed), jcfg)
    module = VTAMIQ(cfg)
    module.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    b = args.batch

    def jax_grad(attention_fn, dtype=jnp.float32):
        params = jax.tree_util.tree_map(lambda x: x.astype(dtype), jp)

        def loss_fn(p):
            q = jforward(p, jcfg, jnp.asarray(patches.numpy(), dtype),
                         jnp.asarray(pos.numpy(), dtype), None, compute_dtype=dtype,
                         attention_fn=attention_fn)
            return jloss(q, jnp.full((b,), FAR_TARGET, dtype), *LOSS_WEIGHTS, weighted=True,
                         valid=b)[0]

        grads = jax.grad(loss_fn)(params)
        return {k.replace("|", "."): np.asarray(v, np.float64)
                for k, v in _flatten(grads).items()}

    runs = {"jax_flash": jax_grad(jattention.make_attention_fn()),
            "jax_quadratic": jax_grad(None),
            "port_flash": port_grad(module, cfg, patches, pos, scales,
                                    tattention.make_attention_fn())[1],
            "port_quadratic": port_grad(module, cfg, patches, pos, scales, None)[1]}
    jax.config.update("jax_enable_x64", True)
    try:
        reference = jax_grad(None, jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return {"error_vs_jax_float64": {k: gaps(g, reference) for k, g in runs.items()},
            "flash_vs_quadratic": {
                "jax": gaps(runs["jax_flash"], runs["jax_quadratic"]),
                "port": gaps(runs["port_flash"], runs["port_quadratic"])},
            "port_vs_jax": {m: gaps(runs[f"port_{m}"], runs[f"jax_{m}"])
                            for m in ("flash", "quadratic")}}


def train_step_deltas(module, cfg, patches, pos, scales, attention_fn):
    """{name: move} of one step of make_train_step_on_patches with SGD at
    learning rate 1, no clipping, on a copy of ``module`` (the step
    ``chip_smoke.py``'s fp32 check takes)."""
    from vtamiq_tpu_torch.train.optim import Optimizer, build_freeze_mask
    from vtamiq_tpu_torch.train.steps import make_train_step_on_patches

    model = copy.deepcopy(module)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sgd = Optimizer("SGD", lambda count: torch.tensor(1.0), max_norm=float("inf"))
    step = make_train_step_on_patches(cfg, sgd, weighted_loss=True, compute_dtype=torch.float32,
                                      attention_fn=attention_fn)
    b = patches.shape[0]
    step(model, sgd.init(before), build_freeze_mask(model, False), patches, pos, scales,
         torch.full((b,), FAR_TARGET, device=patches.device), b, LOSS_WEIGHTS)
    return {n: (p.detach() - before[n]).cpu().numpy() for n, p in model.named_parameters()}


def head_grad(module, cfg, cls):
    """{name: gradient} of the head's parameters (DiffNet and the q
    predictor) for the MAE loss, the head fed the CLS difference ``cls``."""
    from vtamiq_tpu_torch.models.vtamiq import q_predictor, quality_decoder

    x = torch.from_numpy(cls).to(next(module.parameters()).device)
    if cfg.diff_scale:
        x = x * module.diff_scale
    if cfg.calibrate:
        x = quality_decoder(module.quality_decoder, x)
    q = q_predictor(module.q_predictor, x).reshape(-1)
    b = q.shape[0]
    loss = loss_func_iqa(q, torch.full((b,), FAR_TARGET, device=q.device), *LOSS_WEIGHTS,
                         weighted=True, valid=b)[0]
    named = {n: p for n, p in module.named_parameters() if not n.startswith("vit.")}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {n: np.zeros(tuple(p.shape), np.float32) if g is None else g.cpu().numpy()
            for (n, p), g in zip(named.items(), grads)}


def head_alone(module, cfg, cls, seed):
    """The head's gradient gap for the flash run's CLS difference against
    the quadratic run's, and for the quadratic run's against itself moved
    by random relative noise of the same size: a head that is smooth there
    gives gaps about as small as its inputs'."""
    def gap(got, want):
        names = sorted(want)
        return rel(np.concatenate([got[n].ravel() for n in names]),
                   np.concatenate([want[n].ravel() for n in names]))

    ref = head_grad(module, cfg, cls["quadratic"])
    size = rel(cls["flash"], cls["quadratic"])
    noise = np.random.default_rng(seed).standard_normal(cls["quadratic"].shape)
    moved = cls["quadratic"] * (1 + size * noise).astype(np.float32)
    return {"input_gap": size,
            "flash_input": gap(head_grad(module, cfg, cls["flash"]), ref),
            "noise_input": gap(head_grad(module, cfg, moved), ref),
            "noise_input_gap": rel(moved, cls["quadratic"])}


def run_card(args, cfg, patches, pos, scales):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module = init_vtamiq_params(cfg, torch.Generator().manual_seed(args.seed)).cuda()
    patches, pos = patches.cuda(), pos.cuda()
    fns = {"flash": tattention.make_attention_fn(), "quadratic": None}
    runs = {f"{name}_{i}": port_grad(module, cfg, patches, pos, scales, fn)
            for name, fn in fns.items() for i in range(2)}
    g = {k: r[1] for k, r in runs.items()}
    cls = {name: cls_difference(module, cfg, patches, pos, fn) for name, fn in fns.items()}
    return {"device": torch.cuda.get_device_name(0), "tf32": False,
            "flash_vs_quadratic": gaps(g["flash_0"], g["quadratic_0"]),
            "run_to_run": {"flash": gaps(g["flash_1"], g["flash_0"]),
                           "quadratic": gaps(g["quadratic_1"], g["quadratic_0"])},
            "cls_difference_flash_vs_quadratic": rel(cls["flash"], cls["quadratic"]),
            "sgd_step_delta_flash_vs_quadratic": gaps(sgd_deltas(module, g["flash_0"]),
                                                      sgd_deltas(module, g["quadratic_0"])),
            "worst_tensors_flash_vs_quadratic": worst_tensors(g["flash_0"], g["quadratic_0"]),
            "head_alone": head_alone(module, cfg, cls, args.seed),
            "train_step_delta_flash_vs_quadratic": gaps(
                train_step_deltas(module, cfg, patches, pos, scales, fns["flash"]),
                train_step_deltas(module, cfg, patches, pos, scales, None)),
            "loss": {k: r[0] for k, r in runs.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--patches", type=int, default=2048)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--extra-tokens", type=int, default=2)
    ap.add_argument("--image", type=int, nargs=2, default=(96, 128), metavar=("H", "W"))
    ap.add_argument("--smooth", action="store_true",
                    help="smooth synthetic images in place of uniform noise")
    ap.add_argument("--smoke-inputs", action="store_true",
                    help="chip_smoke.py's fp32 check pairs and patch seed (384x512)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda needs a CUDA device")

    vit_kw = dict(num_keep_layers=args.layers, num_extra_tokens=args.extra_tokens,
                  hidden_size=args.hidden,
                  mlp_dim=4 * args.hidden, num_heads=args.heads)
    cfg = VTAMIQConfig(vit=get_vit_config(**vit_kw))   # the default DiffNet head
    rng = np.random.default_rng(args.seed)
    if args.smoke_inputs:
        imgs = smoke_inputs(args.batch)
    elif args.smooth:
        imgs = smooth_images(rng, 2 * args.batch, *args.image).reshape(
            (args.batch, 2) + tuple(args.image) + (3,))
    else:
        imgs = rng.uniform(0, 1, (args.batch, 2, *args.image, 3)).astype(np.float32)
    args.image = list(imgs.shape[2:4])
    patches, pos, scales = get_iqa_patches(
        torch.from_numpy(imgs), torch.Generator().manual_seed(args.seed + args.smoke_inputs),
        args.patches, 16, PatchSampler(), tile_norm=((0.5,) * 3, (0.5,) * 3, torch.float32))
    out = {"config": {**vars(args), "dtype": "float32",
                      "loss": "MAE vs far target"}}
    if args.device == "cpu":
        out.update(run_cpu(args, cfg, vit_kw, patches, pos, scales))
    else:
        out.update(run_card(args, cfg, patches, pos, scales))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
