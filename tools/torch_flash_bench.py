"""Time the flash-attention kernels of vtamiq_tpu_torch on a CUDA card at
the 5000-patch shapes, beside PyTorch's scaled_dot_product_attention.

    python3 tools/torch_flash_bench.py [--root DIR] [--dtype bfloat16|float32]
                                       [--rows 16] [--reps 10] [--profile]

``--root`` imports ``vtamiq_tpu_torch`` from another checkout, such as a
parent commit unpacked with ``git archive`` into ``.ab_parent/`` (which
``.gitignore`` lists), so two versions can be timed in one run on one card.
Prints JSON lines:

- build: the kernels' build time and nvcc's ``-Xptxas -v`` lines;
- time: medians of CUDA-event timed launches of flash_forward,
  flash_backward_fused and the split backward's flash_backward_dq and
  flash_backward_dkv at q, k, v (``--rows``, 12, 5056, 64) in ``--dtype``
  (TF32 off for float32), 5009 valid keys, beside scaled_dot_product_attention's
  forward and backward on the same tensors (the yardstick; the port never
  calls it), with the card's name and power limit;
- profile (with ``--profile``): torch.profiler's device time per kernel
  over 3 forward and 3 fused-backward calls, per call (the fused backward
  is two kernels).

Correctness is checked by chip_smoke.py and tests/test_torch_kernels_gpu.py.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HEADS, S_VALID, HEAD_DIM = 12, 5009, 64
S_PAD = -(-S_VALID // 64) * 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, warmup=3, reps=10):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sdpa_backend(dtype):
    """fp32 attention in SDPA's memory-efficient kernel: its math fallback
    would hold the (16, 12, 5056, 5056) fp32 probabilities, 19.6 GB."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])


def inputs(fk, dtype, rows, seed=0):
    """(B, H, S, D) views of (B, S, H, D) tensors, as the model builds
    them, keys past the 5009 valid ones masked; the backward's do, lse and
    delta from the plain forward."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.zeros(rows, S_PAD, dtype=torch.bool, device="cuda")
    mask[:, :S_VALID] = True
    q, k, v, do = (torch.randn(rows, S_PAD, HEADS, HEAD_DIM, generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for _ in range(4))
    out, lse = fk.flash_forward_plain(q, k, v, mask)
    return q, k, v, do, mask, lse, fk.delta_of(do, out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--rows", type=int, default=16,
                    help="encoder rows (two per pair): 16 in training at batch 8, 4 in "
                    "the scorer's fp32 check")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bench: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from vtamiq_tpu_torch import _build
    from vtamiq_tpu_torch.ops import flash_kernel as fk

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    _build.load_library()
    info = _build.build_info()
    emit({"build_s": info.seconds, "root": args.root, "card": card,
          "ptxas": [ln.strip() for ln in info.log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln or "spill" in ln]})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, do, mask, lse, delta = inputs(fk, getattr(torch, args.dtype), args.rows)
    bwd = (q, k, v, do, lse, delta, mask)
    ms = {"flash_fwd": median_ms(lambda: fk.flash_forward(q, k, v, mask), reps=args.reps),
          "flash_bwd_fused": median_ms(lambda: fk.flash_backward_fused(*bwd), reps=args.reps),
          "flash_bwd_dq": median_ms(lambda: fk.flash_backward_dq(*bwd), reps=args.reps),
          "flash_bwd_dkv": median_ms(lambda: fk.flash_backward_dkv(*bwd), reps=args.reps)}
    attn_mask = mask[:, None, None, :]
    with torch.no_grad(), sdpa_backend(q.dtype):
        ms["sdpa_fwd"] = median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), reps=args.reps)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with sdpa_backend(q.dtype):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)
    ms["sdpa_bwd"] = median_ms(
        lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True), reps=args.reps)
    emit({"time_ms": ms, "shape": f"({args.rows}, {HEADS}, {S_PAD}, {HEAD_DIM}) {args.dtype}, "
          f"{S_VALID} valid keys", "root": args.root, "card": card})
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fk.flash_forward(q, k, v, mask)
                fk.flash_backward_fused(*bwd)
            torch.cuda.synchronize()
        per_call = {}
        for evt in prof.key_averages():
            dev_us = (getattr(evt, "self_device_time_total", None)
                      or getattr(evt, "self_cuda_time_total", 0))
            if evt.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
                per_call[evt.key[:100]] = dev_us / 3 / 1e3
        emit({"profile_ms_per_call": per_call, "dtype": args.dtype, "root": args.root,
              "card": card})


if __name__ == "__main__":
    main()
