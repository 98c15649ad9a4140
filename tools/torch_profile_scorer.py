"""Where the time of one vtamiq_tpu_torch scorer batch or train step goes,
on a CUDA card.

    python3 tools/torch_profile_scorer.py [--batch 8] [--steps 5]
                                          [--patch-count 500] [--train]

Scores synthetic 384x512 pairs (chip_smoke.synthetic_pairs) with
VTAMIQScorer at ViT-B/16-6L width (seeded random weights, bf16) and prints
JSON lines (with ``--train``: the profile of ``make_train_step`` steps
instead, AdamW(5e-5, wd 0.01) with loss weights (1, 1, 1), as
``chip_smoke.py`` trains):

- stages: host-clock medians, each ended by torch.cuda.synchronize(), of the
  host-side stacking of the pairs into one array, the host-to-device copy,
  the patch extraction (draws + gather) and the model forward, beside a
  whole score_batch call;
- profile: torch.profiler over ``--steps`` score_batch calls: device time by
  kernel (top 15), the device's busy time and its idle share of the wall
  time (one stream, so kernels do not overlap).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import synthetic_pairs  # noqa: E402
from vtamiq_tpu_torch.inference import VTAMIQScorer  # noqa: E402
from vtamiq_tpu_torch.models.vtamiq import vtamiq_forward  # noqa: E402
from vtamiq_tpu_torch.ops.attention import choose_attention_fn  # noqa: E402
from vtamiq_tpu_torch.ops.sampling import PatchSampler  # noqa: E402
from vtamiq_tpu_torch.train.optim import Optimizer, build_freeze_mask  # noqa: E402
from vtamiq_tpu_torch.train.steps import ExtractConfig, make_train_step  # noqa: E402


def timed(fn, reps=10):
    """Median host seconds of fn() ended by a synchronize, and its result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def train_step_fn(scorer, refs, dists):
    """One make_train_step step on the scorer's model and the pairs."""
    model = scorer.params
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01,
                      max_norm=float("inf"))
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    mask = build_freeze_mask(model, False)
    step = make_train_step(scorer.cfg, PatchSampler(), ExtractConfig(
        patch_count=scorer.patch_count, patch_dim=scorer.cfg.vit.patch_size), adamw)
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)])).cuda()
    qs = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, len(refs)).astype(np.float32)
                          ).cuda()
    sample_gen = torch.Generator().manual_seed(0)
    model_gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda: step(model, state, mask, raw, qs, len(refs), (1.0, 1.0, 1.0), sample_gen,
                        model_gen)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--patch-count", type=int, default=500)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_scorer: needs a CUDA device")

    refs, dists = synthetic_pairs(args.batch)
    scorer = VTAMIQScorer(seed=0, device="cuda", patch_count=args.patch_count)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    if args.train:
        run = train_step_fn(scorer, refs, dists)
    else:
        run = lambda: scorer.score_batch(refs, dists)  # noqa: E731
    for _ in range(2):
        run()

    if args.train:
        step_s, _ = timed(run, reps=3)
        print(json.dumps({"train_step_ms": step_s * 1e3, "batch": args.batch,
                          "patch_count": args.patch_count, "pairs_per_s": args.batch / step_s,
                          "card": card}), flush=True)
    else:
        stage_s, raw = timed(lambda: np.stack([
            np.stack([scorer._to_host(r), scorer._to_host(d)]) for r, d in zip(refs, dists)]))
        copy_s, x = timed(lambda: torch.from_numpy(raw).to("cuda"))
        extract_s, (patches, pos, scales) = timed(lambda: scorer._extract(x, scorer._generator))
        attention_fn = choose_attention_fn(args.patch_count, train=False,
                                           batch_pairs=args.batch)
        with torch.inference_mode():
            forward_s, _ = timed(lambda: vtamiq_forward(
                scorer.params, scorer.cfg, patches, pos, scales,
                compute_dtype=scorer.compute_dtype, attention_fn=attention_fn))
        batch_s, _ = timed(run)
        print(json.dumps({"stages": {"host_stack_ms": stage_s * 1e3, "copy_in_ms": copy_s * 1e3,
                                     "extract_ms": extract_s * 1e3,
                                     "forward_ms": forward_s * 1e3,
                                     "score_batch_ms": batch_s * 1e3},
                          "batch": args.batch, "patch_count": args.patch_count,
                          "pairs_per_s": args.batch / batch_s, "card": card}), flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies); the CPU ops that launched
    # them carry the same time again
    rows = sorted(((e.key, e.count, device_us(e)) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0),
                  key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    print(json.dumps({
        "profile": {"steps": args.steps, "train": args.train,
                    "wall_ms_per_step": wall_s * 1e3 / args.steps,
                    "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
                    "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
                    "top": [{"name": k[:90], "calls_per_step": c / args.steps,
                             "ms_per_step": us / 1e3 / args.steps} for k, c, us in rows[:15]]},
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
