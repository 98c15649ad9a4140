"""Does the port's int8 W8A8 serving path keep a trained model's ranking?

The port's counterpart of ``tools/int8_accuracy.py``: a trained checkpoint
scores a synthetic distortion ladder (``data/synth.py``: 3 references x 5
distortion families x 8 severities = 120 graded pairs, 384x512) through
``VTAMIQScorer`` with and without ``quantize_int8``, with the same patch
draws (500 patches, 2 repeats). Both paths compute in fp32 (bf16 is slow on
a CPU), so the comparison isolates the W8A8 rounding. It reports
SROCC(int8, fp32), PLCC_NOFIT(int8, fp32), max |delta| as a fraction of the
fp32 scores' spread, and each family's SROCC(score, -severity) on both
paths, and writes them to a JSON file.

    python tools/torch_int8_accuracy.py [checkpoint.npz] [--device cpu]
        [--seed 0] [--out docs/torch_int8_accuracy.json]

The default checkpoint is the one ``tools/regen_int8_ckpt.py`` writes under
``.int8_regen_out/`` (not in git); without it the tool says so and exits 2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vtamiq_tpu_torch.data.synth import apply_distortion, make_base_image  # noqa: E402
from vtamiq_tpu_torch.inference import VTAMIQScorer  # noqa: E402
from vtamiq_tpu_torch.ops.correlations import compute_correlations  # noqa: E402
from vtamiq_tpu_torch.ops.quant import count_quantized_leaves  # noqa: E402

DEFAULT_CKPT = os.path.join(ROOT, ".int8_regen_out", "*-TID2013-VTAMIQ-ViT-B16-6L-4R-*",
                            "best.npz")
TYPES = {"gauss_noise": 0, "blur": 2, "quantize": 4, "contrast": 5, "jpeg_blockiness": 10}
LEVELS, REFS = 8, 3
H, W = 384, 512
PATCHES, REPEATS, SCORER_SEED = 500, 2, 11
CHUNK = 8  # pairs per score_batch call, to bound host memory


def ladder(seed):
    rng = np.random.default_rng(seed)
    refs, dists, labels = [], [], []
    for r in range(REFS):
        base = make_base_image(rng, H, W).astype(np.float32)
        for tname, tidx in TYPES.items():
            for lvl in range(1, LEVELS + 1):
                refs.append(base)
                dists.append(apply_distortion(rng, base, tidx, lvl, LEVELS,
                                              type_gain=1.0).astype(np.float32))
                labels.append((r, tname, lvl))
    return refs, dists, labels


def score(ckpt, device, quantize, refs, dists):
    scorer = VTAMIQScorer.from_checkpoint(ckpt, patch_count=PATCHES, num_repeats=REPEATS,
                                          seed=SCORER_SEED, quantize_int8=quantize,
                                          device=device, compute_dtype=torch.float32)
    q = np.concatenate([scorer.score_batch(refs[i:i + CHUNK], dists[i:i + CHUNK])
                        for i in range(0, len(refs), CHUNK)])
    return q, count_quantized_leaves(scorer.params)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "torch_int8_accuracy.json"))
    args = ap.parse_args(argv)
    ckpt = args.checkpoint or next(iter(sorted(glob.glob(DEFAULT_CKPT))), DEFAULT_CKPT)
    if not os.path.isfile(ckpt):
        print(f"checkpoint {ckpt} not found: write it with tools/regen_int8_ckpt.py or pass "
              f"a trained VTAMIQ checkpoint", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    refs, dists, labels = ladder(args.seed)
    print(f"{len(refs)} pairs ({REFS} refs x {len(TYPES)} types x {LEVELS} levels), "
          f"seed {args.seed}, device {kind}, checkpoint {ckpt}", flush=True)
    t0 = time.perf_counter()
    q32, _ = score(ckpt, device, False, refs, dists)
    t32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    q8, leaves = score(ckpt, device, True, refs, dists)
    t8 = time.perf_counter() - t0
    corr = compute_correlations(q8, q32)
    spread = float(np.max(q32) - np.min(q32))
    maxd = float(np.max(np.abs(q8 - q32)))
    per_type = {}
    for tname in TYPES:
        idx = [i for i, (_, t, _) in enumerate(labels) if t == tname]
        sev = -np.asarray([labels[i][2] for i in idx], float)
        per_type[tname] = {"fp32": float(compute_correlations(q32[idx], sev)["SROCC"]),
                           "int8": float(compute_correlations(q8[idx], sev)["SROCC"])}
    artifact = {
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "tool": "tools/torch_int8_accuracy.py", "device": kind, "torch": torch.__version__,
        "checkpoint": os.path.relpath(ckpt, ROOT), "seed": args.seed, "pairs": len(refs),
        "patch_count": PATCHES, "repeats": REPEATS, "compute_dtype": "float32",
        "quantized_leaves": leaves,
        "SROCC_int8_vs_fp32": float(corr["SROCC"]),
        "PLCC_NOFIT_int8_vs_fp32": float(corr["PLCC_NOFIT"]),
        "max_abs_delta_q": maxd, "fp32_score_spread": spread,
        "max_delta_fraction_of_spread": maxd / max(spread, 1e-9),
        "per_type_severity_srocc": per_type,
        "seconds": {"fp32": t32, "int8": t8},
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
