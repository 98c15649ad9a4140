"""Time the patch-gather kernel of vtamiq_tpu_torch on a CUDA card at the
scorer's shapes.

    python3 tools/torch_gather_bench.py [--root DIR]

``--root`` imports ``vtamiq_tpu_torch`` from another checkout, such as a
parent commit unpacked with ``git archive`` into ``.ab_parent/`` (which
``.gitignore`` lists), so two versions can be timed in one run on one card.
The inputs are those of ``chip_smoke.py``'s kernel phase: 16 images of
384x512x3 fp32 from a seeded generator, 500 corners each, 16x16 patches.
Prints one JSON line per output type (bf16 with the normalization fused, as
the scorer gathers; fp32 without it):

- ``device_ms_back_to_back``: CUDA events around a CUDA graph of 200
  back-to-back launches of the kernel's C entry point, over 200, median of
  5 replays (the 37.7 MB of images stay in the 50 MB L2 as far as they fit);
- ``device_ms_l2_flushed``: the same with a 64 MB buffer written before
  each launch, less a graph of those writes alone;
- ``call_ms_with_wrapper``: CUDA events around one ``gather_patches`` call
  (checks, allocation, ctypes and the launch), median of 30;

with the card's name and power limit. Correctness is checked by
``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

M, H, W, C, N, P = 16, 384, 512, 3, 500, 16
LAUNCHES = 200
L2_FLUSH_BYTES = 64 * 1024**2


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, warmup=5, reps=30):
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


def graph_ms(work, count=LAUNCHES, replays=5):
    """Median of CUDA events around a replay of a CUDA graph of ``count``
    back-to-back calls of ``work``, over ``count``."""
    for _ in range(3):
        work()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            work()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_gather_bench: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from vtamiq_tpu_torch import _build
    from vtamiq_tpu_torch.ops import gather_kernel

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    lib = _build.load_library()
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(M, H, W, C, generator=gen).cuda()
    ti = torch.randint(0, H - P + 1, (M, N), generator=gen, dtype=torch.int32).cuda()
    tj = torch.randint(0, W - P + 1, (M, N), generator=gen, dtype=torch.int32).cuda()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    floats = ctypes.c_float * C
    for mean, inv_std, dt in (((0.5,) * C, (2.0,) * C, torch.bfloat16),
                              (None, None, torch.float32)):
        out = torch.empty((M, N, P, P, C), dtype=dt, device="cuda")
        norm = (floats(*mean), floats(*inv_std)) if mean is not None else (None, None)

        def launch():  # holds out alive for as long as it is called
            err = lib.vtamiq_gather_patches(
                img.data_ptr(), ti.data_ptr(), tj.data_ptr(), out.data_ptr(), M, H, W, C, N, P,
                int(mean is not None), *norm, int(dt == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")

        def flushed():
            flush.zero_()
            launch()

        warm = graph_ms(launch)
        cold = graph_ms(flushed) - graph_ms(flush.zero_)
        call = median_ms(lambda: gather_kernel.gather_patches(img, ti, tj, P, mean, inv_std, dt))
        emit({"out": str(dt).replace("torch.", ""), "normalize": mean is not None,
              "device_ms_back_to_back": warm, "device_ms_l2_flushed": cold,
              "call_ms_with_wrapper": call, "shape": f"{M} x {H}x{W}x{C} fp32 -> {M} x {N} x "
              f"{P}x{P}x{C}", "root": args.root, "card": card})


if __name__ == "__main__":
    main()
