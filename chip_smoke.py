"""Drive vtamiq_tpu_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device      — a CUDA card is required; its name and power limit.
2. build       — nvcc builds the kernels from vtamiq_tpu_torch/csrc, one
                 process per source, all at once (seconds and the -Xptxas -v
                 report).
3. kernel      — the patch-gather kernel against its plain PyTorch version on
                 the same CUDA tensors, bit for bit (torch.equal): the
                 scorer's shapes (16 images 384x512x3, 500 patches of 16x16,
                 bf16 out with the normalization fused), an fp32 case without
                 normalization, an odd width (481) with corners on and past
                 the edges, the use_pu input (the PU-encoded fp32 image, no
                 normalization, bf16 out: pu_bf16_plain) and a K = 3
                 pairwise batch (36 images 256x256, 256 patches). The
                 kernel's device time: CUDA events around
                 a CUDA graph of 200 back-to-back launches of its C entry
                 point, over 200 (and the same with the 50 MB L2 flushed
                 before each launch); one wrapper call and the plain version
                 timed with CUDA events (median of 30 calls after warm-up).
4. attention   — the flash-attention forward, fused backward and split
                 (dq, dkv) backward kernels against their plain versions at
                 the 5000-patch shapes (16 rows, 12 heads, 5009 tokens padded
                 to 5056, head dim 64, padded keys masked), in fp32 (TF32
                 off) and bf16; the fused backward launched twice on the same
                 inputs gives the same dq, dk and dv bit for bit
                 (torch.equal), and the split backward gives the fused one's
                 bit for bit, in both types; the kernels, plain versions and
                 PyTorch's scaled_dot_product_attention timed with CUDA
                 events in both types (fp32 SDPA held to its memory-efficient
                 backend, its error against the plain version reported).
5. scorer      — VTAMIQScorer at full ViT-B/16-6L width, weights drawn from a
                 seeded torch.Generator: 8 synthetic 384x512 pairs in one batch
                 (finite scores; exactly one gather launch); 2 pairs scored in
                 fp32 on the CPU and on the card with TF32 off (|dq| <= 1e-3);
                 the encoder's tokens in bf16 on the card against fp32 on the
                 CPU (relative error <= 2e-2), with PyTorch's default
                 torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
                 and, reported beside it, with the flag off; pairs/s at
                 batch 8.
5b. scorer_int8 — VTAMIQScorer(quantize_int8=True) at the scorer's width:
                 the encoder is quantized at the first score (37 int8
                 leaves, the JAX package's count: the patch embed and q, k,
                 v, out, fc1, fc2 of 6 layers); one batch of 8 pairs runs
                 one gather and 37 int8 products (torch._int_mm, counted).
                 Gates: _int_mm equal (torch.equal) to the plain product
                 for every encoder shape at 500 patches, the last layer's
                 pushdown rows at batch 1 and 5 rows (padded to 17); every
                 dense_q8 call of an fp32 forward on the card recomputed by
                 the CPU from the card's inputs (at most 8 rows with a
                 quant flip, the rest to 1e-6 relative); fp32 int8 tokens
                 card vs CPU (cosine > 0.995) and q (within twice the CPU's
                 own int8 distance from its fp32 q); int8 against bf16
                 tokens on the card (cosine > 0.995). Reported: int8 and
                 bf16 pairs/s in 8 rounds of turns (each the median of 3
                 timed batches, utils/benchharness.timed_stats), device
                 kernels and copies per batch and per dense call
                 (torch.profiler), the encoder's weight bytes, the peak
                 memory of one batch, and fc1's int8 product against the
                 bf16 matmul of the same shape with their bounds.
6. weighted_caps — BASELINE configs 2 and 3 at full width: weighted CAPS
                 (diff weight 1, uniform weight 0.1, PERTURBED cells) with
                 the SSIM diff map (config 2 scoring) and the MAGNITUDE one
                 (config 3 training). Gates: the diff maps of the 8 pairs,
                 card against CPU in fp32 (relative error <= 1e-5); the
                 card's cell counts and corners for the same 8 items
                 against the CPU's on the card's probability maps and the
                 same draws (counts equal, corners within 1e-3 px); fp32 q
                 of 2 pairs, card against CPU on the same card-sampled
                 corners, TF32 off (|dq| <= 1e-3); 3 config 3 train steps
                 in bf16 (finite loss, one gather launch each). Reported:
                 pairs/s of the config 2 and the uniform scorer at batch 8,
                 trained pairs/s, the weighted sampling's time per batch
                 (host clock and CUDA events) and its launches
                 (torch.profiler), the gather launches of both scorers, and
                 SROCC, KROCC, PLCC and RMSE of the config 2 scorer over 96
                 graded synthetic pairs against their synthetic quality
                 (random weights: context only).
7. server      — ScoringServer on 127.0.0.1: 4 concurrent /score, one /compare,
                 one /healthz, all answered with 200 and finite values.
8. scorer_5000p — VTAMIQScorer(patch_count=5000), batch 8, bf16: finite
                 scores through 5 flash-forward launches and 1 gather launch;
                 pairs/s; at batch 2 in fp32 (TF32 off) the forward with
                 flash attention against the plain quadratic forward on the
                 same patches (|dq| <= 1e-3), each timed (median of 3 calls),
                 with the fp32 flash-forward launches counted in the timed
                 calls.
9. train_5000p — make_train_step at batch 8, bf16, AdamW(5e-5, wd 0.01),
                 loss weights (1, 1, 1): 1 warm-up and 3 timed steps (5 flash
                 forward and 5 fused backward launches each), one timed step
                 with the split backward (5 dq and 5 dkv launches); a bf16
                 forward and backward with DropPath active, without and with
                 remat (ViTConfig.remat: each encoder layer recomputed in the
                 backward), every gradient equal (torch.equal), each
                 reported with its ms, peak memory and flash launches; in
                 fp32 at batch 2 the fused and split backward's gradient
                 norms agree (1e-4 relative), a step through the flash
                 kernels against a step through plain attention (loss 1e-5),
                 and the encoder's gradient through each (every tensor 1e-3
                 relative), with the flash launches of each fp32 run
                 reported.
9b. model_extras — fp32, TF32 off, card against CPU on the same patches:
                 one train step with one Houlsby adapter a layer at 500
                 patches, the encoder frozen and the adapters trainable
                 (loss 1e-4, q 1e-3); config 3's weighted train step with
                 use_pu (q 1e-3, loss 1e-4); and one bf16 config 3 use_pu
                 step on the card whose gather (PU image, no
                 normalization, bf16 out) equals the plain version.
9c. ring_attention — ring attention (vtamiq_tpu_torch/parallel/) in worlds
                 of 2 and 4 ranks, each a child process of this script on the
                 one card over gloo (NCCL cannot put two ranks on one
                 device), at config 5's shapes: 16 rows, 12 heads, 5009
                 valid tokens padded to 5120, head dim 64, in bf16 and in
                 fp32 with TF32 off. Gates: each rank's output and dq, dk,
                 dv chunks against ops/attention.py::flash_attention over
                 the whole sequence on the same card (max error over max
                 magnitude: fp32 1e-5 for the output and 1e-4 for the
                 gradients, bf16 2e-2), n flash-forward and n
                 fused-backward launches a call a rank, finite values when
                 the last rank's chunk is padding alone, and one fp32 call
                 with the split backward (n dq and n dk/dv launches).
                 Reported: the ring's forward and backward ms beside the
                 single-device call's (the ranks share the card: context,
                 not a scaling number).
9d. mesh_steps — two ranks on the card, full width (ViT-B/16, 6 layers, 8
                 registers, DiffNet head), AdamW(5e-5, wd 0.01, clip 1.0),
                 the weighted loss with weights (1, 1, 1), the head's
                 DropPath and dropout active: config 3's train step (500
                 patches, weighted CAPS, batch 8) under data = 2 and under
                 model = 2 (6 heads and 1536 MLP features a rank), config
                 5's (5000 patches, batch 2) under seq = 2 through the ring;
                 fp32 with TF32 off against the single-process step on the
                 same card, global batch and generators: loss 1e-5 and
                 grad_norm 1e-4 relative, q 1e-3, every updated parameter
                 2.5e-4 (the last two JAX's own mesh bounds); the ranks agree; one gather launch a step
                 a rank and, under seq = 2, 2 x 5 flash-forward and fused-
                 backward launches; then one bf16 step each: finite, timed.
10. engine_config3 — BASELINE config 3 through engine.train() at full width
                 (ViT-B/16 6 layers, 8 registers, DiffNet head, 500 patches,
                 weighted CAPS with the MAGNITUDE diff map, batch 8, AdamW,
                 bf16) from image files that the port's synth writers put in
                 a temporary directory (one child process per dataset tree,
                 after the timed phases above; the dataset_writers line
                 gives the seconds waited): train on 300 pairs of the KADID-10k
                 layout at 384x512 (the TID2013 layout where the decoder
                 build reads no PNG), val on 100, test on 120 pairs of the
                 TID2013 layout; one epoch, files written. Then a resume from
                 latest.npz for one more epoch under torch.profiler. Gates:
                 latest.npz, best.npz, the YAML dumps and model_params.txt
                 written; best.npz equal to the trained model bit for bit;
                 the resume starts at epoch 2 with the optimizer's count
                 carried; finite test SROCC; one gather launch per step.
                 Reported: trained pairs/s of the epoch beside the bare
                 step's (weighted_caps), the loader's decode ms per batch,
                 the ms a step waits on the loader, the device's idle share
                 over the resumed epoch, gather launches per step.
11. engine_config5 — BASELINE config 5 through engine.train() at 5000
                 patches, bf16, batch 8: train on 116 pairs of the PIPAL
                 layout (288x288), test on 60 pairs of the LIVE layout
                 (sizes vary: two canonical buckets with img_hw), then a
                 test-only run on 24 pairs of the CSIQ layout (512x512 PNG)
                 from the trained checkpoint. Gates: flash-forward launches
                 equal (layers - 1) per train step and per test batch, fused
                 backward launches (layers - 1) per train step; finite
                 correlations. Reported: trained and scored pairs/s.
12. engine_pieapp — the PieAPP pretraining recipe (run tag 2e-12b-256p)
                 through engine.train(): ViT-B/16 6 layers, 8 registers,
                 ImageNet weights from a synthetic ViT-B_16-layout npz (12
                 blocks, a 14x14 positional grid resized to 24x24; written
                 with the datasets), the preference module, batch 12, 256
                 patches, AdamW, bf16; 140 PieAPP references of 3 pairs at
                 256x256, split 130 / 5 / 5; one epoch, then a resumed epoch
                 under torch.profiler. Gates: the checkpoint holds the
                 preference module apart from the model, the resume reloads
                 it bit for bit, p moved from 6, one gather launch a step,
                 no flash launch (265 tokens stay below the threshold),
                 finite losses, and one fp32 pairwise step of 2 triplets
                 (card against CPU from the same weights: loss 1e-4, p
                 1e-6). Reported: trained triplets/s beside the bare
                 pairwise step's, decode and wait ms per batch, the
                 device's idle share over the resumed epoch.
12b. engine_mesh — engine.train() with mesh_data = 2 across two ranks on
                 the card, on the engine_config3 tree (4 pairs a rank: the
                 global batch 8), bf16, one epoch of train, val and test,
                 each rank given its own output root, then a resumed train
                 epoch. Gates: the test correlations equal on both ranks;
                 rank 0 alone wrote files; best.npz equal to rank 0's
                 trained model bit for bit; the resume starts at epoch 2;
                 one gather launch a step a rank.
13. kernels    — one JSON object per kernel: time, bound, plain time,
                 library time in bf16 and in fp32 (the fp32 bound at the
                 3xTF32 rate, beside it at the FFMA rate), launches on the
                 main path, in the fp32 runs, in the engine phases, in the
                 remat step, on the ring (flash) and in the mesh steps
                 (gather).

The build phase also reports the host image decoder's build seconds and the
codecs it holds.

The last line is {"ok": true, "device": {...}}. Any failure raises, so the
exit code is not 0; with no CUDA device the script exits 1 before any result.
The temporary datasets are deleted and the writer processes ended on exit.
A watchdog ends a hung run after 900 s with a traceback and exit code 1.
"""

import faulthandler

faulthandler.dump_traceback_later(900, exit=True)

import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import contextlib  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import ctypes  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from vtamiq_tpu_torch import _build  # noqa: E402
from vtamiq_tpu_torch.data import datasets, native_io, synth  # noqa: E402
from vtamiq_tpu_torch.inference import VTAMIQScorer  # noqa: E402
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config  # noqa: E402
from vtamiq_tpu_torch.models.preference import attach_preference_module  # noqa: E402
from vtamiq_tpu_torch.models.vit import QuantDense, dense  # noqa: E402
from vtamiq_tpu_torch.models.vtamiq import init_vtamiq_params, vtamiq_forward  # noqa: E402
from vtamiq_tpu_torch.ops import flash_kernel, gather_kernel  # noqa: E402
from vtamiq_tpu_torch.ops import quant, sampling  # noqa: E402
from vtamiq_tpu_torch.ops.attention import (FLASH_ATTENTION_THRESHOLD,  # noqa: E402
                                            make_attention_fn)
from vtamiq_tpu_torch.ops.correlations import compute_correlations  # noqa: E402
from vtamiq_tpu_torch.ops.extraction import get_iqa_patches  # noqa: E402
from vtamiq_tpu_torch.ops.losses import loss_func_iqa  # noqa: E402
from vtamiq_tpu_torch.ops.sampling import PatchSampler  # noqa: E402
from vtamiq_tpu_torch.serving import ScoringServer  # noqa: E402
from vtamiq_tpu_torch.models.checkpoint import OPT_LEAVES, load_checkpoint  # noqa: E402
from vtamiq_tpu_torch.train import config as engine_config, engine  # noqa: E402
from vtamiq_tpu_torch.train.optim import Optimizer, build_freeze_mask  # noqa: E402
from vtamiq_tpu_torch.train.steps import (ExtractConfig, make_extract_fn,  # noqa: E402
                                          make_train_step, make_train_step_on_patches)
from vtamiq_tpu_torch.utils import benchharness  # noqa: E402
from vtamiq_tpu_torch.utils.color_spaces import pu_display_encode_torch  # noqa: E402

SEED = 0
H, W, C, P, N = 384, 512, 3, 16, 500
PAIRS = 8
# the PieAPP pretraining recipe (run tag 2e-12b-256p): batch 12, 256 patches,
# 256x256 PieAPP images
PIEAPP_BATCH, PIEAPP_PATCHES, PIEAPP_HW = 12, 256, 256
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# fp32-accurate products on the tensor cores: 3 TF32 products (TF32 dense
# is half the bf16 rate) per fp32 product
TF32X3_FLOPS_PER_S = BF16_FLOPS_PER_S / 2 / 3
# special-function (exp) rate: 132 SMs x 16 results per clock x 1.83 GHz boost
SFU_PER_S = 132 * 16 * 1.83e9
FP32_Q_TOL = 1e-3             # card fp32 vs CPU fp32: summation order only
# bf16 policy: the encoder's output tokens on the card in bf16 against the
# CPU's in fp32, as a relative norm. bf16 keeps 8 significant bits (2^-8 =
# 0.4% per rounding); 6 layers of rounded products and sums compound that to
# about 1%. The score q is not held in bf16: q reads cls_ref - cls_dist,
# which with random weights is a few percent of the CLS vectors' norm, so
# their 1% rounding moves q by about a fifth (an H100 run: CLS difference
# 1.2 to 1.5, bf16 rounding of each CLS vector 0.25 to 0.28). q's bf16
# distance from fp32 is reported beside those norms.
BF16_TOKEN_REL_TOL = 2e-2


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase lines carry the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


GATHER_LAUNCHES = 200         # back-to-back launches timed as one CUDA graph
L2_FLUSH_BYTES = 64 * 1024**2  # more than the H100's 50 MB L2


def median_ms(fn, warmup=5, reps=30):
    """Median of ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# 1. device, 2. build
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU\n")
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    _build.load_library()
    info = _build.build_info()
    report = [ln.strip() for ln in info.log.splitlines()
              if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    host = native_io.build_info()
    emit({"phase": "build", "seconds": info.seconds,
          "libraries": [p.split("/")[-1] for p in info.paths], "ptxas": report,
          "host_decoder": {"seconds": host.seconds, "codecs": native_io.codecs(),
                           "library": os.path.basename(host.path)}})


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

def _corners(gen, m, h, w, n, edges=False):
    ti = torch.randint(0, h - P + 1, (m, n), generator=gen, dtype=torch.int32)
    tj = torch.randint(0, w - P + 1, (m, n), generator=gen, dtype=torch.int32)
    ti[:, :4] = torch.tensor([0, h - P, 0, h - P], dtype=torch.int32)
    tj[:, :4] = torch.tensor([0, w - P, w - P, 0], dtype=torch.int32)
    if edges:  # past the edges: both versions clamp into the image
        ti[:, 4:6] = torch.tensor([-5, h], dtype=torch.int32)
        tj[:, 4:6] = torch.tensor([w + 3, -1], dtype=torch.int32)
    return ti.cuda(), tj.cuda()


def _gather_bound_ms(img, ti, tj, out):
    """Least time for the gather at these inputs: the image pixels the
    patches cover (each read once), the corners, and the output (written
    once) over the memory rate; the normalization's 2 fp32 operations per
    output element over the fp32 rate. Returns (ms, bound_by)."""
    m, h, w, c = img.shape
    covered = torch.zeros(m, h, w, dtype=torch.bool, device=img.device)
    r = torch.arange(P, device=img.device)
    rows = ti.long().clamp(0, h - P)[:, :, None, None] + r[:, None]
    cols = tj.long().clamp(0, w - P)[:, :, None, None] + r[None, :]
    covered[torch.arange(m, device=img.device)[:, None, None, None], rows, cols] = True
    nbytes = (int(covered.sum()) * c * img.element_size()
              + ti.numel() * 4 + tj.numel() * 4 + out.numel() * out.element_size())
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * out.numel() / FP32_FLOPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def gather_launcher(img, ti, tj, mean, inv_std, out_dtype):
    """A launch of the gather kernel's C entry point on the current stream,
    with the wrapper's checks and its allocation of the output done once
    beforehand, so that only the device's work is timed. Launches made
    here are not counted in ``gather_kernel.launches``."""
    lib = _build.load_library()
    m, h, w, c = img.shape
    n = ti.shape[1]
    out = torch.empty((m, n, P, P, c), dtype=out_dtype, device=img.device)
    floats = ctypes.c_float * c
    norm = (floats(*mean), floats(*inv_std)) if mean is not None else (None, None)

    def launch():  # holds img, ti, tj and out alive for as long as it is called
        err = lib.vtamiq_gather_patches(
            img.data_ptr(), ti.data_ptr(), tj.data_ptr(), out.data_ptr(), m, h, w, c, n, P,
            int(mean is not None), *norm, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")

    return launch


def graph_ms(work, count=GATHER_LAUNCHES, replays=5):
    """Median over ``replays`` of CUDA events around one replay of a CUDA
    graph that holds ``count`` back-to-back calls of ``work``, over
    ``count``."""
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    del graph
    return float(np.median(times))


def gather_device_ms(launch):
    """The gather's device time per launch, back to back (the image stays
    in L2 as far as it fits), and with the L2 flushed before each launch
    (a graph of flush + launch, less a graph of the flushes alone)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flushed():
        flush.zero_()
        launch()

    warm = graph_ms(launch)
    cold = graph_ms(flushed) - graph_ms(flush.zero_)
    del flush
    return warm, cold


def phase_kernel():
    gen = torch.Generator().manual_seed(SEED)
    mean, inv_std = (0.5, 0.5, 0.5), (2.0, 2.0, 2.0)
    img = torch.rand(2 * PAIRS, H, W, C, generator=gen).cuda()
    ti, tj = _corners(gen, 2 * PAIRS, H, W, N)
    img_odd = torch.rand(2, H, 481, C, generator=gen).cuda()
    ti_odd, tj_odd = _corners(gen, 2, H, 481, N, edges=True)
    # the use_pu input: the PU-encoded image in fp32, gathered without
    # normalization to bf16 (the kernel rounds each patch once)
    img_pu = pu_display_encode_torch(torch.rand(2 * PAIRS, H, W, C, generator=gen).cuda())
    # a K = 3 pairwise batch: 12 triplets of 256x256 images, 256 patches
    img_k3 = torch.rand(3 * PIEAPP_BATCH, PIEAPP_HW, PIEAPP_HW, C, generator=gen).cuda()
    ti_k3, tj_k3 = _corners(gen, 3 * PIEAPP_BATCH, PIEAPP_HW, PIEAPP_HW, PIEAPP_PATCHES)
    cases = {
        "main_bf16_norm": (img, ti, tj, mean, inv_std, torch.bfloat16),
        "main_fp32_plain": (img, ti, tj, None, None, torch.float32),
        "odd_width_481_bf16_norm": (img_odd, ti_odd, tj_odd, mean, inv_std, torch.bfloat16),
        "odd_width_481_fp32_plain": (img_odd, ti_odd, tj_odd, None, None, torch.float32),
        "pu_bf16_plain": (img_pu, ti, tj, None, None, torch.bfloat16),
        "k3_36x256x256_bf16_norm": (img_k3, ti_k3, tj_k3, mean, inv_std, torch.bfloat16),
    }
    results = {}
    for name, (x, a, b, mu, inv, dt) in cases.items():
        got = gather_kernel.gather_patches(x, a, b, P, mu, inv, dt)
        torch.cuda.synchronize()
        want = gather_kernel.gather_patches_plain(x, a, b, P, mu, inv, dt)
        equal = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        results[name] = {"equal": equal, "max_abs_err": err, "shape": list(got.shape)}
        if not equal:
            emit({"phase": "kernel", "cases": results})
            raise AssertionError(f"gather kernel != plain version in case {name}: "
                                 f"max abs err {err}")

    x, a, b, mu, inv, dt = cases["main_bf16_norm"]
    device_ms, device_cold_ms = gather_device_ms(gather_launcher(x, a, b, mu, inv, dt))
    call_ms = median_ms(lambda: gather_kernel.gather_patches(x, a, b, P, mu, inv, dt))
    plain_ms = median_ms(lambda: gather_kernel.gather_patches_plain(x, a, b, P, mu, inv, dt))
    out = gather_kernel.gather_patches(x, a, b, P, mu, inv, dt)
    bound_ms, bound_by = _gather_bound_ms(x, a, b, out)
    timing = {"device_ms_back_to_back": device_ms, "device_ms_l2_flushed": device_cold_ms,
              "call_ms_with_wrapper": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by}
    emit({"phase": "kernel", "cases": results, "shape": "16 x 384x512x3 fp32 -> 16 x 500 "
          "x 16x16x3 bf16, normalize fused", **timing,
          "device_timing": f"CUDA events around a CUDA graph of {GATHER_LAUNCHES} "
          "back-to-back launches of the C entry point, over their count, median of 5"})
    return {**timing, "max_abs_err": max(r["max_abs_err"] for r in results.values())}


# ---------------------------------------------------------------------------
# 5. scorer
# ---------------------------------------------------------------------------

def synthetic_pairs(n, seed=SEED):
    """Smooth random reference images and distorted copies with graded
    Gaussian noise (even pairs) or box blur (odd pairs), HWC fp32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                         np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
    refs, dists = [], []
    for i in range(n):
        ref = np.zeros((H, W, C), np.float32)
        for _ in range(6):
            fy, fx, ph = rng.uniform(1, 12), rng.uniform(1, 12), rng.uniform(0, 2 * np.pi)
            ref += (rng.uniform(0.05, 0.2, C) *
                    np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)[..., None]).astype(np.float32)
        ref = np.clip(ref + 0.5 + rng.normal(0, 0.02, ref.shape), 0, 1).astype(np.float32)
        level = 1 + i // 2
        if i % 2 == 0:
            dist = ref + rng.normal(0, 0.03 * level, ref.shape)
        else:
            k = 2 * level + 1
            pad = np.pad(ref, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
            cs = np.cumsum(np.cumsum(pad, 0), 1)
            cs = np.pad(cs, ((1, 0), (1, 0), (0, 0)))
            dist = (cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]) / (k * k)
        refs.append(ref)
        dists.append(np.clip(dist, 0, 1).astype(np.float32))
    return refs, dists


def phase_scorer(card):
    refs, dists = synthetic_pairs(PAIRS)
    scorer = VTAMIQScorer(seed=SEED, device="cuda")  # ViT-B/16, 6 layers, 8 registers
    cfg = scorer.cfg.vit
    # the main path: counts reset just before, read just after
    gather_kernel.launches = 0
    qs = scorer.score_batch(refs, dists)
    launches = gather_kernel.launches
    expected = 1 * scorer.num_repeats * scorer.patch_num_scales  # one size group
    if not np.isfinite(qs).all():
        raise AssertionError(f"non-finite scores: {qs}")
    if launches != expected:
        raise AssertionError(f"gather kernel launched {launches} times, expected {expected}")

    # card vs CPU on the same weights and the same patch draws, in fp32
    # (TF32 off) and in the bf16 policy; bf16 vs fp32 is reported
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def q_of(device, dtype):
        return VTAMIQScorer(seed=SEED, device=device, compute_dtype=dtype
                            ).score_batch(refs[:2], dists[:2])

    q_cpu32, q_gpu32 = q_of("cpu", torch.float32), q_of("cuda", torch.float32)
    q_gpu16 = q_of("cuda", torch.bfloat16)
    d32 = float(np.max(np.abs(q_gpu32 - q_cpu32)))
    if not d32 <= FP32_Q_TOL:
        raise AssertionError(f"card fp32 vs CPU fp32: |dq| {d32} > {FP32_Q_TOL}")
    tokens = bf16_tokens_vs_fp32(refs[:2], dists[:2])
    if not tokens["rel_err"] <= BF16_TOKEN_REL_TOL:
        raise AssertionError(f"card bf16 tokens vs CPU fp32: relative error "
                             f"{tokens['rel_err']} > {BF16_TOKEN_REL_TOL}")
    # cuBLAS may add split-K partials of bf16 GEMMs in bf16 unless this flag
    # is off; the same tokens with it off, reported beside the gated ones
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        tokens_off = bf16_tokens_vs_fp32(refs[:2], dists[:2])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    split_k = {"allow_bf16_reduced_precision_reduction": reduced,
               "rel_err_flag_default": tokens["rel_err"],
               "rel_err_flag_off": tokens_off["rel_err"]}

    # pairs/s at batch 8 (host arrays in, scores out: end to end)
    for _ in range(2):
        scorer.score_batch(refs, dists)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        scorer.score_batch(refs, dists)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit({"phase": "scorer", "config": f"ViT-B/16 {cfg.effective_num_layers} layers, "
          f"{cfg.num_extra_tokens} registers, {scorer.patch_count} patches of "
          f"{cfg.patch_size}x{cfg.patch_size}, {H}x{W}", "q": [float(q) for q in qs],
          "gather_launches": launches, "expected_launches": expected,
          "tf32": False, "q_cpu_fp32": q_cpu32.tolist(), "q_card_fp32": q_gpu32.tolist(),
          "q_card_bf16": q_gpu16.tolist(), "fp32_card_vs_cpu": d32, "fp32_tol": FP32_Q_TOL,
          "bf16_q_vs_fp32": float(np.max(np.abs(q_gpu16 - q_cpu32))),
          "bf16_tokens": tokens, "bf16_token_rel_tol": BF16_TOKEN_REL_TOL,
          "bf16_tokens_split_k": split_k, "batch": PAIRS,
          "batch_s_median": med, "pairs_per_s": PAIRS / med, "card": card})
    return scorer, refs, dists, launches


def bf16_tokens_vs_fp32(refs, dists):
    """The encoder's output tokens for the same fp32 patches (drawn and
    gathered on the CPU): card bf16 against CPU fp32. Returns the relative
    error over all tokens, and per pair the fp32 CLS difference between the
    towers beside the bf16 rounding of the CLS vectors."""
    cpu = VTAMIQScorer(seed=SEED, device="cpu", compute_dtype=torch.float32)
    card = VTAMIQScorer(seed=SEED, device="cuda")
    extract = make_extract_fn(cpu.sampler, ExtractConfig(
        patch_count=cpu.patch_count, patch_dim=P, gather_dtype="float32"))
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)]))
    patches, pos, _ = extract(raw, torch.Generator().manual_seed(SEED))
    patches = patches.reshape((-1,) + patches.shape[2:])
    pos = pos.reshape(patches.shape[0], -1, 2)
    with torch.inference_mode():
        f32 = cpu.params.vit(patches, pos, compute_dtype=torch.float32)
        f16 = card.params.vit(patches.cuda(), pos.cuda(), compute_dtype=torch.bfloat16).cpu()
    cls32, cls16 = f32[:, 0], f16[:, 0]
    return {"rel_err": float((f16 - f32).norm() / f32.norm()),
            "cls_ref_minus_dist_fp32": (cls32[0::2] - cls32[1::2]).norm(dim=-1).tolist(),
            "cls_bf16_rounding": (cls16 - cls32).norm(dim=-1).tolist()}


# ---------------------------------------------------------------------------
# 5b. the int8 W8A8 scorer
# ---------------------------------------------------------------------------

INT8_TOPS = 1979e12            # H100 SXM int8 tensor cores, dense
# patch embed + (q, k, v, out, fc1, fc2) in each of 6 layers: the count the
# JAX package's quantize_params_int8 gives for the scorer's encoder
INT8_LEAVES = 1 + 6 * 6
# int8 card vs CPU, fp32 compute, the same patches. Two devices sum in other
# orders, so an activation now and then lands on the other side of a
# rounding midpoint of its row's quant and moves by one step (1/127 of the
# row's amax); each such flip moves the next layer's inputs by far more than
# fp32 rounding does, and the flips multiply through the layers (an H100
# run: 3 flips in layer 0's q, 14.1M of 75.2M activations by the last layer,
# tokens 1.5% apart, as far as int8 is from fp32 on the CPU: 2.3%). So:
# - every dense_q8 call of the card's forward is recomputed by the CPU's
#   dense_q8 from the card's own input: the quant may flip only where the
#   two devices round one product differently (at most DENSE_Q8_FLIP_ROWS
#   rows with a flip over all calls), every other row equal to
#   DENSE_Q8_REL_TOL of the call's largest output;
# - the card's int8 tokens against the CPU's: cosine > INT8_TOKEN_COS;
# - the card's int8 q within INT8_Q_BAND times the CPU's own int8 distance
#   from the fp32 q (plus FP32_Q_TOL): random weights make q a small
#   difference of two CLS vectors, which amplifies any token noise
DENSE_Q8_FLIP_ROWS = 8
DENSE_Q8_REL_TOL = 1e-6
INT8_Q_BAND = 2.0
INT8_TOKEN_COS = 0.995          # also int8 vs bf16 tokens (tests/test_quant.py's gate)
INT8_ROUNDS = 8                 # timed rounds per path, in turns


def int_mm_shapes(cfg, pairs):
    """(name, M, K, N) of every int8 product of the scorer's encoder."""
    h, m, s = cfg.hidden_size, cfg.mlp_dim, cfg.num_tokens + N
    rows, q1 = 2 * pairs * s, 2 * cfg.num_tokens  # the pushdown at batch 1
    return [("qkv_out", rows, h, h), ("fc1", rows, h, m), ("fc2", rows, m, h),
            ("patch_embed", 2 * pairs * N, P * P * C, h),
            ("pushdown_q_b1", q1, h, h), ("pushdown_fc1_b1", q1, h, m),
            ("pushdown_fc2_b1", q1, m, h), ("rows_under_17", 5, h, m)]


def int8_operands(gen, m, k, n):
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    b = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda().t()
    return a, b   # b (K, N) column-major, as QuantDense stores kernel_q8


def int_mm_gates(cfg, gen):
    out = {}
    for name, m, k, n in int_mm_shapes(cfg, PAIRS):
        a, b = int8_operands(gen, m, k, n)
        got = quant.int8_matmul(a, b)
        want = quant.int8_matmul_plain(a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"_int_mm {name} ({m}, {k}, {n}) differs from the plain "
                                 f"product: max |d| {(got - want).abs().max().item()}")
        out[name] = [m, k, n]
    return out


def dense_q8_calls_card_vs_cpu(scorer, patches, pos):
    """Every dense_q8 call of one fp32 int8 forward on the card (every
    encoder shape: q, k, v, out, fc1, fc2, the patch embed, the last layer's
    pushdown), recomputed by the CPU's dense_q8 from the card's input."""
    calls, orig = [], quant.dense_q8

    def recording(p, x, dtype=None):
        y = orig(p, x, dtype)
        calls.append((p, x, y.cpu()))
        return y
    quant.dense_q8 = recording
    try:
        with torch.inference_mode():
            vtamiq_forward(scorer.params, scorer.cfg, patches, pos, compute_dtype=torch.float32)
    finally:
        quant.dense_q8 = orig
    flip_rows, worst, exact = 0, 0.0, 0
    with torch.inference_mode():
        for p, x, y_card in calls:
            x_cpu = x.cpu()
            y_cpu = quant.dense_q8(copy.deepcopy(p).cpu(), x_cpu)
            flips = (quant.quantize_rows(x)[0].cpu() != quant.quantize_rows(x_cpu)[0]).any(-1)
            flip_rows += int(flips.sum())
            keep = ~flips
            err = float((y_card[keep] - y_cpu[keep]).abs().max()) / float(y_cpu.abs().max())
            worst = max(worst, err)
            exact += bool(torch.equal(y_card, y_cpu))
    if flip_rows > DENSE_Q8_FLIP_ROWS or not worst <= DENSE_Q8_REL_TOL:
        raise AssertionError(f"dense_q8 card vs CPU on the card's inputs: {flip_rows} rows "
                             f"with a flip (allowed {DENSE_Q8_FLIP_ROWS}), relative error "
                             f"{worst} on the rest (allowed {DENSE_Q8_REL_TOL})")
    return {"calls": len(calls), "calls_bit_equal": exact, "flip_rows": flip_rows,
            "max_rel_err": worst}


def int_mm_times(cfg, gen):
    """fc1's int8 product (CUDA events, median of 30) with kernel_q8 as
    stored (column-major) and row-major, beside the bf16 matmul of the same
    shape, each with its bound."""
    m, k, n = 2 * PAIRS * (cfg.num_tokens + N), cfg.hidden_size, cfg.mlp_dim
    a, b = int8_operands(gen, m, k, n)
    b_rows = b.contiguous()
    if not torch.equal(torch._int_mm(a, b_rows), torch._int_mm(a, b)):
        raise AssertionError("_int_mm gives other results for a row-major kernel")
    a16 = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    b16 = torch.randn(k, n, generator=gen).to("cuda", torch.bfloat16)
    ops = 2.0 * m * k * n
    bytes8, bytes16 = m * k + k * n + 4 * m * n, 2 * (m * k + k * n + m * n)
    bound8 = max(ops / INT8_TOPS, bytes8 / HBM_BYTES_PER_S) * 1e3
    bound16 = max(ops / BF16_FLOPS_PER_S, bytes16 / HBM_BYTES_PER_S) * 1e3
    return {"shape": [m, k, n],
            "int_mm_ms": median_ms(lambda: torch._int_mm(a, b)),
            "int_mm_row_major_kernel_ms": median_ms(lambda: torch._int_mm(a, b_rows)),
            "bf16_matmul_ms": median_ms(lambda: a16 @ b16),
            "int_mm_bound_ms": bound8,
            "int_mm_bound_by": "operations" if ops / INT8_TOPS > bytes8 / HBM_BYTES_PER_S
            else "bytes",
            "bf16_bound_ms": bound16,
            "bf16_bound_by": "operations" if ops / BF16_FLOPS_PER_S > bytes16 / HBM_BYTES_PER_S
            else "bytes"}


def dense_launches(holder, x):
    """Device kernels of one dense call (int8: activation quant, product and
    dequant), by torch.profiler."""
    with torch.inference_mode():
        return sampling_launches(lambda: dense(holder, x, torch.bfloat16))


def encoder_weight_bytes(vit, qvit):
    """Bytes of the encoder's weights as the int8 scorer stores them (int8
    kernels, fp32 scales, the rest fp32) beside the same weights in fp32 and
    in bf16; and the quantized kernels alone."""
    total = sum(t.numel() for t in vit.state_dict().values())
    kernels = sum(mod.kernel_q8.numel() for mod in qvit.modules()
                  if isinstance(mod, QuantDense))
    stored = sum(t.numel() * t.element_size() for t in qvit.state_dict().values())
    scales = sum(mod.kernel_scale.numel() * 4 for mod in qvit.modules()
                 if isinstance(mod, QuantDense))
    return {"int8_stored": stored, "fp32": 4 * total, "bf16": 2 * total,
            "quantized_kernels_int8_with_scales": kernels + scales,
            "quantized_kernels_bf16": 2 * kernels, "quantized_kernels_fp32": 4 * kernels,
            "quantized_share_of_weights": kernels / total}


def scoring_flops_per_pair(cfg):
    """Matmul operations of the encoder for one pair (two towers): the
    plausibility bound of the rates (int8 and bf16 alike at the int8 peak)."""
    s, h, m = cfg.num_tokens + N, cfg.hidden_size, cfg.mlp_dim
    layer = 2 * s * (4 * h * h + 2 * h * m) + 4 * s * s * h
    return 2 * (cfg.effective_num_layers * layer + 2 * N * P * P * C * h)


def phase_scorer_int8(card, scorer16, refs, dists):
    """The int8 W8A8 scorer (quantize_int8) beside the bf16 one; see the
    module docstring."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    scorer8 = VTAMIQScorer(seed=SEED, device="cuda", quantize_int8=True)
    cfg = scorer8.cfg.vit
    if quant.count_quantized_leaves(scorer8.params) != 0:
        raise AssertionError("quantize_int8 rewrote the encoder before the first score")
    # the main path: counts reset just before, read just after
    gather_kernel.launches = 0
    quant.launches = 0
    qs8 = scorer8.score_batch(refs, dists)
    launches = {"gather": gather_kernel.launches, "int_mm": quant.launches}
    leaves = quant.count_quantized_leaves(scorer8.params)
    if leaves != INT8_LEAVES:
        raise AssertionError(f"{leaves} quantized leaves, the JAX package's count is "
                             f"{INT8_LEAVES}")
    if not np.isfinite(qs8).all():
        raise AssertionError(f"non-finite int8 scores: {qs8}")
    if launches != {"gather": 1, "int_mm": INT8_LEAVES}:
        raise AssertionError(f"int8 batch launches {launches}: expected one gather and "
                             f"{INT8_LEAVES} int8 products")

    int_mm = int_mm_gates(cfg, gen)

    # card vs CPU in fp32 compute (TF32 off), the same patch draws
    torch.backends.cuda.matmul.allow_tf32 = False
    extract = make_extract_fn(scorer16.sampler, ExtractConfig(
        patch_count=N, patch_dim=P, gather_dtype="float32"))
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs[:2], dists[:2])]))
    patches, pos, _ = extract(raw, torch.Generator().manual_seed(SEED))
    card32 = VTAMIQScorer(seed=SEED, device="cuda", compute_dtype=torch.float32,
                          quantize_int8=True)
    cpu32 = VTAMIQScorer(seed=SEED, device="cpu", compute_dtype=torch.float32,
                         quantize_int8=True)
    for s in (card32, cpu32):
        s._ensure_quantized()
    calls = dense_q8_calls_card_vs_cpu(card32, patches.cuda(), pos.cuda())
    q_cpu, q_card = (VTAMIQScorer(seed=SEED, device=d, compute_dtype=torch.float32,
                                  quantize_int8=True).score_batch(refs[:2], dists[:2])
                     for d in ("cpu", "cuda"))
    q_cpu_fp32 = VTAMIQScorer(seed=SEED, device="cpu", compute_dtype=torch.float32
                              ).score_batch(refs[:2], dists[:2])
    int8_dev = float(np.max(np.abs(q_cpu - q_cpu_fp32)))
    card_dev = float(np.max(np.abs(q_card - q_cpu_fp32)))
    if not card_dev <= INT8_Q_BAND * int8_dev + FP32_Q_TOL:
        raise AssertionError(f"int8 q on the card {card_dev} from the CPU's fp32 q, beyond "
                             f"{INT8_Q_BAND} x the CPU's int8 distance {int8_dev}")
    flat = patches.reshape((-1,) + patches.shape[2:])
    flat_pos = pos.reshape(flat.shape[0], -1, 2)
    with torch.inference_mode():
        t_card = card32.params.vit(flat.cuda(), flat_pos.cuda(),
                                   compute_dtype=torch.float32).cpu()
        t_cpu = cpu32.params.vit(flat, flat_pos, compute_dtype=torch.float32)
    cos_cpu = float((t_card * t_cpu).sum() / (t_card.norm() * t_cpu.norm()))
    if not cos_cpu > INT8_TOKEN_COS:
        raise AssertionError(f"int8 tokens card vs CPU: cosine {cos_cpu} <= {INT8_TOKEN_COS}")
    del card32, cpu32

    # int8 tokens against bf16 tokens on the card, the same fp32 patches
    with torch.inference_mode():
        f16 = scorer16.params.vit(flat.cuda(), flat_pos.cuda(),
                                  compute_dtype=torch.bfloat16).float()
        f8 = scorer8.params.vit(flat.cuda(), flat_pos.cuda(),
                                compute_dtype=torch.bfloat16).float()
    cos = float((f8 * f16).sum() / (f8.norm() * f16.norm()))
    if not cos > INT8_TOKEN_COS:
        raise AssertionError(f"int8 vs bf16 tokens: cosine {cos} <= {INT8_TOKEN_COS}")

    # pairs/s in turns, bf16 first in odd rounds and int8 first in even ones
    bound = INT8_TOPS / scoring_flops_per_pair(cfg)
    for s in (scorer16, scorer8):
        s.score_batch(refs, dists)
    rates = {"bf16": [], "int8": []}
    for r in range(INT8_ROUNDS):
        order = (("bf16", scorer16), ("int8", scorer8))
        for key, s in (order if r % 2 == 0 else order[::-1]):
            rates[key].append(benchharness.timed_stats(
                lambda t, s=s: s.score_batch(refs, dists), PAIRS, bound, trials=3)["median"])
    rate_stats = {k: {"mean": float(np.mean(v)), "std": float(np.std(v)), "min": min(v),
                      "max": max(v), "rounds": v} for k, v in rates.items()}

    activity = {k: sampling_launches(lambda s=s: s.score_batch(refs, dists))
                for k, s in (("bf16", scorer16), ("int8", scorer8))}
    memory = {}  # both models are resident: the batch's own peak is the difference
    for k, s in (("bf16", scorer16), ("int8", scorer8)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        s.score_batch(refs, dists)
        memory[k] = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "batch_peak_above_resident": torch.cuda.max_memory_allocated() - before}
    fc1 = scorer8.params.vit.encoder.layers.layer_0.mlp.fc1
    x = torch.randn(2 * PAIRS * (cfg.num_tokens + N), cfg.hidden_size,
                    generator=gen).to("cuda", torch.bfloat16)
    per_dense = {"int8": dense_launches(fc1, x),
                 "bf16": dense_launches(scorer16.params.vit.encoder.layers.layer_0.mlp.fc1, x)}
    emit({"phase": "scorer_int8", "config": f"ViT-B/16 {cfg.effective_num_layers} layers, "
          f"{cfg.num_extra_tokens} registers, {N} patches of {P}x{P}, {H}x{W}, "
          f"batch {PAIRS}, bf16 compute, encoder W8A8",
          "q": [float(q) for q in qs8], "main_path_launches": launches,
          "quantized_leaves": leaves, "expected_leaves": INT8_LEAVES,
          "int_mm_equal_to_plain": int_mm, "dense_q8_calls_card_vs_cpu": calls,
          "dense_q8_flip_rows_allowed": DENSE_Q8_FLIP_ROWS,
          "dense_q8_rel_tol": DENSE_Q8_REL_TOL,
          "q_int8_cpu_fp32": q_cpu.tolist(), "q_int8_card_fp32": q_card.tolist(),
          "q_cpu_fp32_unquantized": q_cpu_fp32.tolist(),
          "q_int8_card_from_fp32": card_dev, "q_int8_cpu_from_fp32": int8_dev,
          "q_band": INT8_Q_BAND, "tokens_int8_card_vs_cpu_cosine": cos_cpu,
          "tokens_int8_card_vs_cpu_rel_err": float((t_card - t_cpu).norm() / t_cpu.norm()),
          "tokens_int8_vs_bf16_cosine": cos, "tokens_cosine_min": INT8_TOKEN_COS,
          "pairs_per_s": rate_stats, "rounds": INT8_ROUNDS, "trials_per_round": 3,
          "rate_bound_pairs_per_s": bound,
          "device_activity_per_batch": activity, "kernels_per_dense_call": per_dense,
          "dense_calls_per_forward": INT8_LEAVES,
          "encoder_weight_bytes": encoder_weight_bytes(scorer16.params.vit,
                                                       scorer8.params.vit),
          "memory_bytes": memory,
          "fc1_product": int_mm_times(cfg, gen),
          "phase_s": time.perf_counter() - t0, "card": card})
    return launches["gather"]


# ---------------------------------------------------------------------------
# 6. weighted CAPS: BASELINE configs 2 and 3
# ---------------------------------------------------------------------------

CARD = "cuda"
DIFF_REL_TOL = 1e-5    # card vs CPU diff maps in fp32: summation order only
CORNER_TOL = 1e-3      # card vs CPU corners, px, on the same maps and draws
SYNTH_REFS, SYNTH_LEVELS = 4, 2   # x 12 distortion types = 96 graded pairs


def weighted_sampler(diff_type):
    """The weighted-CAPS sampler of BASELINE config 2 (SSIM) and config 3
    (MAGNITUDE), as the JAX package's bench and parity runs build it."""
    return PatchSampler(diff_weight=1.0, uniform_weight=0.1,
                        grid_type=sampling.GRID_TYPE_PERTURBED, diff_type=diff_type)


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def synthetic_graded_set(seed=SEED):
    """96 pairs: 4 procedural references, each under the 12 distortion
    types of the synthetic bank at 2 severities, with the latent quality
    of each as its MOS."""
    rng = np.random.default_rng(seed)
    gains = synth._type_gains(rng, len(synth.DISTORTION_BANK))
    refs, dists, mos = [], [], []
    for _ in range(SYNTH_REFS):
        ref = synth.make_base_image(rng, H, W)
        for t, gain in enumerate(gains):
            for level in range(1, SYNTH_LEVELS + 1):
                refs.append(ref)
                dists.append(synth.apply_distortion(rng, ref, t, level, SYNTH_LEVELS,
                                                    gain).astype(np.float32))
                mos.append(synth.severity_to_quality(rng, level, SYNTH_LEVELS, gain))
    return refs, dists, np.asarray(mos)


def sampling_launches(fn):
    """Device kernels and copies that one call of ``fn`` runs, by
    torch.profiler; None where the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in device)
    return {"kernels": len(device) - copies, "copies": copies}


def phase_weighted_caps(card, refs, dists):
    cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8))
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)]))
    raw_card = raw.to(CARD)
    samplers = {"ssim": weighted_sampler(sampling.DIFF_TYPE_SSIM),
                "magnitude": weighted_sampler(sampling.DIFF_TYPE_MAGNITUDE)}
    _, sh, sw = sampling._cell_layout(H, W, P, N)
    gen = torch.Generator().manual_seed(SEED)
    out = {"phase": "weighted_caps", "config": f"ViT-B/16 6 layers, 8 registers, {N} "
           f"patches, {H}x{W}, batch {PAIRS}; sampler diff weight 1, uniform weight 0.1, "
           f"PERTURBED cells ({sh}x{sw}); config 2 SSIM, config 3 MAGNITUDE",
           "tolerances": {"diff_rel": DIFF_REL_TOL, "corner_px": CORNER_TOL,
                          "fp32_q": FP32_Q_TOL}, "card": card}

    # gates 1 and 2: diff maps, then counts and corners on the card's maps
    gates = {}
    for name, s in samplers.items():
        diff = s.compute_diff(raw_card)
        diff_err = _max_rel(diff.cpu(), s.compute_diff(raw))
        prob = s.sample_prob(H, W, diff)
        draws = sampling.WeightedDraws.stack([sampling.weighted_draws(gen, sh * sw, N)
                                              for _ in range(PAIRS)])
        counts = sampling.weighted_counts(prob, draws.gumbel.to(CARD), H, W, P, N).cpu()
        corners = sampling.weighted_positions(prob, draws.to(CARD), H, W, P, N).cpu()
        prob_cpu = prob.cpu()
        want_counts = sampling.weighted_counts(prob_cpu, draws.gumbel, H, W, P, N)
        want_corners = sampling.weighted_positions(prob_cpu, draws, H, W, P, N)
        gates[name] = {"diff_rel_err": diff_err,
                       "counts_equal": bool(torch.equal(counts, want_counts)),
                       "cells_differing": int((counts != want_counts).sum()),
                       "corner_max_err_px": float((corners - want_corners).abs().max()),
                       "counts_sum": counts.sum(-1).tolist()}
    out["gates"] = gates
    for name, g in gates.items():
        if not (g["diff_rel_err"] <= DIFF_REL_TOL and g["counts_equal"]
                and g["corner_max_err_px"] <= CORNER_TOL):
            emit(out)
            raise AssertionError(f"weighted CAPS card vs CPU ({name}): {g}")

    # gate 3: fp32 q of 2 pairs, card vs CPU, on the same card-sampled corners
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ssim = samplers["ssim"]
    corners = ssim.sample_batch(gen, H, W, P, N, 2, diff=ssim.compute_diff(raw_card[:2]),
                                device=CARD).expand(2, 2, 2, N)
    tile_norm = ((0.5,) * 3, (0.5,) * 3, torch.float32)
    params = init_vtamiq_params(cfg, torch.Generator().manual_seed(SEED))
    q32 = {}
    for dev, x in (("cpu", raw[:2]), (CARD, raw_card[:2])):
        model = copy.deepcopy(params).to(dev)
        patches, pos, scales = get_iqa_patches(x, gen, N, P, ssim, tile_norm=tile_norm,
                                               topleft=[corners.to(dev)])
        with torch.inference_mode():
            q32[dev] = vtamiq_forward(model, cfg, patches, pos, scales,
                                      compute_dtype=torch.float32).cpu()
        del model
    dq = float((q32[CARD] - q32["cpu"]).abs().max())
    out.update({"fp32_q_cpu": q32["cpu"].tolist(), "fp32_q_card": q32[CARD].tolist(),
                "fp32_card_vs_cpu": dq, "tf32": False})
    if not dq <= FP32_Q_TOL:
        emit(out)
        raise AssertionError(f"weighted CAPS fp32 card vs CPU: |dq| {dq} > {FP32_Q_TOL}")

    # the config 2 scorer: the main path, counts reset just before
    scorer_w = VTAMIQScorer(cfg=cfg, seed=SEED, device=CARD, sampler=ssim)
    scorer_u = VTAMIQScorer(cfg=cfg, seed=SEED, device=CARD)
    scorer_w.score_batch(refs, dists)  # warm-up
    gather_kernel.launches = 0
    qs = scorer_w.score_batch(refs, dists)
    launches_w = gather_kernel.launches
    gather_kernel.launches = 0
    scorer_u.score_batch(refs, dists)
    launches_u = gather_kernel.launches
    if not np.isfinite(qs).all() or launches_w != 1:
        emit(out)
        raise AssertionError(f"config 2 scorer: q {qs}, gather launches {launches_w}")
    times = {"weighted": [], "uniform": []}
    for _ in range(10):
        for name, sc in (("uniform", scorer_u), ("weighted", scorer_w)):
            t0 = time.perf_counter()
            sc.score_batch(refs, dists)
            times[name].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in times.items()}

    # the weighted sampling alone, one batch: diff maps, probability maps,
    # draws, allocation and corners
    def sample_batch():
        return ssim.sample_batch(gen, H, W, P, N, PAIRS, diff=ssim.compute_diff(raw_card),
                                 device=CARD)

    host = []
    for i in range(23):
        t0 = time.perf_counter()
        sample_batch()
        torch.cuda.synchronize()
        if i >= 3:
            host.append(time.perf_counter() - t0)
    events_ms = median_ms(sample_batch, 3, 20)
    launches_sampling = sampling_launches(sample_batch)

    # graded synthetic set through the config 2 scorer (random weights)
    srefs, sdists, mos = synthetic_graded_set()
    sq = np.concatenate([scorer_w.score_batch(srefs[i:i + PAIRS], sdists[i:i + PAIRS])
                         for i in range(0, len(srefs), PAIRS)])
    corr = compute_correlations(mos, sq)
    del scorer_w, scorer_u

    # config 3: weighted train step, bf16, batch 8, AdamW(5e-5, wd 0.01)
    model = copy.deepcopy(params).to(CARD)
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01,
                      max_norm=float("inf"))
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    mask = build_freeze_mask(model, False)
    step = make_train_step(cfg, samplers["magnitude"], ExtractConfig(patch_count=N, patch_dim=P),
                           adamw)
    targets = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, PAIRS)
                               .astype(np.float32)).to(CARD)
    model_gen = torch.Generator(device=CARD).manual_seed(SEED)
    lw = (1.0, 1.0, 1.0)
    step(model, state, mask, raw_card, targets, PAIRS, lw, gen, model_gen)  # warm-up
    torch.cuda.synchronize()
    gather_kernel.launches = 0
    per_step, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics, _ = step(model, state, mask, raw_card, targets, PAIRS, lw, gen, model_gen)
        loss = float(metrics["loss"])  # synchronizes
        step_s.append(time.perf_counter() - t0)
        per_step.append({"loss": loss, "grad_norm": float(metrics["grad_norm"])})
    train_launches = gather_kernel.launches
    del model, state, step
    out.update({
        "q_config2": [float(q) for q in qs],
        "gather_launches": {"config2_scorer_batch": launches_w,
                            "uniform_scorer_batch": launches_u,
                            "config3_three_train_steps": train_launches},
        "batch": PAIRS, "batch_s_median": med,
        "pairs_per_s": {"config2_weighted_ssim": PAIRS / med["weighted"],
                        "uniform": PAIRS / med["uniform"]},
        "weighted_sampling_per_batch": {
            "host_ms_median": float(np.median(host)) * 1e3, "cuda_events_ms": events_ms,
            "launches": launches_sampling,
            "what": "compute_diff (SSIM) + sample_batch of 8 items: draws, one copy, "
                    "probability maps, allocation, corners"},
        "synthetic_set": {"pairs": len(srefs), "correlations_vs_synthetic_mos": corr,
                          "note": "random weights: context only"},
        "train": {"steps": per_step, "step_s": step_s,
                  "step_s_median": float(np.median(step_s)),
                  "pairs_per_s": PAIRS / float(np.median(step_s))}})
    emit(out)
    if not all(np.isfinite([s["loss"], s["grad_norm"]]).all() for s in per_step) \
            or train_launches != 3:
        raise AssertionError(f"config 3 train step: {per_step}, gather launches "
                             f"{train_launches}")
    return launches_w, out["train"]["pairs_per_s"]


# ---------------------------------------------------------------------------
# 7. server
# ---------------------------------------------------------------------------

def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _request(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def phase_server(scorer, refs, dists):
    server = ScoringServer(scorer, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=20.0)
    try:
        server.start()
        server.warmup(H, W)
        host, port = server.address
        base = f"http://{host}:{port}"
        gather_kernel.launches = 0
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(_request, f"{base}/score", _npz(ref=refs[i], dist=dists[i]))
                    for i in range(4)]
            scores = [f.result() for f in futs]
        compare = _request(f"{base}/compare",
                           _npz(ref=refs[0], dist_a=dists[0], dist_b=dists[2]))
        health = _request(f"{base}/healthz")
        launches = gather_kernel.launches
    finally:
        server.stop()
    answers = scores + [compare, health]
    ok = (all(code == 200 for code, _ in answers)
          and all(math.isfinite(body["q"]) for _, body in scores)
          and math.isfinite(compare[1]["preference"])
          and health[1]["served"] == 6 and launches > 0)
    emit({"phase": "server", "score": [b["q"] for _, b in scores],
          "compare": compare[1], "healthz": health[1], "gather_launches": launches,
          "answered": sum(code == 200 for code, _ in answers), "sent": len(answers)})
    if not ok:
        raise AssertionError("server phase failed")


# ---------------------------------------------------------------------------
# 4. attention kernels vs plain
# ---------------------------------------------------------------------------

N_LONG = 5000                   # BASELINE config 5: 5000 patches
S_VALID = N_LONG + 9            # + CLS + 8 register tokens
S_PAD = -(-S_VALID // flash_kernel.BLOCK) * flash_kernel.BLOCK   # 5056
ROWS, HEADS, HEAD_DIM = 2 * PAIRS, 12, 64
# kernel vs plain on the same card tensors. fp32: the same math in another
# summation order (online against dense softmax). bf16: both round p and ds
# to bf16, the forward kernel relative to the running maximum and the plain
# version to the row's, and the kernels take exp2 of logits scaled by
# log2(e), so terms differ by up to one bf16 ulp (2^-8).
ATTN_TOL = {torch.float32: dict(out=1e-5, lse=1e-5, grad=1e-4),
            torch.bfloat16: dict(out=2e-2, lse=2e-2, grad=2e-2)}
# what each kernel must compute at least: matmuls of 2*S*S*D flops per
# (row, head), and one exp per logit (the fused backward's function needs 5
# matmuls; its kernels do 7, computing dq apart from dk and dv)
FLASH_MATMULS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
# the CUDA source of each kernel in bf16 (the main path's type) and in fp32:
# one file holds every kernel of a type
FLASH_SOURCE = dict.fromkeys(FLASH_MATMULS, "vtamiq_tpu_torch/csrc/flash_attention_sm90.cu")
FLASH_SOURCE_FP32 = dict.fromkeys(FLASH_MATMULS,
                                  "vtamiq_tpu_torch/csrc/flash_attention_tf32x3.cu")
# the Pallas kernel bodies each CUDA kernel replaces
FLASH_REPLACES = {"flash_fwd": "vtamiq_tpu/ops/attention.py:122",
                  "flash_bwd_fused": "vtamiq_tpu/ops/attention.py:300",
                  "flash_bwd_dq": "vtamiq_tpu/ops/attention.py:226",
                  "flash_bwd_dkv": "vtamiq_tpu/ops/attention.py:260"}


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def attention_inputs(dtype):
    """(B, H, S, D) views of (B, S, H, D) tensors as the model builds them,
    zero past the 5009 valid tokens (the padding), keys masked there; and
    the backward's do, lse and delta from the plain forward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mask = torch.zeros(ROWS, S_PAD, dtype=torch.bool, device="cuda")
    mask[:, :S_VALID] = True
    ts = []
    for _ in range(4):
        t = torch.randn(ROWS, S_PAD, HEADS, HEAD_DIM, generator=gen, device="cuda")
        t[:, S_VALID:] = 0
        ts.append(t.to(dtype).transpose(1, 2))
    q, k, v, do = ts
    out, lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    return q, k, v, do, mask, lse, flash_kernel.delta_of(do, out)


def flash_bound_ms(name, q, mask, flops_per_s=BF16_FLOPS_PER_S):
    """Least time for a flash kernel at these inputs: its matmuls over the
    valid queries and keys at ``flops_per_s`` (the bf16 tensor-core rate for
    bf16; the 3xTF32 rate for fp32), or its exps at the special-function
    rate, or its bytes (each input read once, each output written once) at
    the memory rate, whichever is largest."""
    n = int(mask[0].sum())
    pairs = ROWS * HEADS * n * n
    flops = FLASH_MATMULS[name] * 2 * pairs * HEAD_DIM
    tile = q.numel() * q.element_size()
    vec = ROWS * HEADS * S_PAD * 4
    nbytes = {"flash_fwd": 4 * tile + vec,
              "flash_bwd_fused": 7 * tile + 2 * vec,
              "flash_bwd_dq": 5 * tile + 2 * vec,
              "flash_bwd_dkv": 6 * tile + 2 * vec}[name] + mask.numel()
    times = {"operations": max(flops / flops_per_s, pairs / SFU_PER_S) * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, {"flops": flops, "exps": pairs, "bytes": nbytes}


def _max_abs(got, want):
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))


def _sdpa_backend(dtype):
    """fp32 SDPA held to its memory-efficient kernel (the math fallback
    would hold the (16, 12, 5056, 5056) fp32 probabilities, 19.6 GB); bf16
    as PyTorch chooses."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION])


def time_attention(dtype):
    """Kernel, plain and library times at the main shapes in ``dtype``; for
    fp32 also SDPA's backend and its error against the plain version."""
    q, k, v, do, mask, lse, delta = attention_inputs(dtype)
    bwd_args = (q, k, v, do, lse, delta, mask)
    ms = {"flash_fwd": median_ms(lambda: flash_kernel.flash_forward(q, k, v, mask), 2, 5),
          "flash_bwd_fused": median_ms(lambda: flash_kernel.flash_backward_fused(*bwd_args), 2, 5),
          "flash_bwd_dq": median_ms(lambda: flash_kernel.flash_backward_dq(*bwd_args), 2, 5),
          "flash_bwd_dkv": median_ms(lambda: flash_kernel.flash_backward_dkv(*bwd_args), 2, 5)}
    plain_fwd = median_ms(lambda: flash_kernel.flash_forward_plain(q, k, v, mask), 1, 3)
    plain_bwd = median_ms(lambda: flash_kernel.flash_backward_plain(*bwd_args), 1, 3)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_fused": plain_bwd,
             "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    # the library yardstick: scaled_dot_product_attention with the boolean
    # key mask; forward alone (no grad), and its backward alone (one
    # autograd call over a saved forward; it computes dq, dk and dv)
    attn_mask = mask[:, None, None, :]
    with torch.no_grad(), _sdpa_backend(dtype):
        sdpa_fwd = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask),
                             2, 5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    with _sdpa_backend(dtype):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)
    sdpa_bwd = median_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                         2, 5)
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_fused": sdpa_bwd,
               "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    sdpa = {"backward_node": out.grad_fn.name()}
    if dtype == torch.float32:  # is the library time an fp32-accurate one?
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        out_p, _ = flash_kernel.flash_forward_plain(q, k, v, mask)
        grads_p = flash_kernel.flash_backward_plain(*bwd_args)
        sdpa.update({"out_rel_vs_plain": rel_err(out.detach(), out_p),
                     "grad_rel_vs_plain": [rel_err(a, b) for a, b in zip(grads, grads_p)]})
        del grads, out_p, grads_p
    del out, qg, kg, vg
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else TF32X3_FLOPS_PER_S
    table = {}
    for name in FLASH_MATMULS:
        bound, by, work = flash_bound_ms(name, q, mask, rate)
        table[name] = {"ms": ms[name], "plain_ms": plain[name], "library_ms": library[name],
                       "bound_ms": bound, "bound_by": by, "work": work}
        if dtype == torch.float32:  # the same matmuls at the FFMA rate
            table[name]["bound_ms_ffma"] = flash_bound_ms(name, q, mask, FP32_FLOPS_PER_S)[0]
    return table, sdpa


def phase_attention(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, tables, sdpa = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        name = str(dtype).replace("torch.", "")
        q, k, v, do, mask, lse, delta = attention_inputs(dtype)
        out_k, lse_k = flash_kernel.flash_forward(q, k, v, mask)
        fused = flash_kernel.flash_backward_fused(q, k, v, do, lse, delta, mask)
        dq = flash_kernel.flash_backward_dq(q, k, v, do, lse, delta, mask)
        dk, dv = flash_kernel.flash_backward_dkv(q, k, v, do, lse, delta, mask)
        split = (dq, dk, dv)
        torch.cuda.synchronize()
        out_p, _ = flash_kernel.flash_forward_plain(q, k, v, mask)
        grads_p = flash_kernel.flash_backward_plain(q, k, v, do, lse, delta, mask)
        r = {"out_rel": rel_err(out_k, out_p),
             "lse_abs": float((lse_k - lse).abs().max()),
             "fused_rel": [rel_err(a, b) for a, b in zip(fused, grads_p)],
             "split_rel": [rel_err(a, b) for a, b in zip(split, grads_p)]}
        results[name] = r
        errs = {"flash_fwd": _max_abs((out_k,), (out_p,)),
                "flash_bwd_fused": _max_abs(fused, grads_p),
                "flash_bwd_dq": _max_abs(split[:1], grads_p[:1]),
                "flash_bwd_dkv": _max_abs(split[1:], grads_p[1:])}
        ok = (r["out_rel"] <= tol["out"] and r["lse_abs"] <= tol["lse"] * max(
            1.0, float(lse.abs().max())) and max(r["fused_rel"] + r["split_rel"]) <= tol["grad"])
        if not ok:
            emit({"phase": "attention", "results": results})
            raise AssertionError(f"flash kernels != plain versions in {name}: {r}")
        # the fused backward again on the same inputs: the same bits
        again = flash_kernel.flash_backward_fused(q, k, v, do, lse, delta, mask)
        torch.cuda.synchronize()
        r["fused_bitwise_repeatable"] = [torch.equal(a, b) for a, b in zip(fused, again)]
        if not all(r["fused_bitwise_repeatable"]):
            emit({"phase": "attention", "results": results})
            raise AssertionError(f"fused backward not deterministic in {name}: dq, dk, dv "
                                 f"equal {r['fused_bitwise_repeatable']}")
        # the split backward runs the fused backward's two kernels: the same bits
        r["split_bitwise_equals_fused"] = [torch.equal(a, b) for a, b in zip(split, fused)]
        if not all(r["split_bitwise_equals_fused"]):
            emit({"phase": "attention", "results": results})
            raise AssertionError(f"split backward != fused backward in {name}: dq, dk, dv "
                                 f"equal {r['split_bitwise_equals_fused']}")
        del q, k, v, do, mask, lse, delta, out_k, lse_k, fused, again, split, dq, dk, dv
        del out_p, grads_p
        tables[name], sdpa[name] = time_attention(dtype)
        for kname, err in errs.items():
            tables[name][kname]["max_abs_err"] = err
    emit({"phase": "attention", "shape": f"q, k, v ({ROWS}, {HEADS}, {S_PAD}, {HEAD_DIM}) "
          f"views of (B, S, H, D), {S_VALID} valid keys", "results": results,
          "tolerances": {str(d).replace("torch.", ""): t for d, t in ATTN_TOL.items()},
          "tf32": False, "float32": tables["float32"], "bfloat16": tables["bfloat16"],
          "library_call": "torch.nn.functional.scaled_dot_product_attention, bool mask "
          "(fp32: memory-efficient backend only); backward: torch.autograd.grad over a "
          "saved forward", "sdpa": sdpa, "card": card})
    return tables


# ---------------------------------------------------------------------------
# 8. scorer at 5000 patches
# ---------------------------------------------------------------------------

FP32_LONG_Q_TOL = 1e-3   # flash vs quadratic in fp32: summation order only


def phase_scorer_5000p(card, refs, dists):
    scorer = VTAMIQScorer(seed=SEED, device="cuda", patch_count=N_LONG)
    scorer.score_batch(refs, dists)  # warm-up
    # the main path: counts reset just before, read just after
    flash_kernel.reset_launches()
    gather_kernel.launches = 0
    qs = scorer.score_batch(refs, dists)
    launches = {"gather": gather_kernel.launches, **flash_kernel.launches}
    expected = {"gather": 1, "flash_fwd": scorer.cfg.vit.effective_num_layers - 1,
                "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if not np.isfinite(qs).all():
        raise AssertionError(f"non-finite 5000-patch scores: {qs}")
    if launches != expected:
        raise AssertionError(f"5000-patch scorer launches {launches}, expected {expected}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        scorer.score_batch(refs, dists)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    del scorer

    # fp32, TF32 off: flash against the quadratic forward on the same patches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s32 = VTAMIQScorer(seed=SEED, device="cuda", patch_count=N_LONG,
                       compute_dtype=torch.float32)
    extract = make_extract_fn(s32.sampler, ExtractConfig(patch_count=N_LONG, patch_dim=P,
                                                         gather_dtype="float32"))
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs[:2], dists[:2])]))
    patches, pos, scales = extract(raw.cuda(), torch.Generator().manual_seed(SEED))

    def forward(attention_fn):
        with torch.inference_mode():
            return vtamiq_forward(s32.params, s32.cfg, patches, pos, scales,
                                  compute_dtype=torch.float32, attention_fn=attention_fn)

    q_flash, q_quad = forward(make_attention_fn()), forward(None)
    dq = float((q_flash - q_quad).abs().max())
    # the fp32 forward at batch 2, timed: 3 calls each way, the flash
    # forward's launches counted in the 3 flash calls
    flash_kernel.reset_launches()
    flash_s = median_ms(lambda: forward(make_attention_fn()), 0, 3) / 1e3
    fp32_launches = dict(flash_kernel.launches)
    quad_s = median_ms(lambda: forward(None), 0, 3) / 1e3
    emit({"phase": "scorer_5000p", "config": f"ViT-B/16 6 layers, 8 registers, {N_LONG} "
          f"patches of 16x16, {H}x{W}, bf16", "q": [float(q) for q in qs],
          "launches": launches, "expected_launches": expected, "batch": PAIRS,
          "batch_s_median": med, "pairs_per_s": PAIRS / med,
          "fp32_flash_vs_quadratic": dq, "fp32_tol": FP32_LONG_Q_TOL,
          "q_fp32_flash": q_flash.tolist(), "q_fp32_quadratic": q_quad.tolist(),
          "fp32_batch": 2, "fp32_forward_s_flash": flash_s, "fp32_forward_s_quadratic": quad_s,
          "fp32_launches_in_3_flash_calls": fp32_launches, "card": card})
    if not dq <= FP32_LONG_Q_TOL:
        raise AssertionError(f"fp32 flash vs quadratic forward: |dq| {dq} > {FP32_LONG_Q_TOL}")
    return launches, fp32_launches


# ---------------------------------------------------------------------------
# 9. train step at 5000 patches
# ---------------------------------------------------------------------------

# fp32 checks at batch 2, TF32 off, flash attention against plain.
# 1. Whole train steps (SGD, learning rate 1, no momentum, no clipping, so a
#    step moves each parameter by minus its gradient): the loss is MAE alone
#    against targets far above every score, so its gradient in q is exactly
#    -1/B in every run, and the pairs are two unrelated images (the
#    references of two different pairs). The loss is held to 1e-5 and the
#    fused and split backward's gradient norms to 1e-4 of each other. The
#    step's gradient against the plain step's is reported, not held: the
#    DiffNet head is piecewise linear (ReLU, PReLU), so an input that moves
#    by fp32 rounding can move its gradient by far more (H100 runs: the
#    step's gradients 5.6e-3 apart, while the encoder's below, through
#    smooth functions only, agree to 3e-6).
# 2. The encoder alone, where every function is smooth: the gradient of a
#    fixed random projection of its output tokens, through flash and through
#    plain attention, each tensor within 1e-3 of its norm. The key
#    projection's bias gets no gradient in exact arithmetic (softmax ignores
#    a shift shared by a query's logits), so its gradient is rounding noise
#    in both runs: held to 1e-6 of the whole gradient's norm instead.
SPLIT_NORM_TOL = 1e-4    # fused vs split backward: the same kernels, equal in exact runs
PLAIN_LOSS_TOL = 1e-5    # flash vs plain attention, fp32
ENCODER_GRAD_TOL = 1e-3  # flash vs plain, each encoder tensor, relative
KEY_BIAS_TOL = 1e-6      # key biases, of the whole encoder gradient's norm
FAR_TARGET = 10.0        # MAE targets, far above the model's scores


def _flash_counts():
    return dict(flash_kernel.launches)


def phase_train_5000p(card, refs, dists):
    cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8))  # the scorer's
    base = init_vtamiq_params(cfg, torch.Generator().manual_seed(SEED))
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)])).cuda()
    qs = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, PAIRS).astype(np.float32)
                          ).cuda()
    lw = (1.0, 1.0, 1.0)
    ecfg = ExtractConfig(patch_count=N_LONG, patch_dim=P)

    # bf16, batch 8, AdamW(5e-5, wd 0.01) without clipping, as bench.py runs it
    model = copy.deepcopy(base).cuda()
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01,
                      max_norm=float("inf"))
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    mask = build_freeze_mask(model, False)
    step = make_train_step(cfg, PatchSampler(), ecfg, adamw)
    sample_gen = torch.Generator().manual_seed(SEED)
    model_gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(model, state, mask, raw, qs, PAIRS, lw, sample_gen, model_gen)  # warm-up
    torch.cuda.synchronize()
    # the main path: counts reset just before, read just after
    flash_kernel.reset_launches()
    gather_kernel.launches = 0
    per_step, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        metrics, _ = step(model, state, mask, raw, qs, PAIRS, lw, sample_gen, model_gen)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # synchronizes
        times.append(time.perf_counter() - t0)
        per_step.append({"loss": loss, "grad_norm": gnorm})
    launches = {"gather": gather_kernel.launches, **_flash_counts()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers = cfg.vit.effective_num_layers - 1
    expected = {"gather": 3, "flash_fwd": 3 * layers, "flash_bwd_fused": 3 * layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != expected:
        raise AssertionError(f"train step launches {launches}, expected {expected}")
    if not all(np.isfinite([s["loss"], s["grad_norm"]]).all() for s in per_step):
        raise AssertionError(f"non-finite train metrics: {per_step}")

    # the split backward (dq and dkv kernels), one step
    split = make_train_step(cfg, PatchSampler(), ecfg, adamw,
                            attention_fn=make_attention_fn(fused_bwd=False))
    flash_kernel.reset_launches()
    t0 = time.perf_counter()
    metrics, _ = split(model, state, mask, raw, qs, PAIRS, lw, sample_gen, model_gen)
    split_loss = float(metrics["loss"])  # synchronizes
    split_s = time.perf_counter() - t0
    split_launches = _flash_counts()
    split_expected = {"flash_fwd": layers, "flash_bwd_fused": 0, "flash_bwd_dq": layers,
                      "flash_bwd_dkv": layers}
    if split_launches != split_expected or not np.isfinite(split_loss):
        raise AssertionError(f"split train step launches {split_launches}, expected "
                             f"{split_expected}; loss {split_loss}")
    del model, state, step, split
    remat = remat_compare(cfg, base, raw, qs)

    # fp32, batch 2, TF32 off: fused vs split backward, flash vs plain attention
    unrelated = torch.stack([raw[0:4:2, 0], raw[1:4:2, 0]], dim=1)  # (2, 2, H, W, 3)
    checks = fp32_checks(cfg, base, unrelated)
    emit({"phase": "train_5000p", "config": f"ViT-B/16 6 layers, 8 registers, {N_LONG} "
          f"patches, {H}x{W}, bf16, batch {PAIRS}, AdamW(5e-5, wd 0.01), loss weights "
          f"{lw}", "steps": per_step, "step_s": times, "step_s_median": float(np.median(times)),
          "pairs_per_s": PAIRS / float(np.median(times)), "launches": launches,
          "expected_launches": expected, "split_launches": split_launches,
          "split_step_s": split_s,
          "peak_memory_gb": peak_gb, "remat": {k: v for k, v in remat.items() if k != "grads"},
          **checks, "card": card})
    if not remat["gradients_equal"]:
        raise AssertionError(f"remat vs plain gradients differ: {remat['differing']}")
    if not checks["fused_vs_split_grad_norm_rel"] <= SPLIT_NORM_TOL:
        raise AssertionError(f"fused vs split backward grad norm: {checks}")
    if not (checks["flash_vs_plain_loss_rel"] <= PLAIN_LOSS_TOL
            and checks["encoder_grad_rel_max"] <= ENCODER_GRAD_TOL
            and checks["encoder_key_bias_err_of_total"] <= KEY_BIAS_TOL):
        raise AssertionError(f"flash vs plain in fp32: {checks}")
    return launches, split_launches, checks["fp32_flash_launches"], remat["with_remat"]["launches"]


def remat_compare(cfg, base, raw, qs):
    """One bf16 forward and backward at 5000 patches with DropPath active
    (p 0.1), without and with remat, on the same patches and DropPath
    draws: step ms (the second of two calls), peak memory, flash launches,
    and every gradient held equal (torch.equal)."""
    dp = dataclasses.replace(cfg.vit, vit_path_drop_active=True)
    extract = make_extract_fn(PatchSampler(), ExtractConfig(patch_count=N_LONG, patch_dim=P))
    patches, pos, scales = extract(raw, torch.Generator().manual_seed(SEED + 2))
    attention_fn = make_attention_fn()
    runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, vit=dataclasses.replace(dp, remat=remat))
        model = copy.deepcopy(base).to(CARD)
        for _ in range(2):  # the first call warms up; the second is reported
            for prm in model.parameters():
                prm.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_kernel.reset_launches()
            gather_kernel.launches = 0
            t0 = time.perf_counter()
            q = vtamiq_forward(model, c, patches, pos, scales, train=True,
                               generator=torch.Generator(device=CARD).manual_seed(SEED),
                               attention_fn=attention_fn)
            loss, _ = loss_func_iqa(q, qs, 1.0, 1.0, 1.0, weighted=True)
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        runs[remat] = {"ms": ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {"gather": gather_kernel.launches, **_flash_counts()},
                       "loss": float(loss.detach()),
                       "grads": {n: prm.grad for n, prm in model.named_parameters()}}
        del model
    g0, g1 = runs[False].pop("grads"), runs[True].pop("grads")
    differing = [n for n in g0 if (g0[n] is None) != (g1[n] is None)
                 or (g0[n] is not None and not torch.equal(g0[n], g1[n]))]
    return {"what": f"bf16 forward + backward, batch {PAIRS}, {N_LONG} patches, DropPath "
                    f"active (p {cfg.vit.path_drop_prob}), rank + pears + MAE loss",
            "without_remat": runs[False], "with_remat": runs[True],
            "gradients_equal": not differing, "differing": differing[:5],
            "gradient_tensors": len(g0)}


def fp32_checks(cfg, base, raw):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extract = make_extract_fn(PatchSampler(), ExtractConfig(patch_count=N_LONG, patch_dim=P,
                                                            gather_dtype="float32"))
    patches, pos, scales = extract(raw, torch.Generator().manual_seed(SEED + 1))
    b = raw.shape[0]
    targets = torch.full((b,), FAR_TARGET, device=raw.device)
    flash, split = make_attention_fn(), make_attention_fn(fused_bwd=False)

    steps, launches = {}, {}
    for name, attention_fn in (("fused", flash), ("split", split), ("plain", None)):
        flash_kernel.reset_launches()
        model = copy.deepcopy(base).cuda()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        sgd = Optimizer("SGD", lambda count: torch.tensor(1.0), max_norm=float("inf"))
        step = make_train_step_on_patches(cfg, sgd, weighted_loss=True,
                                          compute_dtype=torch.float32,
                                          attention_fn=attention_fn)
        metrics, q = step(model, sgd.init(before), build_freeze_mask(model, False), patches,
                          pos, scales, targets, b, (1.0, 0.0, 0.0))
        if not bool((q < FAR_TARGET).all()):
            raise AssertionError(f"a score {q.tolist()} reached the MAE target {FAR_TARGET}")
        steps[name] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "delta": torch.cat([(p.detach() - before[n]).reshape(-1)
                                           for n, p in model.named_parameters()])}
        launches[f"{name}_step"] = _flash_counts()
        del model, before
    f, s, p = steps["fused"], steps["split"], steps["plain"]

    # the encoder alone: a fixed random projection of its output tokens
    vit = copy.deepcopy(base.vit).cuda()
    flat = (patches.flatten(0, 1), pos.flatten(0, 1),
            None if scales is None else scales.flatten(0, 1))
    proj = None
    grads = {}
    for name, attention_fn in (("flash", flash), ("plain", None)):
        flash_kernel.reset_launches()
        tokens = vit(*flat, compute_dtype=torch.float32, train=True, attention_fn=attention_fn)
        if proj is None:
            proj = torch.randn(tokens.shape, device=tokens.device,
                               generator=torch.Generator(device=tokens.device).manual_seed(SEED))
        named = dict(vit.named_parameters())
        grads[name] = dict(zip(named, torch.autograd.grad((tokens * proj).sum(),
                                                          list(named.values()))))
        launches[f"encoder_{name}"] = _flash_counts()
    total = float(torch.sqrt(sum(g.norm() ** 2 for g in grads["plain"].values())))
    rel = {n: float((grads["flash"][n] - g).norm() / g.norm())
           for n, g in grads["plain"].items() if not n.endswith("attn.key.bias")}
    key_bias = max(float((grads["flash"][n] - g).norm()) / total
                   for n, g in grads["plain"].items() if n.endswith("attn.key.bias"))
    worst = max(rel, key=rel.get)
    return {"fp32_batch": b,
            "step_pairs": "two unrelated images each, MAE against a far target",
            "fused_vs_split_grad_norm_rel": abs(f["grad_norm"] - s["grad_norm"]) / s["grad_norm"],
            "flash_vs_plain_loss_rel": abs(f["loss"] - p["loss"]) / abs(p["loss"]),
            "flash_vs_plain_step_grad_rel": float((f["delta"] - p["delta"]).norm()
                                                  / p["delta"].norm()),
            "fp32_loss": {k: v["loss"] for k, v in steps.items()},
            "fp32_grad_norm": {k: v["grad_norm"] for k, v in steps.items()},
            "encoder_grad_rel_max": rel[worst], "encoder_worst_tensor": worst,
            "encoder_key_bias_err_of_total": key_bias, "fp32_flash_launches": launches}


# ---------------------------------------------------------------------------
# 11. engine_config3, 12. engine_config5: engine.train() from image files
# ---------------------------------------------------------------------------

CONFIG3_TYPES = 20           # 20 distortion types x 5 levels = 100 pairs a reference
CONFIG3_TRAIN_REFS, CONFIG3_VAL_REFS = [0, 1, 2], [3]   # 300 train pairs, 100 val
LIVE_REAL_PER_DIR = 12       # 5 dirs x 12 = 60 LIVE pairs over all 29 references


def _writer_calls(root, png):
    """One dataset tree per process, written by the port's synth writers."""
    train3 = (f"generate_kadid10k({root!r} + '/kadid10k', num_types={CONFIG3_TYPES}, "
              "image_refs=4)" if png else
              f"generate_tid2013({root!r} + '/train3/tid2013', num_types={CONFIG3_TYPES}, "
              "image_refs=4)")
    calls = {"train3": train3,
             "test3": f"generate_tid2013({root!r} + '/tid2013', image_refs=1)",
             "pipal": f"generate_pipal({root!r} + '/PIPAL', image_refs=1)",
             "live": f"generate_live({root!r} + '/LIVE', per_dir_real={LIVE_REAL_PER_DIR})"}
    if png:
        calls["csiq"] = f"generate_csiq({root!r} + '/CSIQ', image_refs=1)"
    calls["pieapp"] = (f"generate_pieapp({root!r} + '/PieAPP_dataset', "
                       f"train_refs={PIEAPP_REFS}, pairs_per_ref={PIEAPP_PAIRS_PER_REF}, "
                       "test_refs=1, test_dist=1, image_refs=None, image_test_refs=0)")
    calls["vit_npz"] = f"write_vit_npz({root!r} + '/ViT-B_16.npz', seed={SEED})"
    return calls


def start_dataset_writers(root, png):
    """Start writing the engine phases' datasets, one process per tree."""
    here = os.path.dirname(os.path.abspath(__file__))
    return {name: subprocess.Popen(
        [sys.executable, "-c", f"from vtamiq_tpu_torch.data import synth; synth.{call}"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, call in _writer_calls(root, png).items()}


def wait_dataset_writers(writers):
    t0 = time.perf_counter()
    for name, proc in writers.items():
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"dataset writer {name} failed ({proc.returncode}):\n{out}")
    return time.perf_counter() - t0


def _subclass(base, root, **attrs):
    def __init__(self, **kwargs):
        kwargs.setdefault("datasets_root", root)
        base.__init__(self, **kwargs)
    return type(base.__name__, (base,), {"__init__": __init__, **attrs})


@contextlib.contextmanager
def engine_configs():
    """The engine's module-level config dicts, restored afterwards."""
    C = engine_config
    names = ("global_config", "vit_config", "vtamiq_config", "dataset_config_base",
             "dataloader_config_base")
    snaps = {n: copy.deepcopy(getattr(C, n)) for n in names}
    registry = dict(C._DATASET_REGISTRY)
    try:
        yield C
    finally:
        for n, v in snaps.items():
            getattr(C, n).clear()
            getattr(C, n).update(v)
        C._DATASET_REGISTRY.clear()
        C._DATASET_REGISTRY.update(registry)


def _set_loaders(C, batch, patches):
    C.dataloader_config_base[C.DATALOADER_PARAMS][C.USE_DEFAULT_PARAMS] = True
    for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
        C.dataloader_config_base[split].update({C.BATCH_SIZE: batch, C.PATCH_COUNT: patches})


def _rate(stats):
    pairs = sum(s["pairs"] for s in stats)
    seconds = sum(s["seconds"] for s in stats)
    return {"pairs": pairs, "batches": sum(s["batches"] for s in stats), "seconds": seconds,
            "pairs_per_s": pairs / seconds,
            "decode_ms_per_batch": 1e3 * sum(s["decode_seconds"] for s in stats)
            / max(1, sum(s["batches"] for s in stats)),
            "wait_ms_per_batch": 1e3 * sum(s["wait_seconds"] for s in stats)
            / max(1, sum(s["batches"] for s in stats))}


def device_idle_share(fn):
    """Run ``fn`` under torch.profiler, tracing device activity only; the
    share of the window from the first kernel or copy to the last in which
    none ran (None where the profiler records no device activity), and the
    count of device activities."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not spans:
        return result, None, 0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return result, 1.0 - busy / window, len(spans)


def phase_engine_config3(card, root, png, bare_pairs_per_s):
    """BASELINE config 3 through engine.train(): ViT-B/16 6 layers, 8
    registers, DiffNet head, 500 patches, weighted CAPS (MAGNITUDE), batch
    8, AdamW, bf16; train on 300 pairs of the KADID-10k layout (TID2013
    layout without libpng), val on 100, test on 120 TID2013-layout pairs."""
    t0 = time.perf_counter()
    with engine_configs() as C:
        layout = "KADID-10k (PNG)" if png else "TID2013 (BMP; the build decodes no PNG)"
        train_cls = (_subclass(datasets.KADID10kDataset, root, num_dist_images=5 * CONFIG3_TYPES)
                     if png else
                     _subclass(datasets.TID2013Dataset, f"{root}/train3",
                               num_dist_images=5 * CONFIG3_TYPES))
        C._DATASET_REGISTRY[C.DATASET_KADID10K] = (train_cls, C.setup_split_config(
            CONFIG3_TRAIN_REFS, CONFIG3_VAL_REFS, CONFIG3_VAL_REFS))
        C._DATASET_REGISTRY[C.DATASET_TID2013] = (_subclass(datasets.TID2013Dataset, root),
                                                  C.setup_split_config([0], [0], [0]))
        g = C.global_config
        g.update(dataset=C.DATASET_KADID10K, dataset_test=C.DATASET_TID2013, device=CARD,
                 do_train=True, do_val=True, do_test=True, is_debug=False, num_epochs=1,
                 seed=SEED, compute_dtype="bfloat16", optimizer="AdamW",
                 save_optimizer=True, allow_use_full_dataset=False,
                 allow_use_full_dataset_test=False, output_dir=f"{root}/out3",
                 is_verbose=False, config_validated=False)
        C.dataset_config_base["patch_sampler_config"] = dict(
            diff_weight=1.0, uniform_weight=0.1, grid_type=sampling.GRID_TYPE_PERTURBED,
            diff_type=sampling.DIFF_TYPE_MAGNITUDE)
        _set_loaders(C, PAIRS, N)

        trained = {}
        do_training = engine.do_training

        def capture(*args, **kwargs):  # the trained model, as do_training returns it
            result = do_training(*args, **kwargs)
            trained.update({n: p.detach().float().cpu().clone()
                            for n, p in result[0].named_parameters()})
            return result

        gather_kernel.launches = 0
        engine.do_training = capture
        try:
            test = engine.train()
        finally:
            engine.do_training = do_training
        launches = gather_kernel.launches
        stats = {k: list(v) for k, v in engine.last_run_stats.items()}
        out_dir = g["output_dir_final"]
        files = sorted(os.listdir(out_dir))

        # resume from latest.npz for one more epoch, train only, profiled
        latest = os.path.join(out_dir, "latest.npz")
        first = load_checkpoint(latest)
        g.update(resume_checkpoint_file=latest, num_epochs=2, do_val=False, do_test=False,
                 config_validated=False)
        t1 = time.perf_counter()
        _, idle, device_events = device_idle_share(engine.train)
        profiled_s = time.perf_counter() - t1
        resume_stats = list(engine.last_run_stats["train"])
        resumed = load_checkpoint(os.path.join(g["output_dir_final"], "latest.npz"))

    best = load_checkpoint(os.path.join(out_dir, "best.npz"))[engine_config.MODEL_STATE_DICT]
    best_equal = sorted(best) == sorted(k.replace(".", "|") for k in trained) and all(
        torch.equal(torch.from_numpy(best[k.replace(".", "|")]), v) for k, v in trained.items())
    steps = sum(s["batches"] for phase in stats.values() for s in phase)
    train_steps = stats["train"][0]["batches"]
    want_files = {"latest.npz", "best.npz", "config.yaml", "model_config.yaml",
                  "pretraining_config.yaml", "dataset_config_base.yaml",
                  "dataloader_config_base.yaml", "model_params.txt", "output.txt",
                  "output_qs.txt", "scalars.jsonl", "source_code"}
    gates = {
        "files_written": want_files <= set(files),
        "best_npz_equals_trained_model": best_equal,
        "resume_starts_at_epoch_2": [s["epoch"] for s in resume_stats] == [2],
        "resume_carries_step_count": int(first[OPT_LEAVES][0]) == train_steps
        and int(resumed[OPT_LEAVES][0]) == 2 * train_steps,
        "test_srocc_finite": bool(np.isfinite(test["SROCC"])),
        "gather_one_launch_per_step": launches == steps,
        "no_pil_yaml_tensorboardx_imported": not any(
            m in sys.modules for m in ("PIL", "yaml", "tensorboardX")),
    }
    train = _rate(stats["train"])
    out = {"phase": "engine_config3", "card": card,
           "config": f"BASELINE config 3 through engine.train(): ViT-B/16 6 layers, 8 "
                     f"registers, DiffNet head, {N} patches, weighted CAPS (MAGNITUDE), "
                     f"batch {PAIRS}, AdamW, bf16, seeded random weights",
           "data": {"train_layout": layout, "train_pairs": train["pairs"],
                    "val_pairs": _rate(stats["val"])["pairs"],
                    "test_layout": "TID2013 (BMP)", "test_pairs_per_repeat":
                    stats["test"][0]["pairs"], "test_repeats": len(stats["test"]),
                    "cut": f"{CONFIG3_TYPES} distortion types x 5 levels on references "
                           f"{CONFIG3_TRAIN_REFS} (train) and {CONFIG3_VAL_REFS} (val) of "
                           "the 81, one epoch; test on reference 0 of TID2013's 25"},
           "train": train, "bare_step_pairs_per_s": bare_pairs_per_s,
           "engine_over_bare": train["pairs_per_s"] / bare_pairs_per_s,
           "val": _rate(stats["val"]), "test": _rate(stats["test"]),
           "resumed_epoch": {**_rate(resume_stats), "profiled": True,
                             "device_idle_share": idle, "device_events": device_events,
                             "train_call_s_with_profiler": profiled_s},
           "phase_s": time.perf_counter() - t0,
           "gather_launches": launches, "steps": steps,
           "gather_launches_per_step": launches / steps,
           "test_correlations": test, "files": files, "gates": gates}
    emit(out)
    if not all(gates.values()):
        raise AssertionError(f"engine_config3 gates failed: {gates}")
    return out


def phase_engine_config5(card, root, png):
    """BASELINE config 5 through engine.train() at 5000 patches, bf16, batch
    8: train on the PIPAL layout (288x288), test on the LIVE layout (sizes
    vary: canonical buckets with img_hw), then a test-only run on the CSIQ
    layout from the trained checkpoint."""
    with engine_configs() as C:
        C._DATASET_REGISTRY[C.DATASET_PIPAL] = (_subclass(datasets.PIPAL, root),
                                                C.setup_split_config([0], 0, 0))
        C._DATASET_REGISTRY[C.DATASET_LIVE] = (_subclass(datasets.LIVEDataset, root),
                                               C.setup_split_config(0, 0, 29))
        C._DATASET_REGISTRY[C.DATASET_CSIQ] = (_subclass(datasets.CSIQDataset, root),
                                               C.setup_split_config(0, 0, [0]))
        layers_fwd = C.build_model_config().vit.effective_num_layers - 1  # last: CLS only
        g = C.global_config
        g.update(dataset=C.DATASET_PIPAL, dataset_test=C.DATASET_LIVE, device=CARD,
                 do_train=True, do_val=False, do_test=True, is_debug=False, num_epochs=1,
                 seed=SEED, compute_dtype="bfloat16", optimizer="AdamW",
                 allow_use_full_dataset=False, allow_use_full_dataset_test=False,
                 max_size_buckets=2, num_repeats_test=1, output_dir=f"{root}/out5",
                 is_verbose=False, config_validated=False)
        _set_loaders(C, PAIRS, N_LONG)
        flash_kernel.reset_launches()
        live = engine.train()
        live_flash = _flash_counts()
        stats = {k: list(v) for k, v in engine.last_run_stats.items()}
        runs = {"live": {"correlations": live, "test": _rate(stats["test"])}}
        total = dict(live_flash)
        if png:
            flash_kernel.reset_launches()
            g.update(dataset_test=C.DATASET_CSIQ, do_train=False, config_validated=False,
                     load_checkpoint_file=os.path.join(g["output_dir_final"], "latest.npz"))
            csiq = engine.train()
            csiq_flash = _flash_counts()
            runs["csiq"] = {"correlations": csiq,
                            "test": _rate(engine.last_run_stats["test"])}
            total = {k: total[k] + csiq_flash[k] for k in total}
        else:
            csiq_flash = None
            runs["csiq"] = "not run: the native build decodes no PNG"

    train_steps = stats["train"][0]["batches"]
    live_batches = runs["live"]["test"]["batches"]
    gates = {"flash_fwd_per_call": live_flash["flash_fwd"] == layers_fwd * (
                 train_steps + live_batches),
             "flash_bwd_fused_per_step": live_flash["flash_bwd_fused"] == layers_fwd * train_steps,
             "test_correlations_finite": bool(np.isfinite(live["SROCC"]))}
    if csiq_flash is not None:
        gates["csiq_flash_fwd_per_call"] = csiq_flash["flash_fwd"] == layers_fwd * \
            runs["csiq"]["test"]["batches"]
        gates["csiq_correlations_finite"] = bool(np.isfinite(runs["csiq"]["correlations"]["SROCC"]))
    out = {"phase": "engine_config5", "card": card,
           "config": f"BASELINE config 5 through engine.train(): ViT-B/16 6 layers, 8 "
                     f"registers, {N_LONG} patches, uniform CAPS, batch {PAIRS}, AdamW, "
                     f"bf16, seeded random weights; max_size_buckets 2",
           "data": {"train": "PIPAL layout 288x288 (BMP), reference 0 of 200 (116 pairs)",
                    "test": f"LIVE layout (BMP, sizes vary; {LIVE_REAL_PER_DIR} real "
                            "entries per distortion dir, all 29 references) and the CSIQ "
                            "layout 512x512 (PNG, reference 0 of 30, 24 pairs)"},
           "train": _rate(stats["train"]), "tests": runs,
           "flash_launches": {"live_run": live_flash, "csiq_run": csiq_flash},
           "flash_launches_expected_per_call": layers_fwd, "gates": gates}
    emit(out)
    if not all(gates.values()):
        raise AssertionError(f"engine_config5 gates failed: {gates}")
    out["flash_launches"] = total
    return out


# ---------------------------------------------------------------------------
# 13. engine_pieapp: the PieAPP pretraining recipe through engine.train()
# ---------------------------------------------------------------------------

PIEAPP_REFS, PIEAPP_PAIRS_PER_REF = 140, 3
PIEAPP_SPLIT = (list(range(130)), list(range(130, 135)), list(range(135, 140)))
PAIRWISE_LOSS_TOL = 1e-4   # card vs CPU fp32 step: summation order only
PREF_P_TOL = 1e-6          # p after that step


def _pieapp_cfg(vit_npz=None):
    vit = get_vit_config(num_keep_layers=6, num_extra_tokens=8, vit_weights_path=vit_npz)
    return VTAMIQConfig(vit=vit)


def pairwise_card_vs_cpu(vit_npz):
    """One fp32 pairwise train step of 2 triplets with the preference
    module, AdamW, TF32 off, on the card and on the CPU from the same
    weights (ImageNet npz loaded) and the same card-gathered patches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _pieapp_cfg(vit_npz)
    base = engine.get_model_params(cfg, seed=SEED, use_pref_module=True)
    gen = torch.Generator().manual_seed(SEED + 3)
    # two noisy copies of each reference, so that the preferences stay off
    # the sigmoid's flat tails and p gets a gradient
    ref = torch.rand(2, 1, PIEAPP_HW, PIEAPP_HW, C, generator=gen)
    raw = torch.cat([ref] + [(ref + s * torch.randn(ref.shape, generator=gen)).clamp(0, 1)
                             for s in (0.02, 0.03)], dim=1)
    extract = make_extract_fn(PatchSampler(), ExtractConfig(
        patch_count=PIEAPP_PATCHES, patch_dim=P, gather_dtype="float32"))
    patches, pos, scales = extract(raw.to(CARD), gen)
    qs = torch.rand(2, generator=gen)
    out = {}
    for dev in ("cpu", CARD):
        model = copy.deepcopy(base).to(dev)
        adamw = Optimizer("AdamW", lambda count: torch.tensor(1e-3), weight_decay=0.01)
        state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
        step = make_train_step_on_patches(cfg, adamw, compute_dtype=torch.float32,
                                          is_pairwise=True, use_pref_module=True)
        metrics, q = step(model, state, build_freeze_mask(model, False), patches.to(dev),
                          pos.to(dev), scales, qs.to(dev), 2, (1.0, 1.0, 1.0))
        out[dev] = {"loss": float(metrics["loss"]), "p": float(model.pref_module.p.detach()),
                    "preference": q.cpu().tolist()}
        del model, state
    return {"cpu": out["cpu"], "card": out[CARD],
            "loss_err": abs(out[CARD]["loss"] - out["cpu"]["loss"]),
            "p_err": abs(out[CARD]["p"] - out["cpu"]["p"])}


def bare_pairwise_rate():
    """Triplets/s of the bare pairwise step (extraction, forward, backward,
    AdamW) at batch 12, 256 patches, bf16, on random 256x256 images already
    on the card: 5 timed steps after one warm-up."""
    cfg = _pieapp_cfg()
    model = init_vtamiq_params(cfg, torch.Generator().manual_seed(SEED)).to(CARD)
    attach_preference_module(model)
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01)
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    step = make_train_step(cfg, PatchSampler(), ExtractConfig(patch_count=PIEAPP_PATCHES,
                                                              patch_dim=P), adamw,
                           is_pairwise=True, use_pref_module=True)
    gen = torch.Generator().manual_seed(SEED)
    raw = torch.rand(PIEAPP_BATCH, 3, PIEAPP_HW, PIEAPP_HW, C, generator=gen).to(CARD)
    qs = torch.rand(PIEAPP_BATCH, generator=gen).to(CARD)
    model_gen = torch.Generator(device=CARD).manual_seed(SEED)
    mask = build_freeze_mask(model, False)
    times = []
    for i in range(6):
        t0 = time.perf_counter()
        metrics, _ = step(model, state, mask, raw, qs, PIEAPP_BATCH, (1.0, 1.0, 1.0), gen,
                          model_gen)
        float(metrics["loss"])  # synchronizes
        if i:
            times.append(time.perf_counter() - t0)
    return PIEAPP_BATCH / float(np.median(times))


def phase_engine_pieapp(card, root, png):
    """The PieAPP pretraining recipe through engine.train(): ViT-B/16 6
    layers, 8 registers, from a synthetic ViT-B_16-layout npz (12 blocks,
    14x14 positional grid, resized to 24x24), the preference module on,
    batch 12, 256 patches, AdamW, bf16; 140 references of 3 pairs split
    130 / 5 / 5; one epoch, then a resumed epoch under torch.profiler."""
    t0 = time.perf_counter()
    vit_npz = f"{root}/ViT-B_16.npz"
    with engine_configs() as C:
        C._DATASET_REGISTRY[C.DATASET_PIEAPP_TRAIN] = (
            _subclass(datasets.PieAPPTrainPairwise, root,
                      num_dist_images=PIEAPP_PAIRS_PER_REF),
            C.setup_split_config(*PIEAPP_SPLIT))
        g = C.global_config
        g.update(dataset=C.DATASET_PIEAPP_TRAIN, dataset_test=None, device=CARD,
                 do_train=True, do_val=True, do_test=True, is_debug=False, num_epochs=1,
                 seed=SEED, compute_dtype="bfloat16", optimizer="AdamW", save_optimizer=True,
                 use_pref_module=True, vit_weights_path=vit_npz,
                 allow_use_full_dataset=False, allow_use_full_dataset_test=False,
                 output_dir=f"{root}/out_pieapp", is_verbose=False, config_validated=False)
        _set_loaders(C, PIEAPP_BATCH, PIEAPP_PATCHES)
        cfg = C.build_model_config()
        npz_grid = int(math.isqrt(np.load(vit_npz)[
            "Transformer/posembed_input/pos_embedding"].shape[1] - 1))

        gather_kernel.launches = 0
        flash_kernel.reset_launches()
        test = engine.train()
        launches, flash_launches = gather_kernel.launches, _flash_counts()
        stats = {k: list(v) for k, v in engine.last_run_stats.items()}
        out_dir = g["output_dir_final"]
        latest = os.path.join(out_dir, "latest.npz")
        first = load_checkpoint(latest)
        with open(os.path.join(out_dir, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]

        # resume for one more epoch, train only, profiled; the preference
        # module as the resumed run starts training
        resumed_p = {}
        do_training = engine.do_training

        def capture(train_step, params, *args, **kwargs):
            resumed_p["p"] = params.pref_module.p.detach().cpu().clone()
            return do_training(train_step, params, *args, **kwargs)

        g.update(resume_checkpoint_file=latest, num_epochs=2, do_val=False, do_test=False,
                 config_validated=False)
        gather_kernel.launches = 0
        flash_kernel.reset_launches()
        engine.do_training = capture
        try:
            t1 = time.perf_counter()
            _, idle, device_events = device_idle_share(engine.train)
            profiled_s = time.perf_counter() - t1
        finally:
            engine.do_training = do_training
        resume_launches, resume_flash = gather_kernel.launches, _flash_counts()
        resume_stats = list(engine.last_run_stats["train"])
        resumed = load_checkpoint(os.path.join(g["output_dir_final"], "latest.npz"))

    bare = bare_pairwise_rate()
    fp32 = pairwise_card_vs_cpu(vit_npz)
    steps = sum(s["batches"] for phase in stats.values() for s in phase)
    pref = first.get(engine_config.PREF_MODULE_STATE_DICT, {})
    p1 = torch.from_numpy(np.asarray(pref["p"], np.float32)) if "p" in pref else None
    gates = {
        "checkpoint_holds_pref_module": p1 is not None and not any(
            k.startswith("pref_module") for k in first[engine_config.MODEL_STATE_DICT]),
        "resume_reloads_pref_module_bit_for_bit": p1 is not None and "p" in resumed_p
        and torch.equal(resumed_p["p"], p1),
        "p_moved_from_6": p1 is not None and float(p1) != 6.0,
        "gather_one_launch_per_step": launches == steps
        and resume_launches == sum(s["batches"] for s in resume_stats),
        # 265 tokens stay below the flash threshold: the quadratic form
        "no_flash_below_threshold": PIEAPP_PATCHES < FLASH_ATTENTION_THRESHOLD
        and not any(flash_launches.values()) and not any(resume_flash.values()),
        "losses_finite": bool(scalars) and all(np.isfinite(x["value"]) for x in scalars
                                               if x["tag"].endswith("loss")),
        "resume_starts_at_epoch_2": [s["epoch"] for s in resume_stats] == [2],
        "fp32_step_loss_card_vs_cpu": fp32["loss_err"] <= PAIRWISE_LOSS_TOL,
        "fp32_step_p_card_vs_cpu": fp32["p_err"] <= PREF_P_TOL,
        "fp32_step_p_moved": fp32["card"]["p"] != 6.0,
        "vit_npz_grid_resized": npz_grid == 14 and cfg.vit.pos_grid == 24,
    }
    train = _rate(stats["train"])
    out = {"phase": "engine_pieapp", "card": card,
           "config": f"PieAPP pretraining (run tag 2e-12b-256p) through engine.train(): "
                     f"ViT-B/16 6 layers, 8 registers, DiffNet head, the preference module "
                     f"(p init 6), {PIEAPP_PATCHES} patches, uniform CAPS, batch "
                     f"{PIEAPP_BATCH}, AdamW, bf16; ViT weights from a synthetic "
                     f"ViT-B_16-layout npz (12 blocks, {npz_grid}x{npz_grid} grid -> "
                     f"{cfg.vit.pos_grid}x{cfg.vit.pos_grid}), seeded",
           "data": {"layout": f"PieAPP ({'PNG' if png else 'PNG through PIL'}), "
                              f"{PIEAPP_HW}x{PIEAPP_HW}",
                    "references": PIEAPP_REFS, "pairs_per_reference": PIEAPP_PAIRS_PER_REF,
                    "split_refs": [len(x) for x in PIEAPP_SPLIT],
                    "train_triplets": train["pairs"], "val_triplets": _rate(stats["val"])["pairs"],
                    "test_triplets_per_repeat": stats["test"][0]["pairs"],
                    "test_repeats": len(stats["test"]),
                    "cut": "3 of the 483 pairs a reference, one epoch and a resumed one"},
           "train": {**train, "triplets_per_s": train["pairs_per_s"]},
           "bare_step_triplets_per_s": bare,
           "engine_over_bare": train["pairs_per_s"] / bare,
           "val": _rate(stats["val"]), "test": _rate(stats["test"]),
           "resumed_epoch": {**_rate(resume_stats), "profiled": True,
                             "device_idle_share": idle, "device_events": device_events,
                             "train_call_s_with_profiler": profiled_s},
           "pref_p": {"after_epoch_1": None if p1 is None else float(p1),
                      "after_epoch_2": float(np.asarray(resumed.get(
                          engine_config.PREF_MODULE_STATE_DICT, {}).get("p", np.nan)))},
           "fp32_pairwise_step_card_vs_cpu": {**fp32, "tolerances": {
               "loss": PAIRWISE_LOSS_TOL, "p": PREF_P_TOL}, "tf32": False},
           "gather_launches": launches, "steps": steps,
           "gather_launches_resumed": resume_launches, "flash_launches": flash_launches,
           "flash_launches_resumed": resume_flash,
           "test_correlations": test, "phase_s": time.perf_counter() - t0, "gates": gates}
    emit(out)
    if not all(gates.values()):
        raise AssertionError(f"engine_pieapp gates failed: {gates}")
    return out


# ---------------------------------------------------------------------------
# 14. model_extras: Houlsby adapters and the PU input mode, card vs CPU
# ---------------------------------------------------------------------------

EXTRAS_LOSS_TOL = 1e-4     # fp32 card vs CPU on the same patches
EXTRAS_Q_TOL = 1e-3


def _step_card_vs_cpu(cfg, base, patches, pos, qs, mask_of, sampler_note):
    """One fp32 train step (AdamW, rank + pears + MAE) on the card and on
    the CPU from the same weights and patches -> losses, q and errors."""
    out = {}
    for dev in ("cpu", CARD):
        model = copy.deepcopy(base).to(dev)
        adamw = Optimizer("AdamW", lambda count: torch.tensor(1e-3), weight_decay=0.01)
        state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
        step = make_train_step_on_patches(cfg, adamw, weighted_loss=True,
                                          compute_dtype=torch.float32)
        metrics, q = step(model, state, mask_of(model), patches.to(dev), pos.to(dev), None,
                          qs.to(dev), qs.shape[0], (1.0, 1.0, 1.0))
        out[dev] = {"loss": float(metrics["loss"]), "q": q.cpu()}
        del model, state
    return {"what": sampler_note, "loss_cpu": out["cpu"]["loss"], "loss_card": out[CARD]["loss"],
            "loss_err": abs(out[CARD]["loss"] - out["cpu"]["loss"]),
            "q_err": float((out[CARD]["q"] - out["cpu"]["q"]).abs().max()),
            "q_card": out[CARD]["q"].tolist()}


def phase_model_extras(card, refs, dists):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)]))
    qs = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, PAIRS).astype(np.float32))
    gen = torch.Generator().manual_seed(SEED + 4)

    # Houlsby adapters: encoder frozen, adapters trainable (the default
    # freeze dict), 2 pairs at 500 patches
    cfg_a = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8,
                                            num_adapters=1))
    base = init_vtamiq_params(cfg_a, torch.Generator().manual_seed(SEED))
    extract = make_extract_fn(PatchSampler(), ExtractConfig(patch_count=N, patch_dim=P,
                                                            gather_dtype="float32"))
    patches, pos, _ = extract(raw[:2].to(CARD), gen)
    frozen = lambda m: build_freeze_mask(m, True, engine_config.freeze_dict_vtamiq)
    adapters = _step_card_vs_cpu(cfg_a, base, patches, pos, qs[:2], frozen,
                                 "ViT-B/16 6 layers + 1 Houlsby adapter a layer, encoder "
                                 f"frozen, 2 pairs, {N} patches, fp32")
    adapters["trainable_adapter_tensors"] = sum(
        1 for n, v in frozen(base).items() if ".adapters." in n and v > 0)

    # PU input: config 3's weighted sampler (MAGNITUDE), PU-encoded
    cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8))
    base = init_vtamiq_params(cfg, torch.Generator().manual_seed(SEED))
    magnitude = weighted_sampler(sampling.DIFF_TYPE_MAGNITUDE)
    pu_cfg = dict(patch_count=N, patch_dim=P, norm_mean=None, norm_std=None,
                  pu_display_encode=True)
    # (a) the bf16 train step of config 3, batch 8, its gather recorded
    model = copy.deepcopy(base).to(CARD)
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01)
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    step = make_train_step(cfg, magnitude, ExtractConfig(**pu_cfg), adamw)
    calls, gather = [], gather_kernel.gather_patches

    def recorded(*args):
        out = gather(*args)
        calls.append((args, out))
        return out

    gather_kernel.gather_patches = recorded
    gather_kernel.launches = 0
    try:
        metrics, _ = step(model, state, build_freeze_mask(model, False), raw.to(CARD),
                          qs.to(CARD), PAIRS, (1.0, 1.0, 1.0), gen,
                          torch.Generator(device=CARD).manual_seed(SEED))
        bf16_loss = float(metrics["loss"])
        pu_launches = gather_kernel.launches
    finally:
        gather_kernel.gather_patches = gather
    del model, state, step
    args, got = calls[0]
    want = gather_kernel.gather_patches_plain(*args)
    pu_gather = {"equal": bool(torch.equal(got, want)), "out_dtype": str(got.dtype),
                 "normalized": args[4] is not None,
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "shape": list(got.shape)}
    # (b) fp32 q, card vs CPU on the same card-sampled PU patches
    extract = make_extract_fn(magnitude, ExtractConfig(**pu_cfg, gather_dtype="float32"))
    patches, pos, _ = extract(raw[:2].to(CARD), gen)
    pu = _step_card_vs_cpu(cfg, base, patches, pos, qs[:2], lambda m: build_freeze_mask(m, False),
                           f"config 3 weighted CAPS (MAGNITUDE) with use_pu, 2 pairs, {N} "
                           "patches, fp32")
    gates = {"adapters_loss": adapters["loss_err"] <= EXTRAS_LOSS_TOL,
             "adapters_q": adapters["q_err"] <= EXTRAS_Q_TOL,
             "adapters_trainable": adapters["trainable_adapter_tensors"] == 6 * 8,
             "pu_gather_equals_plain": pu_gather["equal"] and pu_gather["out_dtype"] ==
             "torch.bfloat16" and not pu_gather["normalized"],
             "pu_bf16_step_one_gather_finite": pu_launches == 1 and bool(np.isfinite(bf16_loss)),
             "pu_loss": pu["loss_err"] <= EXTRAS_LOSS_TOL, "pu_q": pu["q_err"] <= EXTRAS_Q_TOL}
    out = {"phase": "model_extras", "card": card, "adapters": adapters,
           "pu": {**pu, "bf16_step_loss": bf16_loss, "bf16_step_gather_launches": pu_launches,
                  "bf16_step_gather_vs_plain": pu_gather},
           "tolerances": {"loss": EXTRAS_LOSS_TOL, "q": EXTRAS_Q_TOL}, "tf32": False,
           "gates": gates}
    emit(out)
    if not all(gates.values()):
        raise AssertionError(f"model_extras gates failed: {gates}")
    return out


# --------------------------------------------------------------------------
# mesh phases: ranks as child processes of this script, all on cuda:0 over
# gloo (NCCL cannot put two ranks on one device); the ranks share the card,
# so their times are context, not a scaling number
# --------------------------------------------------------------------------

MESH_CHILD = "--mesh-child"
MESH_NOTE = ("ranks are processes sharing cuda:0 over gloo (NCCL cannot put two ranks on one "
             "device; gloo stages all-gathers and sends through pinned host buffers): times "
             "are context, not a scaling number")
RING_ROWS, RING_TOKENS = 2 * PAIRS, 5120     # config 5's 5009 tokens padded to 64 * 80
RING_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (output, gradients)
# mesh step against the single-process step, fp32: the loss relative; the
# grad norm relative at JAX's own mesh-test bound (tests/test_train_steps.py),
# since it is ruled by the head's gradients, which scale with cls_ref -
# cls_dist, a difference a few percent of the CLS vectors' norm (the bf16
# note above) that multiplies the rounding of other summation orders by
# 30 or more: 8e-6 even under data = 2, whose rows see the same math
# (measured on an H100 80GB HBM3); every updated parameter's max abs
# difference at JAX's bound
MESH_LOSS_TOL, MESH_NORM_TOL, MESH_PARAM_TOL = 1e-5, 1e-4, 2.5e-4


def run_ranks(phase, world, spec, timeout=420):
    """Run ``phase``'s child function in ``world`` processes of this script
    and return each rank's result; a rank that fails raises here with every
    rank's output. Every process is ended before this returns."""
    job = tempfile.mkdtemp(prefix="vtamiq_mesh_")
    with open(os.path.join(job, "spec.json"), "w") as f:
        json.dump(spec, f)
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, MESH_CHILD, phase, str(r), str(world), job],
                              cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        deadline = time.perf_counter() + timeout
        try:
            logs = [p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
                    for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs = [p.communicate()[0] for p in procs]
            raise RuntimeError(f"{phase}: ranks still running after {timeout} s:\n"
                               + "\n---\n".join(log[-6000:] for log in logs))
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"{phase}: a rank failed (exit codes "
                               f"{[p.returncode for p in procs]}):\n" + "\n---\n".join(
                                   log[-6000:] for log in logs))
        results = []
        for r in range(world):
            with open(os.path.join(job, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(job, ignore_errors=True)


def mesh_child(phase, rank, world, job):
    """One rank of a mesh phase (``python3 chip_smoke.py --mesh-child``)."""
    from vtamiq_tpu_torch.parallel import distributed
    rank, world = int(rank), int(world)
    with open(os.path.join(job, "spec.json")) as f:
        spec = json.load(f)
    distributed.initialize(f"file://{job}/store", world, rank, local_device="cuda:0",
                           backend="gloo")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        result = MESH_CHILDREN[phase](spec, rank, world)
    finally:
        distributed.shutdown()
    with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _barrier():
    torch.cuda.synchronize()
    torch.distributed.barrier()


def _rel(got, want):
    """max |got - want| / max |want| in fp32 (the max abs error where want
    is zero: padding keys' gradients)."""
    err, scale = (got.float() - want.float()).abs().max(), want.float().abs().max()
    return float(err / scale) if scale > 0 else float(err)


def _cuda_ms(fn, reps=2):
    """Median ms of ``fn`` over ``reps`` calls, CUDA events (after the
    gate's call has warmed it up)."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ring_child(spec, rank, world):
    """The ring over ``world`` ranks at config 5's shapes against
    ``ops/attention.py::flash_attention`` on the whole sequence on the same
    card, in bf16 and fp32: 5009 valid tokens, then a mask that leaves the
    last rank's chunk padding alone; in fp32 the split backward too."""
    from vtamiq_tpu_torch.ops.attention import flash_attention
    from vtamiq_tpu_torch.parallel.mesh import make_mesh
    from vtamiq_tpu_torch.parallel.ring_attention import make_ring_attention, shard_seq
    mesh = make_mesh(data=1, model=1, seq=world)
    out = {}
    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, go = (torch.randn(RING_ROWS, RING_TOKENS, HEADS, HEAD_DIM, generator=gen,
                                   device="cuda").to(getattr(torch, dtype)) for _ in range(4))
        cases = [("config5", S_VALID, True), ("last_rank_padding", RING_TOKENS
                                              - RING_TOKENS // world, True)]
        if dtype == "float32" and world == 2:
            cases.append(("config5_split_backward", S_VALID, False))
        for case, valid, fused in cases:
            mask = (torch.arange(RING_TOKENS, device="cuda") < valid).expand(
                RING_ROWS, RING_TOKENS).contiguous()
            full = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = flash_attention(*full, mask)
            ref.backward(go)
            loc = [shard_seq(t, mesh).clone().requires_grad_() for t in (q, k, v)]
            ring = make_ring_attention(mesh, fused_bwd=fused)
            _barrier()
            flash_kernel.reset_launches()
            o = ring(*loc, shard_seq(mask, mesh))
            o.backward(shard_seq(go, mesh))
            torch.cuda.synchronize()
            row = {"valid_tokens": valid, "fused_backward": fused,
                   "launches": dict(flash_kernel.launches),
                   "finite": bool(torch.isfinite(o).all()) and all(
                       bool(torch.isfinite(t.grad).all()) for t in loc),
                   "max_rel_err": {"out": _rel(o, shard_seq(ref, mesh)), **{
                       n: _rel(t.grad, shard_seq(f.grad, mesh))
                       for n, t, f in zip(("dq", "dk", "dv"), loc, full)}}}
            if case == "config5":
                o = None
                _barrier()
                fwd_ms = _cuda_ms(lambda: ring(*loc, shard_seq(mask, mesh)))
                res = ring(*loc, shard_seq(mask, mesh))
                _barrier()
                bwd_ms = _cuda_ms(lambda: res.backward(shard_seq(go, mesh), retain_graph=True))
                row.update(ring_forward_ms=fwd_ms, ring_backward_ms=bwd_ms)
                del res
                _barrier()
                if rank == 0:  # the single-device call, alone on the card
                    full2 = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                    row["single_device_forward_ms"] = _cuda_ms(
                        lambda: flash_attention(*full2, mask))
                    ref2 = flash_attention(*full2, mask)
                    row["single_device_backward_ms"] = _cuda_ms(
                        lambda: ref2.backward(go, retain_graph=True))
                _barrier()
            out[f"{dtype}/{case}"] = row
            del full, ref, loc, o
    return out


def phase_ring_attention(card):
    """Worlds of 2 and 4 ranks on the one card: the ring against
    single-device flash attention, launches, padding alone, times."""
    lines, gates = {}, {}
    for world in (2, 4):
        results = run_ranks("ring", world, {})
        for key in results[0]:
            dtype, case = key.split("/")
            out_tol, grad_tol = RING_TOL[dtype]
            for rank, res in enumerate(results):
                row = res[key]
                errs = row["max_rel_err"]
                want = ({"flash_fwd": world, "flash_bwd_fused": world, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0} if row["fused_backward"] else
                        {"flash_fwd": world, "flash_bwd_fused": 0, "flash_bwd_dq": world,
                         "flash_bwd_dkv": world})
                gates[f"n{world}/{key}/rank{rank}"] = (
                    row["finite"] and errs["out"] <= out_tol
                    and max(errs["dq"], errs["dk"], errs["dv"]) <= grad_tol
                    and row["launches"] == want)
        lines[f"n{world}"] = {"rank0": results[0], "rank_last": results[-1]}
    emit({"phase": "ring_attention", "card": card, "note": MESH_NOTE,
          "config": f"config 5's attention: {RING_ROWS} rows, {HEADS} heads, {S_VALID} valid "
                    f"tokens padded to {RING_TOKENS}, head dim {HEAD_DIM}; bf16, and fp32 with "
                    "TF32 off; each rank holds 1/n of the tokens; reference: "
                    "ops/attention.py::flash_attention on the whole sequence, same card",
          "tolerances": {"output_and_gradients_rel_max": RING_TOL},
          "worlds": lines, "gates": gates})
    if not all(gates.values()):
        raise AssertionError(f"ring_attention gates failed: "
                             f"{[k for k, v in gates.items() if not v]}")
    split = lines["n2"]["rank0"]["float32/config5_split_backward"]["launches"]
    return {"flash_bwd_dq": split["flash_bwd_dq"], "flash_bwd_dkv": split["flash_bwd_dkv"]}


MESH_STEP_CASES = [  # name, (data, model, seq), patches, batch, sampler
    ("data2", (2, 1, 1), N, PAIRS, "magnitude"),
    ("model2", (1, 2, 1), N, PAIRS, "magnitude"),
    ("seq2", (1, 1, 2), N_LONG, 2, "uniform"),
]


def _mesh_train(cfg, base, mesh, sampler, patches, batch, raw, qs, dtype):
    """One make_train_step step of a fresh copy of ``base`` (its TP shard
    under a mesh) on ``raw``/``qs`` rows: (metrics, q, full updated
    parameters, seconds, launches)."""
    from vtamiq_tpu_torch.parallel.mesh import shard_batch, shard_params, unshard_params
    model = shard_params(copy.deepcopy(base).cuda(), mesh) if mesh is not None \
        else copy.deepcopy(base).cuda()
    adamw = Optimizer("AdamW", lambda count: torch.tensor(5e-5), weight_decay=0.01)
    state = adamw.init({n: p.detach() for n, p in model.named_parameters()})
    ecfg = ExtractConfig(patch_count=patches, patch_dim=P,
                         gather_dtype="float32" if dtype == torch.float32 else "bfloat16")
    step = make_train_step(cfg, sampler, ecfg, adamw, weighted_loss=True, compute_dtype=dtype,
                           mesh=mesh)
    rows = (raw, qs) if mesh is None else shard_batch((raw, qs), mesh)
    sample_gen = torch.Generator().manual_seed(SEED)
    model_gen = torch.Generator(device="cuda").manual_seed(SEED)
    if mesh is not None:
        _barrier()
    torch.cuda.synchronize()
    flash_kernel.reset_launches()
    gather_kernel.launches = 0
    t0 = time.perf_counter()
    metrics, q = step(model, state, build_freeze_mask(model, False), *rows, batch, (1.0, 1.0, 1.0),
                      sample_gen, model_gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"gather": gather_kernel.launches, **_flash_counts()}
    full = unshard_params(model, mesh) if mesh is not None else \
        {n: p.detach() for n, p in model.named_parameters()}
    return metrics, q, full, seconds, launches


def mesh_steps_child(spec, rank, world):
    """Each case's fp32 step on the mesh, held (on rank 0) against the
    single-process step on the same card, global batch and generators; then
    one bf16 step, timed."""
    from vtamiq_tpu_torch.parallel.mesh import make_mesh
    cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8))
    base = init_vtamiq_params(cfg, torch.Generator().manual_seed(SEED))
    refs, dists = synthetic_pairs(PAIRS)
    raw = torch.from_numpy(np.stack([np.stack([r, d]) for r, d in zip(refs, dists)])).cuda()
    qs = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, PAIRS).astype(np.float32)
                          ).cuda()
    samplers = {"magnitude": weighted_sampler(sampling.DIFF_TYPE_MAGNITUDE),
                "uniform": PatchSampler()}
    out = {}
    for name, shape, patches, batch, sampler in MESH_STEP_CASES:
        mesh = make_mesh(*shape)
        args = (samplers[sampler], patches, batch, raw[:batch], qs[:batch])
        metrics, q, full, seconds, launches = _mesh_train(cfg, base, mesh, *args, torch.float32)
        row = {"mesh": dict(zip(("data", "model", "seq"), shape)), "patches": patches,
               "batch": batch, "sampler": sampler, "fp32_step_s": seconds,
               "fp32_launches": launches, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "q": q.float().cpu().tolist()}
        _barrier()
        if rank == 0:  # the single-process step, alone on the card
            m1, q1, full1, s1, l1 = _mesh_train(cfg, base, None, *args, torch.float32)
            row.update(single_step_s=s1, single_launches=l1,
                       loss_rel_err=abs(row["loss"] - float(m1["loss"])) / abs(float(m1["loss"])),
                       grad_norm_rel_err=abs(row["grad_norm"] - float(m1["grad_norm"]))
                       / abs(float(m1["grad_norm"])),
                       q_max_abs_err=float((q.float() - q1.float()).abs().max()),
                       param_max_abs_err=max(float((full[n] - full1[n]).abs().max())
                                             for n in full1),
                       params_compared=len(full1))
            del full1
        del full
        _barrier()
        m16, _, _, s16, l16 = _mesh_train(cfg, base, mesh, *args, torch.bfloat16)
        row.update(bf16_step_s=s16, bf16_launches=l16, bf16_loss=float(m16["loss"]),
                   bf16_finite=bool(np.isfinite([float(m16["loss"]),
                                                 float(m16["grad_norm"])]).all()))
        out[name] = row
        _barrier()
    return out


def phase_mesh_steps(card):
    """Config 3's train step under data = 2 and model = 2, config 5's under
    seq = 2, two processes on the card, against the single-process step."""
    results = run_ranks("mesh_steps", 2, {})
    layers = 6 - 1   # the last layer's CLS-only queries take no flash call
    gates = {}
    for name, shape, patches, batch, _ in MESH_STEP_CASES:
        r0, r1 = results[0][name], results[1][name]
        flash = 2 * layers if shape[2] == 2 else 0
        want = {"gather": 1, "flash_fwd": flash, "flash_bwd_fused": flash, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        gates[name] = {
            "loss_rel": r0["loss_rel_err"] <= MESH_LOSS_TOL,
            "grad_norm_rel": r0["grad_norm_rel_err"] <= MESH_NORM_TOL,
            "q": r0["q_max_abs_err"] <= FP32_Q_TOL,
            "params": r0["param_max_abs_err"] <= MESH_PARAM_TOL,
            "ranks_agree": r0["loss"] == r1["loss"] and r0["q"] == r1["q"],
            "launches_per_rank": r0["fp32_launches"] == want and r1["fp32_launches"] == want,
            "bf16_finite": r0["bf16_finite"] and r1["bf16_finite"]}
    emit({"phase": "mesh_steps", "card": card, "note": MESH_NOTE,
          "config": f"ViT-B/16 6 layers, 8 registers, DiffNet head, {H}x{W}, AdamW(5e-5, wd "
                    "0.01, clip 1.0), the weighted loss MAE + rank + Pearson (weights 1, 1, 1: "
                    "batch 2's rank and Pearson terms alone are degenerate), DropPath and "
                    "dropout of the head active; config 3 (weighted CAPS, MAGNITUDE, 500 patches, batch 8) under "
                    "data = 2 and model = 2, config 5 (5000 patches, batch 2) under seq = 2; "
                    "fp32 with TF32 off against the single-process step on the same card, "
                    "then one bf16 step",
          "tolerances": {"loss_rel": MESH_LOSS_TOL, "grad_norm_rel": MESH_NORM_TOL,
                         "q_abs": FP32_Q_TOL, "param_abs": MESH_PARAM_TOL},
          "rank0": results[0], "rank1_loss": {n: results[1][n]["loss"] for n in results[1]},
          "gates": gates})
    failed = {n: g for n, g in gates.items() if not all(g.values())}
    if failed:
        raise AssertionError(f"mesh_steps gates failed: {failed}")
    return {"gather": sum(results[0][n]["fp32_launches"]["gather"] for n in results[0]),
            "flash_fwd": results[0]["seq2"]["fp32_launches"]["flash_fwd"],
            "flash_bwd_fused": results[0]["seq2"]["fp32_launches"]["flash_bwd_fused"]}


def engine_mesh_child(spec, rank, world):
    """engine.train() with mesh_data = 2 on config 3's tree: one epoch with
    train, val and test, each rank writing under its own output root; then
    a train-only resume from rank 0's latest.npz."""
    root, png = spec["root"], spec["png"]
    with engine_configs() as C:
        train_cls = (_subclass(datasets.KADID10kDataset, root, num_dist_images=5 * CONFIG3_TYPES)
                     if png else
                     _subclass(datasets.TID2013Dataset, f"{root}/train3",
                               num_dist_images=5 * CONFIG3_TYPES))
        C._DATASET_REGISTRY[C.DATASET_KADID10K] = (train_cls, C.setup_split_config(
            CONFIG3_TRAIN_REFS, CONFIG3_VAL_REFS, CONFIG3_VAL_REFS))
        C._DATASET_REGISTRY[C.DATASET_TID2013] = (_subclass(datasets.TID2013Dataset, root),
                                                  C.setup_split_config([0], [0], [0]))
        g = C.global_config
        g.update(dataset=C.DATASET_KADID10K, dataset_test=C.DATASET_TID2013, device=CARD,
                 do_train=True, do_val=True, do_test=True, is_debug=False, num_epochs=1,
                 seed=SEED, compute_dtype="bfloat16", optimizer="AdamW",
                 save_optimizer=True, allow_use_full_dataset=False,
                 allow_use_full_dataset_test=False, output_dir=f"{root}/out_mesh/rank{rank}",
                 is_verbose=False, config_validated=False, mesh_data=world)
        C.dataset_config_base["patch_sampler_config"] = dict(
            diff_weight=1.0, uniform_weight=0.1, grid_type=sampling.GRID_TYPE_PERTURBED,
            diff_type=sampling.DIFF_TYPE_MAGNITUDE)
        _set_loaders(C, PAIRS // world, N)   # global batch 8, as config 3
        trained = {}
        do_training = engine.do_training

        def capture(*args, **kwargs):
            result = do_training(*args, **kwargs)
            trained.update({n: p.detach().float().cpu().clone()
                            for n, p in result[0].named_parameters()})
            return result

        gather_kernel.launches = 0
        engine.do_training = capture
        t0 = time.perf_counter()
        try:
            test = engine.train()
        finally:
            engine.do_training = do_training
        seconds = time.perf_counter() - t0
        launches = gather_kernel.launches
        stats = {k: list(v) for k, v in engine.last_run_stats.items()}
        out_dir = g["output_dir_final"]
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        best_equal = None
        if rank == 0:
            best = load_checkpoint(os.path.join(out_dir, "best.npz"))[
                engine_config.MODEL_STATE_DICT]
            best_equal = sorted(best) == sorted(k.replace(".", "|") for k in trained) and all(
                torch.equal(torch.from_numpy(best[k.replace(".", "|")]), v)
                for k, v in trained.items())
        latest = [os.path.join(out_dir, "latest.npz")]
        torch.distributed.broadcast_object_list(latest, src=0)
        g.update(resume_checkpoint_file=latest[0], num_epochs=2, do_val=False, do_test=False,
                 config_validated=False)
        engine.train()
        resume_epochs = [s["epoch"] for s in engine.last_run_stats["train"]]
    steps = sum(s["batches"] for phase in stats.values() for s in phase)
    return {"test_correlations": {k: float(v) for k, v in test.items()},
            "output_root_exists": os.path.isdir(f"{root}/out_mesh/rank{rank}"),
            "files": files, "best_npz_equals_trained_model": best_equal,
            "resume_epochs": resume_epochs, "gather_launches": launches, "steps": steps,
            "train": _rate(stats["train"]), "test": _rate(stats["test"]), "train_call_s": seconds}


def phase_engine_mesh(card, root, png):
    """engine.train() with mesh_data = 2 across two processes on the card."""
    r0, r1 = run_ranks("engine_mesh", 2, {"root": root, "png": png})
    gates = {
        "test_correlations_equal_on_both_ranks": r0["test_correlations"]
        == r1["test_correlations"],
        "test_srocc_finite": bool(np.isfinite(r0["test_correlations"]["SROCC"])),
        "rank0_alone_wrote_files": r0["output_root_exists"] and not r1["output_root_exists"]
        and {"latest.npz", "best.npz", "scalars.jsonl", "config.yaml"} <= set(r0["files"]),
        "best_npz_equals_trained_model": r0["best_npz_equals_trained_model"] is True,
        "resume_starts_at_epoch_2": r0["resume_epochs"] == [2] and r1["resume_epochs"] == [2],
        "gather_one_launch_per_step": r0["gather_launches"] == r0["steps"]
        and r1["gather_launches"] == r1["steps"]}
    emit({"phase": "engine_mesh", "card": card, "note": MESH_NOTE,
          "config": "BASELINE config 3 through engine.train() with mesh_data = 2: the "
                    "engine_config3 tree, 4 pairs a rank (global batch 8), bf16, one epoch "
                    "of train, val and test, then a resumed train epoch",
          "rank0": r0, "rank1": {k: r1[k] for k in ("test_correlations", "output_root_exists",
                                                    "resume_epochs", "gather_launches",
                                                    "steps")},
          "gates": gates})
    if not all(gates.values()):
        raise AssertionError(f"engine_mesh gates failed: {gates}")
    return r0


MESH_CHILDREN = {"ring": ring_child, "mesh_steps": mesh_steps_child,
                 "engine_mesh": engine_mesh_child}


def main():
    name, smi = phase_device()
    phase_build()
    k = phase_kernel()
    attention = phase_attention(smi)
    scorer, refs, dists, launches = phase_scorer(smi)
    int8_launches = phase_scorer_int8(smi, scorer, refs, dists)
    weighted_launches, bare_config3_pairs_per_s = phase_weighted_caps(smi, refs, dists)
    phase_server(scorer, refs, dists)
    del scorer
    long_launches, fp32_fwd_launches = phase_scorer_5000p(smi, refs, dists)
    train_launches, split_launches, fp32_launches, remat_launches = phase_train_5000p(
        smi, refs, dists)
    phase_model_extras(smi, refs, dists)
    ring_launches = phase_ring_attention(smi)
    mesh_launches = phase_mesh_steps(smi)
    # the datasets are written only now, so that no timed phase above
    # shares the host's cores with the writers
    png = native_io.decodes("png")
    data_root = tempfile.mkdtemp(prefix="vtamiq_engine_")
    writers = start_dataset_writers(data_root, png)
    try:
        emit({"phase": "dataset_writers", "waited_s": wait_dataset_writers(writers),
              "trees": sorted(writers)})
        engine3 = phase_engine_config3(smi, data_root, png, bare_config3_pairs_per_s)
        engine5 = phase_engine_config5(smi, data_root, png)
        pieapp = phase_engine_pieapp(smi, data_root, png)
        engine_mesh = phase_engine_mesh(smi, data_root, png)
    finally:
        for proc in writers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(data_root, ignore_errors=True)
    main_launches = {"flash_fwd": long_launches["flash_fwd"],
                     "flash_bwd_fused": train_launches["flash_bwd_fused"],
                     "flash_bwd_dq": split_launches["flash_bwd_dq"],
                     "flash_bwd_dkv": split_launches["flash_bwd_dkv"]}
    launches_on = {"flash_fwd": "one scorer_5000p batch of 8 pairs",
                   "flash_bwd_fused": "three train_5000p steps",
                   "flash_bwd_dq": "one train_5000p step with the split backward",
                   "flash_bwd_dkv": "one train_5000p step with the split backward"}
    # fp32: the flash forward in scorer_5000p's 3 timed fp32 forwards, the
    # backward kernels in the fp32 train steps of the train_5000p checks
    fp32_main = {"flash_fwd": fp32_fwd_launches["flash_fwd"],
                 "flash_bwd_fused": fp32_launches["fused_step"]["flash_bwd_fused"],
                 "flash_bwd_dq": fp32_launches["split_step"]["flash_bwd_dq"],
                 "flash_bwd_dkv": fp32_launches["split_step"]["flash_bwd_dkv"]}
    fp32_on = {"flash_fwd": "three fp32 scorer_5000p forwards of 2 pairs",
               "flash_bwd_fused": "one fp32 train step of 2 pairs (fused backward)",
               "flash_bwd_dq": "one fp32 train step of 2 pairs (split backward)",
               "flash_bwd_dkv": "one fp32 train step of 2 pairs (split backward)"}
    ring_on = dict.fromkeys(("flash_fwd", "flash_bwd_fused"),
                            "mesh_steps, rank 0: one fp32 config 5 train step under seq = 2 "
                            "(2 chunks in each of 5 ring layers)")
    ring_on.update(dict.fromkeys(("flash_bwd_dq", "flash_bwd_dkv"),
                                 "ring_attention, rank 0 of 2: one fp32 ring call with the "
                                 "split backward"))
    kernels = [{
        "name": "gather_patches", "route": "cuda",
        "source": "vtamiq_tpu_torch/csrc/gather_patches.cu",
        "replaces": "vtamiq_tpu/ops/gather_kernel.py:51",
        "replaces_fn": "vtamiq_tpu/ops/gather_kernel.py::_vmem_gather_kernel",
        "launches": launches, "launches_on": "one scorer batch of 8 pairs",
        "launches_engine_config3": engine3["gather_launches"],
        "launches_engine_config3_on": "engine_config3: every train, val and test step",
        "launches_scorer_int8": int8_launches,
        "launches_scorer_int8_on": "one int8 (quantize_int8) scorer batch of 8 pairs",
        "launches_weighted_caps": weighted_launches,
        "launches_weighted_caps_on": "one config 2 (weighted CAPS) scorer batch of 8 pairs",
        "launches_engine_pieapp": pieapp["gather_launches"],
        "launches_engine_pieapp_on": "engine_pieapp: every train, val and test step of the "
                                     "first run (K = 3: 36 images a train step)",
        "launches_remat": remat_launches["gather"],
        "launches_remat_on": "one bf16 train_5000p forward and backward with remat (its "
                             "patches are cut before it)",
        "launches_mesh": mesh_launches["gather"],
        "launches_mesh_on": "mesh_steps, rank 0: the fp32 train steps under data = 2, "
                            "model = 2 and seq = 2 (one step each)",
        "launches_engine_mesh": engine_mesh["gather_launches"],
        "launches_engine_mesh_on": "engine_mesh, rank 0: every train, val and test step",
        "exact": True, "max_abs_err": k["max_abs_err"],
        "ms": k["device_ms_back_to_back"], "ms_is": "device time, back-to-back launches",
        "device_ms_l2_flushed": k["device_ms_l2_flushed"],
        "call_ms_with_wrapper": k["call_ms_with_wrapper"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
        "card": smi}]
    for kname, row in attention["bfloat16"].items():
        row32 = attention["float32"][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": FLASH_SOURCE[kname], "source_fp32": FLASH_SOURCE_FP32[kname],
            "replaces": FLASH_REPLACES[kname], "launches": main_launches[kname],
            "launches_on": launches_on[kname], "max_abs_err": row["max_abs_err"],
            "launches_engine_config5": engine5["flash_launches"].get(kname, 0),
            "launches_engine_config5_on": "engine_config5: PIPAL train, LIVE and CSIQ test",
            "launches_engine_pieapp": pieapp["flash_launches"][kname],
            "launches_engine_pieapp_on": "engine_pieapp: every train, val and test step of "
                                         "the first run (256 patches stay below the flash "
                                         "threshold)",
            "launches_remat": remat_launches[kname],
            "launches_remat_on": "one bf16 train_5000p forward and backward with remat (the "
                                 "forward again in each layer's recompute)",
            "launches_ring": {**mesh_launches, **ring_launches}[kname],
            "launches_ring_on": ring_on[kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "max_abs_err_fp32": row32["max_abs_err"], "ms_fp32": row32["ms"],
            "plain_ms_fp32": row32["plain_ms"], "bound_ms_fp32": row32["bound_ms"],
            "bound_by_fp32": row32["bound_by"], "bound_ms_fp32_ffma": row32["bound_ms_ffma"],
            "library_ms_fp32": row32["library_ms"], "launches_fp32": fp32_main[kname],
            "launches_fp32_on": fp32_on[kname], "card": smi})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_CHILD]:
        mesh_child(*sys.argv[2:])
    else:
        main()
    faulthandler.cancel_dump_traceback_later()
