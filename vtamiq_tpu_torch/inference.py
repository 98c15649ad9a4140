"""Scoring API: score ref/dist image pairs with a VTAMIQ model.

Port of ``vtamiq_tpu/inference.py``. The main path of a call: the pairs
group by the shape they are scored at; each group goes to the device as one
(B, 2, H, W, 3) tensor; per repeat, corners are drawn on the CPU, one gather
kernel launch per scale cuts the patches (normalized, in the compute dtype)
and one forward of the dual-tower model gives the scores. Long sequences
whose quadratic attention would not fit take the flash attention kernels
(``ops/attention.py::choose_attention_fn``, the JAX package's policy). With
``quantize_int8`` the encoder's dense layers run in int8 (``ops/quant.py``).

Example:
    scorer = VTAMIQScorer.from_checkpoint("best.npz")   # device="cuda"
    q = scorer.score_pair(ref_rgb, dist_rgb)            # numpy HWC in [0, 1]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .data.buckets import assign_bucket, pad_to_bucket
from .models.checkpoint import (MODEL_STATE_DICT, load_checkpoint, merge_params,
                                params_from_jax)
from .models.configs import VTAMIQConfig, get_vit_config
from .models.vit import load_vit_npz
from .models.vtamiq import VTAMIQ, init_vtamiq_params, vtamiq_forward
from .ops.attention import choose_attention_fn
from .ops.quant import quantize_params_int8, with_child
from .ops.sampling import PatchSampler
from .train.steps import ExtractConfig, make_extract_fn
from .utils.logging import log_warn

DEFAULT_NORM_MEAN = 0.5
DEFAULT_NORM_STD = 0.5


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card raises:
    the port never moves to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return device


def preference_from_scores(q_a: float, q_b: float) -> float:
    """sigmoid(q_a - q_b): the pairwise preference of the reference's
    preference module, shared by ``compare`` and the HTTP /compare."""
    return float(1.0 / (1.0 + np.exp(-(float(q_a) - float(q_b)))))


class VTAMIQScorer:
    """Scores image pairs on one device with a VTAMIQ model."""

    def __init__(self, cfg: Optional[VTAMIQConfig] = None,
                 params: Optional[VTAMIQ] = None,
                 patch_count: int = 500,
                 patch_num_scales: int = 1,
                 num_repeats: int = 1,
                 sampler: Optional[PatchSampler] = None,
                 size_buckets: Optional[Sequence] = None,
                 seed: int = 0,
                 quantize_int8: bool = False,
                 ingest_uint8: bool = False,
                 device="cuda",
                 compute_dtype: torch.dtype = torch.bfloat16):
        """``params``: a VTAMIQ module (default: weights drawn from a CPU
        generator seeded with ``seed``). The patch draws come from a second
        CPU generator seeded with ``seed``, so a seed gives the same patches
        on every device.

        ``size_buckets``: optional canonical (H, W) shapes; images pad up to
        their covering bucket and sampling confines to the true region, so
        mixed sizes share one device batch.

        ``ingest_uint8``: ship images to the device as uint8 and convert to
        fp32 [0, 1] there (4x less host-to-device traffic; exact for 8-bit
        sources, float inputs are rounded to 1/255 steps).

        ``compute_dtype``: bf16 (default) or fp32, for the gathered patches
        and the ViT; the CLS difference and the head always run in fp32.

        ``quantize_int8``: rewrite the ViT encoder's dense weights to int8
        (W8A8 dynamic, ``ops/quant.py``) at the first score, so the weights
        that the classmethods merged are the ones quantized. Serving only."""
        self.device = resolve_device(device)
        if cfg is None:
            cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8))
        self.cfg = cfg
        if params is None:
            params = init_vtamiq_params(cfg, torch.Generator().manual_seed(seed))
        self.params = params.to(self.device).eval()
        self.patch_count = patch_count
        self.patch_num_scales = patch_num_scales
        self.num_repeats = max(1, num_repeats)
        self.sampler = sampler if sampler is not None else PatchSampler()
        self.size_buckets = ([(int(b[0]), int(b[1])) for b in size_buckets]
                             if size_buckets else None)
        self.ingest_uint8 = bool(ingest_uint8)
        self._quantize_int8 = bool(quantize_int8)
        self.compute_dtype = compute_dtype
        self._generator = torch.Generator().manual_seed(seed)
        self._oversize_warned: set = set()
        self._extract = make_extract_fn(self.sampler, ExtractConfig(
            patch_count=patch_count, patch_dim=cfg.vit.patch_size,
            patch_num_scales=patch_num_scales,
            norm_mean=(DEFAULT_NORM_MEAN,) * 3, norm_std=(DEFAULT_NORM_STD,) * 3,
            gather_dtype=str(compute_dtype).replace("torch.", "")))

    def _ensure_quantized(self):
        """Quantize the encoder once, lazily, at the first score; the module
        the caller passed in is left as it is."""
        if not self._quantize_int8:
            return
        self.params = with_child(self.params, "vit", quantize_params_int8(self.params.vit))
        self._quantize_int8 = False

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, cfg: Optional[VTAMIQConfig] = None,
                        **kwargs) -> "VTAMIQScorer":
        """A scorer with the weights of a JAX-package checkpoint. Refuses to
        serve random weights: the file must hold a model state dict and at
        least one of its tensors must merge."""
        scorer = cls(cfg=cfg, **kwargs)
        ckpt = load_checkpoint(checkpoint_path)
        if MODEL_STATE_DICT not in ckpt:
            raise ValueError(
                f"{checkpoint_path!r} has no '{MODEL_STATE_DICT}' — not a "
                f"framework checkpoint (found keys: {sorted(ckpt)})")
        stats = {}
        merge_params(scorer.params, params_from_jax(ckpt[MODEL_STATE_DICT]), stats=stats)
        if stats.get("merged", 0) == 0:
            raise ValueError(
                f"{checkpoint_path!r}: no checkpoint leaf matched the model "
                f"(all {stats.get('kept', 0)} leaves shape-mismatched or "
                f"missing — wrong vit config?); refusing to serve "
                f"random-initialized weights")
        return scorer

    @classmethod
    def from_vit_npz(cls, npz_path: str, cfg: Optional[VTAMIQConfig] = None,
                     **kwargs) -> "VTAMIQScorer":
        """A scorer whose ViT holds ImageNet weights from a ``ViT-B_16.npz``
        layout file (``models/vit.py::load_vit_npz``); the head keeps its
        seeded initial weights."""
        scorer = cls(cfg=cfg, **kwargs)
        with np.load(npz_path) as npz:
            load_vit_npz(npz, scorer.cfg.vit, scorer.params.vit)
        return scorer

    # -- scoring --------------------------------------------------------------

    def executable_key(self, h: int, w: int):
        """The (H, W) an image of true size (h, w) is scored at: its covering
        bucket when ``size_buckets`` is set, else its own shape (also for an
        image larger than every bucket, warned once per shape)."""
        if self.size_buckets:
            key = assign_bucket((h, w), self.size_buckets)
            if key == (int(h), int(w)) and key not in self.size_buckets \
                    and key not in self._oversize_warned:
                self._oversize_warned.add(key)
                log_warn(f"image size {key} exceeds every size bucket "
                         f"{self.size_buckets}; scoring at its exact shape")
            return key
        return (int(h), int(w))

    def _to_host(self, img: np.ndarray) -> np.ndarray:
        if self.ingest_uint8:
            if img.dtype == np.uint8:
                return img
            return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if img.dtype == np.uint8:  # uint8 inputs are valid either way
            return np.asarray(img, np.float32) / 255.0
        return np.asarray(img, np.float32)

    def score_batch(self, refs: Sequence[np.ndarray],
                    dists: Sequence[np.ndarray]) -> np.ndarray:
        """Score aligned lists of reference/distorted images (HWC, float in
        [0, 1] or uint8). Each ref must match its dist's size; pairs of
        different sizes group per scoring shape. Scores average over
        ``num_repeats`` patch draws."""
        if len(refs) != len(dists):
            raise ValueError("refs and dists must have the same length.")
        self._ensure_quantized()
        groups = {}
        for i, (r, d) in enumerate(zip(refs, dists)):
            if r.shape != d.shape:
                raise ValueError(f"pair {i}: ref {r.shape} != dist {d.shape}")
            groups.setdefault(self.executable_key(*r.shape[:2]), []).append(i)

        out = np.empty(len(refs), float)
        vit = self.cfg.vit
        for size, idxs in groups.items():
            attention_fn = choose_attention_fn(
                self.patch_count, train=False, batch_pairs=len(idxs),
                num_heads=vit.num_heads, num_extra_tokens=vit.num_tokens)
            hw = None
            if self.size_buckets is not None:
                raw = np.stack([np.stack([pad_to_bucket(self._to_host(refs[i]), size),
                                          pad_to_bucket(self._to_host(dists[i]), size)])
                                for i in idxs])
                hw = torch.tensor([refs[i].shape[:2] for i in idxs], dtype=torch.int32)
            else:
                raw = np.stack([np.stack([self._to_host(refs[i]), self._to_host(dists[i])])
                                for i in idxs])
            x = torch.from_numpy(raw).to(self.device)
            if self.ingest_uint8:
                x = x.to(torch.float32) * (1.0 / 255.0)
            reps = []
            with torch.inference_mode():
                for _ in range(self.num_repeats):
                    patches, pos, scales = self._extract(x, self._generator, hw)
                    q = vtamiq_forward(self.params, self.cfg, patches, pos, scales,
                                       compute_dtype=self.compute_dtype,
                                       attention_fn=attention_fn)
                    reps.append(q.cpu().numpy().astype(float))
            out[idxs] = np.mean(reps, axis=0)
        return out

    def score_pair(self, ref: np.ndarray, dist: np.ndarray) -> float:
        """Score one ref/dist pair. The direction (higher or lower = better)
        follows the convention the checkpoint was trained with."""
        return float(self.score_batch([ref], [dist])[0])

    def compare(self, ref: np.ndarray, dist_a: np.ndarray, dist_b: np.ndarray) -> float:
        """sigmoid(q_a - q_b) with q_a = score(ref, dist_a)."""
        qs = self.score_batch([ref, ref], [dist_a, dist_b])
        return preference_from_scores(qs[0], qs[1])


def score_pair(ref: np.ndarray, dist: np.ndarray,
               checkpoint: Optional[str] = None, **kwargs) -> float:
    """One-shot functional API (builds a scorer per call)."""
    scorer = (VTAMIQScorer.from_checkpoint(checkpoint, **kwargs)
              if checkpoint else VTAMIQScorer(**kwargs))
    return scorer.score_pair(ref, dist)
