"""Patch extraction: sampled corners -> gathered patches, over a 2x pyramid.

Port of ``vtamiq_tpu/ops/extraction.py``. Channels-last throughout: images
(..., H, W, 3), patches (..., N, P, P, 3). Where the JAX package vmaps one
pair's extraction over the batch, the port gathers a whole batch at once:
each scale is one launch of the gather kernel over all B*K images.

The draws come from a CPU ``torch.Generator`` (see ``ops/sampling.py``).
Uniform corners and uv positions are computed on the CPU and moved to the
images' device once per scale. Weighted CAPS computes each item's diff map
once from the raw images, halves it down the pyramid with the images, and
samples every scale's corners on the images' device, batched over the
items.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import gather_kernel
from .sampling import (
    DEFAULT_NUM_SAMPLES_RATIO,
    PatchSampler,
    compute_num_patches_per_scale,
    compute_patch_num_scales,
)


def gather_patches(imgs: torch.Tensor, topleft: torch.Tensor, patch_dim: int,
                   tile_norm: Optional[tuple] = None) -> torch.Tensor:
    """Gather square pixel blocks.

    imgs: (M, H, W, C), gathered as fp32 (a bf16 image converts exactly);
    topleft: (M, 2, N) float or int top-left
    corners, floored and clipped to [0, H-P] x [0, W-P] -> (M, N, P, P, C).
    ``tile_norm``: optional (mean(C,) or None, std(C,) or None, out_dtype):
    each gathered tile becomes (x - mean) * (1/std) in fp32, then out_dtype,
    fused into the kernel; the normalized image is never materialized."""
    h, w = imgs.shape[1], imgs.shape[2]
    topleft = topleft.to(imgs.device)
    ti = torch.clamp(torch.floor(topleft[:, 0]).to(torch.int32), 0, h - patch_dim)
    tj = torch.clamp(torch.floor(topleft[:, 1]).to(torch.int32), 0, w - patch_dim)
    mean, std, out_dtype = tile_norm if tile_norm is not None else (None, None, None)
    inv_std = None
    if mean is not None:
        mean = tuple(float(x) for x in mean)
        inv_std = tuple(1.0 / float(s) for s in std)
    return gather_kernel.gather_patches(
        imgs.float().contiguous(), ti.contiguous(), tj.contiguous(), patch_dim,
        mean, inv_std, out_dtype or imgs.dtype)


def avgpool2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool of (..., H, W, C); an odd trailing row or column is
    dropped. The four terms are summed in the order XLA's reduce_window
    takes them, so the result matches the JAX package bit for bit."""
    h, w = img.shape[-3], img.shape[-2]
    img = img[..., : (h // 2) * 2, : (w // 2) * 2, :]
    a, b = img[..., 0::2, 0::2, :], img[..., 0::2, 1::2, :]
    c, d = img[..., 1::2, 0::2, :], img[..., 1::2, 1::2, :]
    return (((a + b) + c) + d) * 0.25


def avgpool2x_single(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool of a single-channel (..., H, W) map."""
    return avgpool2x(x[..., None])[..., 0]


def get_iqa_patches(
    imgs: torch.Tensor,
    generator: torch.Generator,
    patch_count: int,
    patch_dim: int,
    patch_sampler: PatchSampler,
    patch_num_scales: int = 1,
    scale_num_samples_ratio: float = DEFAULT_NUM_SAMPLES_RATIO,
    use_aligned_patches: bool = True,
    randomize_patch_scale_order: bool = False,
    img_hw: Optional[torch.Tensor] = None,
    tile_norm: Optional[tuple] = None,
    topleft: Optional[List[torch.Tensor]] = None,
    scale_order: Optional[torch.Tensor] = None,
    tensors: Optional[torch.Tensor] = None,
    batch_rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Sample and extract multiscale patches for a batch of image sets.

    Args:
      imgs: (B, K, H, W, 3) fp32 pixels on the compute device: the raw
        images with ``tile_norm`` or ``tensors``, else the model inputs. A
        sampler that weighs by a diff map reads it from the raw [0, 1]
        images, so it needs one of the two.
      generator: CPU generator for the draws (corners and scale order).
      patch_count / patch_dim / patch_num_scales / scale_num_samples_ratio /
        use_aligned_patches / randomize_patch_scale_order: as in the JAX
        package; with aligned patches the K images of an item share corners.
      img_hw: optional (B, 2) int true sizes when (H, W) is a padded bucket;
        sampling, uv normalization and the pyramid confine to them.
      tile_norm: optional (mean, std, out_dtype), see ``gather_patches``.
      topleft / scale_order: injected draws in place of the generator's, for
        tests: per sampled scale a (B, K, 2, N_s) tensor of float corners,
        and a (B, N) permutation of the final patch sequence.
      tensors: optional (B, K, H, W, 3) fp32 or bf16 model inputs that the
        gather reads in place of ``imgs``, pooled down the pyramid in their
        own type (the PU-encoded images of the ``use_pu`` mode, which no
        affine ``tile_norm`` can express); the diff map still reads
        ``imgs``.
      batch_rows: optional (first, total): the B items are rows
        first..first+B of a global batch of ``total``; every draw is made
        for the global batch and these rows keep theirs, so each rank of a
        data-parallel mesh extracts what one process extracts for them.

    Returns patches (B, K, N, P, P, 3), pos (B, K, N, 2) fp32 uv centers in
    [0, 1), scales (B, K, N) int32 or None for a single scale; all on
    ``imgs.device``. Scale 0 is the full-resolution image, sampled with the
    last (largest) entry of the per-scale budget.
    """
    bsz, k_imgs, height, width = (int(s) for s in imgs.shape[:4])
    if patch_count < patch_num_scales:
        raise ValueError("get_iqa_patches(): patch_count must be >= patch_num_scales.")
    patch_num_scales = compute_patch_num_scales(patch_num_scales, height, width, patch_dim)
    num_patches = compute_num_patches_per_scale(
        patch_count, patch_num_scales, scale_num_samples_ratio)
    use_scales = patch_num_scales > 1
    dev = imgs.device
    half = patch_dim // 2
    diff = None
    if patch_sampler.uses_diff and topleft is None:
        if tile_norm is None and tensors is None:
            raise ValueError("get_iqa_patches(): a diff-weighted sampler reads the raw [0, 1] "
                             "images; pass the raw images with tile_norm or tensors")
        diff = patch_sampler.compute_diff(imgs)                      # (B, H, W)

    patches_per_scale, pos_per_scale, scales_per_scale = [], [], []
    cur, cur_diff = (imgs if tensors is None else tensors), diff
    cur_hw = None if img_hw is None else torch.as_tensor(img_hw, dtype=torch.int32).cpu()
    num_samples_total = 0
    sampled = 0
    for scale in range(patch_num_scales):
        n_s = int(num_patches[-scale - 1])
        h, w = int(cur.shape[2]), int(cur.shape[3])
        if n_s > 0:
            if topleft is not None:
                corners = topleft[sampled].to(torch.float32).cpu()
            else:
                corners = patch_sampler.sample_batch(
                    generator, h, w, patch_dim, n_s, bsz,
                    1 if use_aligned_patches else k_imgs, diff=cur_diff, img_hw=cur_hw,
                    device=dev, batch_rows=batch_rows).expand(bsz, k_imgs, 2, n_s)
            sampled += 1
            if cur_hw is None:
                hw_ratio = torch.tensor([h - half, w - half], dtype=torch.float32)
                hw_ratio = hw_ratio.expand(bsz, 2)
            else:
                hw_ratio = torch.clamp(cur_hw - half, min=1).to(torch.float32)
            hw_ratio = hw_ratio.to(corners.device)
            uv = (corners.transpose(-1, -2) + half) / hw_ratio[:, None, None, :]
            pos_per_scale.append(torch.clamp(uv, 0.0, 1.0 - 1e-6))   # (B, K, N_s, 2)

            flat = gather_patches(cur.reshape(bsz * k_imgs, h, w, cur.shape[-1]),
                                  corners.reshape(bsz * k_imgs, 2, n_s), patch_dim,
                                  tile_norm=tile_norm)
            patches_per_scale.append(flat.reshape((bsz, k_imgs) + flat.shape[1:]))
            scales_per_scale.append(torch.full((bsz, k_imgs, n_s), scale, dtype=torch.int32))
            num_samples_total += n_s

        if patch_count <= num_samples_total or scale == patch_num_scales - 1:
            break
        cur = avgpool2x(cur)
        if cur_diff is not None:
            cur_diff = avgpool2x_single(cur_diff)
        if cur_hw is not None:
            cur_hw = cur_hw // 2  # the true region shrinks with the pyramid

    patches = torch.cat(patches_per_scale, dim=2)
    pos = torch.cat(pos_per_scale, dim=2)
    scales = torch.cat(scales_per_scale, dim=2) if use_scales else None

    if randomize_patch_scale_order:
        n = patches.shape[2]
        if scale_order is None:
            first, total = (0, bsz) if batch_rows is None else batch_rows
            scale_order = torch.stack([torch.randperm(n, generator=generator)
                                       for _ in range(total)])[first:first + bsz]
        order = scale_order.to(torch.int64)[:, None, :].expand(bsz, k_imgs, n)
        patches = torch.take_along_dim(patches, order.to(dev)[..., None, None, None], dim=2)
        pos = torch.take_along_dim(pos, order.to(pos.device)[..., None], dim=2)
        if scales is not None:
            scales = torch.take_along_dim(scales, order, dim=2)
    return patches, pos.to(dev), None if scales is None else scales.to(dev)

