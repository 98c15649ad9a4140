"""Patch sampling: the budget math, uniform jittered-grid sampling and
weighted CAPS (content-aware patch sampling).

Port of ``vtamiq_tpu/ops/sampling.py``. The random draws are kept apart
from the pure position formulas and are taken from a CPU
``torch.Generator``: a seed then gives the same positions whether the model
runs on the CPU or on the card, and a test can feed the JAX package's own
draws to the formulas.

- Uniform (PERTURBED_SIMPLE) sampling draws a permutation of grid cells
  and jitter uniforms (``uniform_draws``), places the patches on the CPU
  (``uniform_positions``) and returns CPU corners.
- Weighted CAPS mixes a uniform floor, a center prior and a perceptual
  difference map of the item's images into a per-pixel probability map,
  apportions the patch budget over a grid of cells (``weighted_counts``)
  and places each cell's share by a Halton sequence or a jittered grid
  (``weighted_positions``). Its draws (``weighted_draws``) come from the
  CPU generator; everything else runs on the device of the images, batched
  over the items of a batch, with no synchronization with the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import log_warn

GRID_TYPE_HALTON = 0
GRID_TYPE_PERTURBED = 1
GRID_TYPE_PERTURBED_SIMPLE = 2

DIFF_TYPE_MAGNITUDE = 0
DIFF_TYPE_DARK = 1
DIFF_TYPE_MSE = 2
DIFF_TYPE_SSIM = 3

SSIM_WIN = 7          # skimage structural_similarity default window
SSIM_C1 = 0.01 ** 2   # (k1 * L)^2 with L = 1.0
SSIM_C2 = 0.03 ** 2

DEFAULT_NUM_SAMPLES_RATIO = 1.7
GRID_TYPE_PERTURBED_AMOUNT = 0.2

# cell-size heuristics of the stratified sampler
_CELLSIZE_RATIO = 4.0
_PATCHSIZE_RATIO = 0.75
_PATCH2IMAGE_RATIO = 3.0

_CENTERBIAS_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "assets", "centerbias.npy")


# --------------------------------------------------------------------------
# static (Python-int) budget math
# --------------------------------------------------------------------------

def compute_patch_num_scales(patch_num_scales: int, h: int, w: int, patch_dim: int) -> int:
    """Cap the scale count by how many 2x downsamples the image supports."""
    if patch_num_scales <= 1:
        return 1
    dim_max = min(h, w)
    patch_num_scales_max = 0
    while dim_max > 1:
        patch_num_scales_max += 1
        dim_max = (dim_max - patch_dim) / 2
    return max(1, min(patch_num_scales_max - 1, patch_num_scales))


def compute_num_patches_per_scale(patch_count: int, patch_num_scales: int,
                                  scale_num_samples_ratio: float = DEFAULT_NUM_SAMPLES_RATIO) -> np.ndarray:
    """Patch counts per scale: ~2^(ratio*i) normalized to the total budget.
    Index 0 is the coarsest patch size; extraction iterates from the end."""
    num_patches = 2.0 ** (scale_num_samples_ratio * np.arange(patch_num_scales))
    num_patches = np.ceil(num_patches * patch_count / np.sum(num_patches)).astype(int)
    cum = np.cumsum(num_patches)
    for i in range(patch_num_scales):
        if patch_count <= cum[i]:
            num_patches[i] -= cum[i] - patch_count
            num_patches[i + 1:] = 0
            break
    return num_patches


def compute_num_pixels_for_patches(num_patches: Sequence[int], patch_dim: int = 16) -> int:
    """Total sampled pixels across scales."""
    num_patches = np.asarray(num_patches)
    s = len(num_patches)
    pixels_per_patch = 2 ** (2 * np.flip(np.arange(s))) * patch_dim * patch_dim
    return int(np.sum(pixels_per_patch * num_patches))


def compute_num_pixels(patch_count: int, patch_num_scales: int,
                       scale_num_samples_ratio: float = DEFAULT_NUM_SAMPLES_RATIO,
                       patch_dim: int = 16) -> int:
    """Pixel budget of a (patch_count, scales, ratio) configuration."""
    num_patches = compute_num_patches_per_scale(
        patch_count, patch_num_scales, scale_num_samples_ratio)
    return compute_num_pixels_for_patches(num_patches, patch_dim)


# --------------------------------------------------------------------------
# randomized Halton
# --------------------------------------------------------------------------

def _radical_inverse(indices: torch.Tensor, base: int, num_digits: int) -> torch.Tensor:
    """Van der Corput radical inverse with a fixed digit count, in fp32 with
    the digit weights rounded to fp32 (the JAX package's arithmetic)."""
    i = indices.to(torch.int32)
    result = torch.zeros(indices.shape, dtype=torch.float32, device=indices.device)
    f = 1.0 / base
    for _ in range(num_digits):
        result = result + f * (i % base).to(torch.float32)
        i = torch.div(i, base, rounding_mode="floor")
        f = f / base
    return result


def halton_2d(indices: torch.Tensor) -> torch.Tensor:
    """(N,) int -> (2, N) Halton points in [0, 1)^2 (bases 2 and 3)."""
    return torch.stack([_radical_inverse(indices, 2, 24),
                        _radical_inverse(indices, 3, 16)], dim=0)


# --------------------------------------------------------------------------
# probability maps
# --------------------------------------------------------------------------

def local_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Uniform-window local mean over the last two axes of (..., H, W),
    "SAME" padding with edge renormalization: the window sum over the
    in-bounds pixels over their count. As in XLA's "SAME", an even window
    pads (win-1)//2 before and the rest after."""
    h, w = x.shape[-2:]
    lo, hi = (win - 1) // 2, win // 2
    pad = (lo, hi, lo, hi)
    # both pools divide by win*win, which cancels in the ratio
    summed = F.avg_pool2d(F.pad(x.reshape(-1, 1, h, w), pad), win, stride=1)
    ones = torch.ones(1, 1, h, w, dtype=x.dtype, device=x.device)
    count = F.avg_pool2d(F.pad(ones, pad), win, stride=1)
    return (summed / count).reshape(x.shape)


def ssim_map(ref: torch.Tensor, dist: torch.Tensor, win: int = SSIM_WIN,
             c1: float = SSIM_C1, c2: float = SSIM_C2) -> torch.Tensor:
    """Per-pixel SSIM between (..., H, W, C) images in [0, 1] with a uniform
    window (skimage structural_similarity defaults: win 7, k1 0.01, k2 0.03,
    sample covariance normalization n/(n-1)), channels averaged -> (..., H, W)."""
    n = win * win
    cov_norm = n / (n - 1.0)
    ref, dist = ref.movedim(-1, -3), dist.movedim(-1, -3)   # (..., C, H, W)
    mu_r = local_mean(ref, win)
    mu_d = local_mean(dist, win)
    mu_rr = local_mean(ref * ref, win)
    mu_dd = local_mean(dist * dist, win)
    mu_rd = local_mean(ref * dist, win)
    var_r = cov_norm * (mu_rr - mu_r * mu_r)
    var_d = cov_norm * (mu_dd - mu_d * mu_d)
    cov = cov_norm * (mu_rd - mu_r * mu_d)
    num = (2 * mu_r * mu_d + c1) * (2 * cov + c2)
    den = (mu_r * mu_r + mu_d * mu_d + c1) * (var_r + var_d + c2)
    return torch.mean(num / den, dim=-3)


def compute_diff_map(imgs: torch.Tensor, diff_type: int = DIFF_TYPE_MAGNITUDE,
                     diff_pow: float = 1.0) -> torch.Tensor:
    """Perceptual-difference sampling map of (..., K, H, W, 3) images in
    [0, 1], image 0 the reference -> (..., H, W).

    MAGNITUDE: mean |ref - dist| over the distorted images, squared L2 over
    RGB, power diff_pow/2. DARK: Gaussian-of-darkness weighting of the
    reference. MSE: squared error averaged over the distorted images, summed
    over RGB, power diff_pow. SSIM: windowed dissimilarity (1 - SSIM)/2
    averaged over the distorted images, clipped to [0, 1], power diff_pow."""
    ref, dists = imgs[..., 0, :, :, :], imgs[..., 1:, :, :, :]
    if diff_type == DIFF_TYPE_MAGNITUDE:
        diff = torch.mean(torch.abs(ref.unsqueeze(-4) - dists), dim=-4)  # (..., H, W, 3)
    elif diff_type == DIFF_TYPE_DARK:
        sigma = 0.1
        diff = torch.exp(-0.5 * (ref / sigma) ** 2)
    elif diff_type == DIFF_TYPE_MSE:
        sq = torch.mean((ref.unsqueeze(-4) - dists) ** 2, dim=-4)
        return torch.pow(torch.sum(sq, dim=-1), diff_pow)
    elif diff_type == DIFF_TYPE_SSIM:
        dssim = (1.0 - ssim_map(ref.unsqueeze(-4).expand_as(dists), dists)) * 0.5
        diff = torch.clamp(torch.mean(dssim, dim=-3), 0.0, 1.0)
        return torch.pow(diff, diff_pow)
    else:
        raise ValueError(f"Unsupported diff type [{diff_type}]")
    # squared L2 over the color channels; half the power folds in the sqrt
    diff = torch.sum(diff * diff, dim=-1)
    return torch.pow(diff, diff_pow / 2.0)


def gaussian_centerbias_logdensity(size: int = 1024, sigma_y: float = 0.28,
                                   sigma_x: float = 0.40) -> np.ndarray:
    """Analytic anisotropic-Gaussian center-prior log-density, the stand-in
    for the MIT1003-derived ``centerbias.npy`` template."""
    ys = (np.arange(size) + 0.5) / size - 0.5
    xs = (np.arange(size) + 0.5) / size - 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return -0.5 * ((yy / sigma_y) ** 2 + (xx / sigma_x) ** 2)


def load_centerbias_template(path: Optional[str] = None) -> Optional[np.ndarray]:
    """The center-prior log-density from disk, resolved from ``path``, then
    ``$VTAMIQ_CENTERBIAS_PATH``, then ``vtamiq_tpu_torch/assets/centerbias.npy``;
    None when no file exists (callers fall back to
    :func:`gaussian_centerbias_logdensity`)."""
    for cand in (path, os.environ.get("VTAMIQ_CENTERBIAS_PATH"), _CENTERBIAS_ASSET):
        if cand and os.path.isfile(cand):
            template = np.load(cand)
            if template.ndim != 2:
                raise ValueError(f"centerbias template must be 2-D log-density, got "
                                 f"shape {template.shape} from {cand}")
            return np.asarray(template, np.float32)
    return None


def _nearest_indices(n_in: int, n_out: int, device) -> torch.Tensor:
    """Nearest-neighbour source indices of an ``n_in`` -> ``n_out`` resize
    with half-pixel centers (``nearest-exact``), floor((i + 0.5) * n_in /
    n_out) computed in fp32 in that order, as ``jax.image.resize`` does."""
    offsets = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(offsets).to(torch.int64)


def centerbias_prob(template_logdensity: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Resize the log-density to (h, w) (nearest), renormalize, softmax to
    probabilities."""
    t = template_logdensity
    rows = _nearest_indices(t.shape[0], h, t.device)
    cols = _nearest_indices(t.shape[1], w, t.device)
    cb = t[rows[:, None], cols[None, :]]
    cb = cb - torch.logsumexp(cb.reshape(-1), dim=0)
    cb = torch.exp(cb)
    return cb / torch.sum(cb)


# --------------------------------------------------------------------------
# cell allocation
# --------------------------------------------------------------------------

def _largest_remainder_alloc(probs: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Apportion exactly ``num_samples`` over the cells of (..., C) ``probs``
    (each row sums to 1) by deterministic largest-remainder rounding."""
    target = probs * num_samples
    base = torch.floor(target).to(torch.int32)
    remainder = target - base
    deficit = num_samples - torch.sum(base, dim=-1, keepdim=True)
    order = torch.argsort(-remainder, dim=-1, stable=True)
    rank_of_cell = torch.argsort(order, dim=-1, stable=True)
    return base + (rank_of_cell < deficit).to(torch.int32)


def _dissolve_alloc(gumbel_u: torch.Tensor, probs: torch.Tensor, num_samples: int,
                    passes: int = 12) -> torch.Tensor:
    """The reference-matching allocation over (..., C) cell ``probs``:
    ceil(p*N), then ``passes`` rounds that each remove the expected amount
    of one "random dissolve" round, weighted toward low-count cells, on
    real-valued counts in fp32; then the real counts integerized to exactly
    N by remainder-weighted random rounding (Gumbel top-k over the (..., C)
    uniforms ``gumbel_u``) -> (..., C) int32."""
    c = torch.ceil(probs * num_samples)
    for _ in range(passes):
        total = torch.sum(c, dim=-1, keepdim=True)
        d = total - num_samples
        pa = c / total
        pa = (torch.amax(pa, dim=-1, keepdim=True) + 1e-3) - pa
        pa = pa / torch.sum(pa, dim=-1, keepdim=True)
        expected_removal = 1.0 - (1.0 - pa) ** d
        expected_removal = torch.minimum(expected_removal, c)
        s = torch.sum(expected_removal, dim=-1, keepdim=True)
        expected_removal = expected_removal * torch.clamp(d / torch.clamp(s, min=1e-9), max=1.0)
        c = torch.where(d > 0, c - expected_removal, c)
    # force the exact total before integerizing (guards non-converged cases)
    c = c * (num_samples / torch.clamp(torch.sum(c, dim=-1, keepdim=True), min=1e-9))
    base = torch.floor(c).to(torch.int32)
    rem = c - base
    deficit = num_samples - torch.sum(base, dim=-1, keepdim=True)
    gumbel = -torch.log(-torch.log(gumbel_u + 1e-12) + 1e-12)
    score = torch.where(rem > 1e-9, torch.log(rem + 1e-12) + gumbel, -math.inf)
    order = torch.argsort(-score, dim=-1, stable=True)
    rank_of_cell = torch.argsort(order, dim=-1, stable=True)
    return base + (rank_of_cell < deficit).to(torch.int32)


def _cell_layout(h: int, w: int, patch_dim: int, num_samples: int) -> Tuple[int, int, int]:
    """Cell size and grid dims (sh, sw) of weighted stratified sampling."""
    cell_size_d = math.sqrt(h * w / num_samples * _CELLSIZE_RATIO)
    cell_size_min = _PATCHSIZE_RATIO * patch_dim
    cell_size_max = max(h, w) / patch_dim * _PATCH2IMAGE_RATIO
    cell_size = int(max(cell_size_min, min(cell_size_max, cell_size_d)))
    cell_size = max(1, cell_size)
    sh = max(1, int(math.ceil((h - patch_dim) / cell_size)))
    sw = max(1, int(math.ceil((w - patch_dim) / cell_size)))
    return cell_size, sh, sw


def _cell_prob_sums(sample_prob: torch.Tensor, cell_size: int, sh: int, sw: int,
                    patch_dim: int) -> torch.Tensor:
    """(..., H, W) per-pixel probabilities -> (..., sh, sw) normalized sums
    over overlapping windows of cell+P-1 pixels at stride cell (the map
    zero-padded after its end), a VALID window sum."""
    h, w = sample_prob.shape[-2:]
    pad_h = max(0, cell_size * sh + patch_dim - h)
    pad_w = max(0, cell_size * sw + patch_dim - w)
    padded = F.pad(sample_prob, (0, pad_w, 0, pad_h))
    win = cell_size + patch_dim - 1
    # (..., nh, nw, win, win) strided views of the windows
    windows = padded.unfold(-2, win, cell_size).unfold(-2, win, cell_size)
    sums = torch.sum(windows, dim=(-2, -1))[..., :sh, :sw]
    return sums / torch.sum(sums, dim=(-2, -1), keepdim=True)


def _true_region(img_hw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 2) true sizes -> (B, H, W) bool mask of each true region."""
    rows = torch.arange(h, device=img_hw.device) < img_hw[:, 0:1]
    cols = torch.arange(w, device=img_hw.device) < img_hw[:, 1:2]
    return rows[:, :, None] & cols[:, None, :]


# --------------------------------------------------------------------------
# uniform (PERTURBED_SIMPLE) sampling
# --------------------------------------------------------------------------

def _perturbed_simple_grid_dims(h: int, w: int, num_samples: int) -> Tuple[int, int]:
    """Aspect-corrected grid with >= num_samples points."""
    aspect = h / w
    width = max(1, int(math.ceil(math.sqrt(num_samples / aspect))))
    height = max(1, int(math.ceil(width * aspect)))
    while height * width < num_samples:  # guard for extreme aspect ratios
        width += 1
        height = max(1, int(math.ceil(width * aspect)))
    return height, width


def uniform_draws(generator: torch.Generator, num_cells: int,
                  num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random part of uniform sampling, on the CPU: ``num_samples``
    distinct grid cells (int64) and (2, num_samples) fp32 uniforms in
    [0, 1) for the jitter."""
    perm = torch.randperm(num_cells, generator=generator)[:num_samples]
    u = torch.rand(2, num_samples, generator=generator)
    return perm, u


def uniform_positions(perm: torch.Tensor, u: torch.Tensor, h: int, w: int,
                      patch_dim: int,
                      perturbed_amount: float = GRID_TYPE_PERTURBED_AMOUNT,
                      img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pure position formula of PERTURBED_SIMPLE sampling: chosen grid
    cells ``perm`` plus U(-1, 1) * 2 * perturbed_amount jitter (from the
    uniforms ``u``) in cell units -> (2, N) fp32 float top-left corners in
    [0, h-P] x [0, w-P]. With ``img_hw`` (the true size of an image padded
    to an (h, w) bucket) positions span [0, img_hw - P] instead; the grid's
    aspect still follows (h, w)."""
    height, width = _perturbed_simple_grid_dims(h, w, int(perm.shape[0]))
    gi = torch.div(perm, width, rounding_mode="floor").to(torch.float32)
    gj = (perm % width).to(torch.float32)
    jitter = (2.0 * u - 1.0) * 2.0 * perturbed_amount
    pos_i = (gi + jitter[0]) / height + 1.0 / (2.0 * height)
    pos_j = (gj + jitter[1]) / width + 1.0 / (2.0 * width)
    if img_hw is None:
        span_i, span_j = float(h - patch_dim), float(w - patch_dim)
    else:
        span = torch.clamp(torch.as_tensor(img_hw) - patch_dim, min=0).to(torch.float32)
        span_i, span_j = span[0], span[1]
    pos_i = torch.clamp(pos_i, 0.0, 1.0) * span_i
    pos_j = torch.clamp(pos_j, 0.0, 1.0) * span_j
    return torch.stack([pos_i, pos_j], dim=0)


def sample_positions_uniform(generator: torch.Generator, h: int, w: int,
                             patch_dim: int, num_samples: int,
                             perturbed_amount: float = GRID_TYPE_PERTURBED_AMOUNT,
                             img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PERTURBED_SIMPLE sampling: one aspect-corrected jittered grid over the
    image -> (2, N) fp32 float top-left corners, on the CPU."""
    height, width = _perturbed_simple_grid_dims(h, w, num_samples)
    perm, u = uniform_draws(generator, height * width, num_samples)
    return uniform_positions(perm, u, h, w, patch_dim, perturbed_amount, img_hw)


# --------------------------------------------------------------------------
# weighted stratified sampling
# --------------------------------------------------------------------------

class WeightedDraws(NamedTuple):
    """The random part of weighted sampling, fp32 uniforms in [0, 1), with
    any leading batch dims: ``gumbel`` (..., C) for the allocation's random
    rounding, ``shift`` (..., 2, 1) for the Halton sequence's random shift,
    ``slot`` (..., N) for the jittered grid's slot choice, ``jitter``
    (..., 2, N) for its jitter."""
    gumbel: torch.Tensor
    shift: torch.Tensor
    slot: torch.Tensor
    jitter: torch.Tensor

    @classmethod
    def stack(cls, items: Sequence["WeightedDraws"]) -> "WeightedDraws":
        return cls(*(torch.stack(field) for field in zip(*items)))

    def to(self, device) -> "WeightedDraws":
        """The draws on ``device``, moved in one copy."""
        lead = self.gumbel.shape[:-1]
        flat = torch.cat([t.reshape(lead + (-1,)) for t in self], dim=-1).to(device)
        sizes = [t.shape[len(lead):].numel() for t in self]
        return WeightedDraws(*(part.reshape(t.shape) for part, t
                               in zip(flat.split(sizes, dim=-1), self)))


def weighted_draws(generator: torch.Generator, num_cells: int,
                   num_samples: int) -> WeightedDraws:
    """One item's draws for weighted sampling, from the CPU generator."""
    return WeightedDraws(torch.rand(num_cells, generator=generator),
                         torch.rand(2, 1, generator=generator),
                         torch.rand(num_samples, generator=generator),
                         torch.rand(2, num_samples, generator=generator))


def weighted_counts(prob: torch.Tensor, gumbel_u: torch.Tensor, h: int, w: int,
                    patch_dim: int, num_samples: int,
                    img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W) probability maps and (B, C) Gumbel uniforms -> (B, C) int32
    patch counts per cell (row-major over the (sh, sw) cell grid), each row
    summing to ``num_samples``. With ``img_hw`` ((B, 2) true sizes of
    images padded to (h, w)) pixels outside the true region get no
    probability, so pad cells get no patch."""
    cell_size, sh, sw = _cell_layout(h, w, patch_dim, num_samples)
    if img_hw is not None:
        prob = prob * _true_region(img_hw, h, w)
    cell_probs = _cell_prob_sums(prob, cell_size, sh, sw, patch_dim)
    return _dissolve_alloc(gumbel_u, cell_probs.flatten(-2), num_samples)


def weighted_positions(prob: torch.Tensor, draws: WeightedDraws, h: int, w: int,
                       patch_dim: int, num_samples: int,
                       grid_type: int = GRID_TYPE_PERTURBED,
                       perturbed_amount: float = GRID_TYPE_PERTURBED_AMOUNT,
                       img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pure formula of weighted stratified sampling, on the device of
    ``prob``: (B, H, W) probability maps and (B, ...) draws -> (B, 2, N) fp32
    float top-left corners.

    The budget goes over the cells as ``weighted_counts`` says; sample k, in
    cell order, goes to its cell's share. HALTON: sample k takes the k-th
    point of one Halton sequence, shifted by ``draws.shift`` mod 1.
    PERTURBED (and the other types): a jittered grid of width
    ceil(sqrt(n_cell)) per cell, the r-th sample of a cell in a random slot
    of stratum r, plus U(-1, 1) * 2 * perturbed_amount jitter in slot units.
    Cells on the last row and column are partial: their unit offsets scale
    by the fractional cell count. With ``img_hw`` corners clip into the
    true regions."""
    cell_size, sh, sw = _cell_layout(h, w, patch_dim, num_samples)
    dev = prob.device
    bsz = prob.shape[0]
    counts = weighted_counts(prob, draws.gumbel, h, w, patch_dim, num_samples, img_hw)

    # each sample k -> its cell and its rank within the cell
    cum = torch.cumsum(counts, dim=-1)
    k = torch.arange(num_samples, device=dev)
    kk = k.expand(bsz, num_samples).contiguous()
    cell_of_k = torch.searchsorted(cum, kk, right=True)                  # (B, N)
    start_of_cell = cum - counts
    rank_in_cell = kk - torch.gather(start_of_cell, -1, cell_of_k)

    if grid_type == GRID_TYPE_HALTON:
        pos01 = torch.remainder(halton_2d(k) + draws.shift, 1.0)         # (B, 2, N)
    else:
        n_c = torch.clamp(torch.gather(counts, -1, cell_of_k), min=1).to(torch.float32)
        width = torch.ceil(torch.sqrt(n_c))
        slots = width * width
        stride = slots / n_c
        slot = torch.floor((rank_in_cell.to(torch.float32) + draws.slot) * stride)
        slot = torch.minimum(slot, slots - 1.0)
        gi = torch.floor(slot / width)
        gj = slot - gi * width
        jitter = (2.0 * draws.jitter - 1.0) * 2.0 * perturbed_amount
        pos_i01 = torch.clamp((gi + jitter[:, 0]) / width + 0.5 / width, 0.0, 1.0)
        pos_j01 = torch.clamp((gj + jitter[:, 1]) / width + 0.5 / width, 0.0, 1.0)
        pos01 = torch.stack([pos_i01, pos_j01], dim=1)                   # (B, 2, N)

    # partial edge cells: rows scale by the fraction from h, columns from w
    jdec = ((h - patch_dim) / cell_size) % 1.0
    idec = ((w - patch_dim) / cell_size) % 1.0
    jdec = 1.0 if jdec < 1e-3 else jdec
    idec = 1.0 if idec < 1e-3 else idec
    ci = torch.div(cell_of_k, sw, rounding_mode="floor")
    cj = cell_of_k % sw
    row_scale = torch.where(ci == sh - 1, jdec, 1.0)
    col_scale = torch.where(cj == sw - 1, idec, 1.0)

    pos_i = (ci.to(torch.float32) + pos01[:, 0] * row_scale) * cell_size
    pos_j = (cj.to(torch.float32) + pos01[:, 1] * col_scale) * cell_size
    pos_i = torch.clamp(pos_i, min=0.0)
    pos_j = torch.clamp(pos_j, min=0.0)
    if img_hw is None:
        pos_i = torch.clamp(pos_i, max=float(h - patch_dim))
        pos_j = torch.clamp(pos_j, max=float(w - patch_dim))
    else:
        span = torch.clamp(img_hw - patch_dim, min=0).to(torch.float32)
        pos_i = torch.minimum(pos_i, span[:, 0:1])
        pos_j = torch.minimum(pos_j, span[:, 1:2])
    return torch.stack([pos_i, pos_j], dim=1)


# --------------------------------------------------------------------------
# PatchSampler
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PatchSampler:
    """Sampling configuration, with the JAX package's constructor rules:
    GRID_TYPE_PERTURBED_SIMPLE forces the centerbias and diff weights to 0
    (with a warning), so sampling is a uniform jittered grid; any other
    grid type with a centerbias or diff weight samples weighted CAPS."""

    centerbias_weight: float = 0.0
    diff_weight: float = 0.0
    uniform_weight: float = 1.0
    grid_type: int = GRID_TYPE_PERTURBED_SIMPLE
    diff_type: int = DIFF_TYPE_MAGNITUDE
    perturbed_amount: float = GRID_TYPE_PERTURBED_AMOUNT
    centerbias_template: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.grid_type == GRID_TYPE_PERTURBED_SIMPLE:
            if self.centerbias_weight > 0 or self.diff_weight > 0:
                log_warn("PatchSampler: GRID_TYPE_PERTURBED_SIMPLE forces uniform "
                         "sampling; centerbias/diff weights set to 0.")
            self.centerbias_weight = 0.0
            self.diff_weight = 0.0
        self.centerbias_weight = max(0.0, self.centerbias_weight)
        self.diff_weight = max(0.0, self.diff_weight)
        self.uniform_weight = max(0.0, self.uniform_weight)
        if self.centerbias_weight + self.diff_weight + self.uniform_weight < 1e-6:
            raise ValueError("PatchSampler: total weight must be non-zero.")
        if self.centerbias_weight > 0 and self.centerbias_template is None:
            self.centerbias_template = load_centerbias_template()
        if self.centerbias_weight > 0 and self.centerbias_template is None:
            self.centerbias_template = gaussian_centerbias_logdensity()

    @property
    def uses_diff(self) -> bool:
        return self.diff_weight > 0

    @property
    def is_uniform(self) -> bool:
        return self.diff_weight == 0 and self.centerbias_weight == 0

    def compute_diff(self, imgs: torch.Tensor, diff_pow: float = 1.0) -> Optional[torch.Tensor]:
        """(..., K, H, W, 3) images in [0, 1] -> (..., H, W) diff map, or None
        when the diff component is unused."""
        if not self.uses_diff:
            return None
        return compute_diff_map(imgs, self.diff_type, diff_pow)

    def sample_prob(self, h: int, w: int, diff: Optional[torch.Tensor],
                    img_hw: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
        """Per-pixel probability map, the centerbias + diff + uniform mix,
        normalized: (..., H, W) for a (..., H, W) ``diff``, else (H, W), on
        the device of ``diff`` (or ``device``). With ``img_hw`` ((..., 2)
        true sizes of images padded to (h, w)) the diff's std normalization
        runs over the true region only."""
        if device is None:
            device = diff.device if diff is not None else torch.device("cpu")
        prob = torch.full((h, w), self.uniform_weight, dtype=torch.float32, device=device)
        if self.centerbias_weight > 0:
            template = torch.as_tensor(np.asarray(self.centerbias_template, np.float32),
                                       device=device)
            cb = centerbias_prob(template, h, w)
            prob = prob + self.centerbias_weight * (cb / torch.max(cb))
        if self.diff_weight > 0:
            if diff is None:
                raise ValueError("PatchSampler: 'diff' is required for difference-based sampling.")
            if img_hw is None:
                std = torch.std(diff, dim=(-2, -1), correction=0, keepdim=True)
            else:
                lead = diff.shape[:-2]
                valid = _true_region(img_hw.reshape(-1, 2), h, w).reshape(lead + (h, w))
                valid = valid.to(torch.float32)
                count = torch.clamp(torch.sum(valid, dim=(-2, -1), keepdim=True), min=1.0)
                mean = torch.sum(diff * valid, dim=(-2, -1), keepdim=True) / count
                var = torch.sum(((diff - mean) ** 2) * valid, dim=(-2, -1), keepdim=True) / count
                std = torch.sqrt(var)
            normed = torch.where(std > 1e-6, diff / torch.clamp(std, min=1e-6), 0.0)
            prob = prob + self.diff_weight * normed
        return prob / torch.sum(prob, dim=(-2, -1), keepdim=True)

    def sample_batch(self, generator: torch.Generator, h: int, w: int, patch_dim: int,
                     num_samples: int, batch: int, draws_per_item: int = 1,
                     diff: Optional[torch.Tensor] = None,
                     img_hw: Optional[torch.Tensor] = None, device=None,
                     batch_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """(batch, draws_per_item, 2, N) fp32 float top-left corners: for each
        item in turn, ``draws_per_item`` independent draws from the CPU
        ``generator``. ``diff``: (batch, H, W) diff maps; ``img_hw``: (batch, 2)
        true sizes when (h, w) is a padded bucket. ``batch_rows``: (first,
        total): the items are rows first..first+batch of a global batch of
        ``total``; the generator draws for every global item in turn and
        these rows keep theirs (a data-parallel rank's share of one
        process's draws).

        Uniform sampling places the corners on the CPU and returns them
        there. Weighted sampling runs on ``device`` (default: the diff's),
        batched over every draw at once, and returns them there."""
        first, total = (0, batch) if batch_rows is None else batch_rows
        if self.is_uniform:
            hw = None if img_hw is None else torch.as_tensor(img_hw).cpu()
            grid = _perturbed_simple_grid_dims(h, w, num_samples)
            out = []
            for b in range(total):
                if not first <= b < first + batch:  # another rank's item: draw only
                    for _ in range(draws_per_item):
                        uniform_draws(generator, grid[0] * grid[1], num_samples)
                    continue
                out.append(torch.stack([
                    sample_positions_uniform(generator, h, w, patch_dim, num_samples,
                                             self.perturbed_amount,
                                             img_hw=None if hw is None else hw[b - first])
                    for _ in range(draws_per_item)]))
            return torch.stack(out)
        if device is None:
            device = diff.device if diff is not None else torch.device("cpu")
        _, sh, sw = _cell_layout(h, w, patch_dim, num_samples)
        draws = [weighted_draws(generator, sh * sw, num_samples)
                 for _ in range(total * draws_per_item)]
        draws = WeightedDraws.stack(
            draws[first * draws_per_item:(first + batch) * draws_per_item]).to(device)
        hw = None if img_hw is None else torch.as_tensor(img_hw).to(device)
        prob = self.sample_prob(h, w, diff, img_hw=hw, device=device)
        prob = prob.expand(batch, h, w)
        if draws_per_item > 1:
            prob = prob.repeat_interleave(draws_per_item, dim=0)
            hw = None if hw is None else hw.repeat_interleave(draws_per_item, dim=0)
        pos = weighted_positions(prob, draws, h, w, patch_dim, num_samples, self.grid_type,
                                 self.perturbed_amount, img_hw=hw)
        return pos.reshape(batch, draws_per_item, 2, num_samples)

    def sample(self, generator: torch.Generator, h: int, w: int, patch_dim: int,
               num_samples: int, diff: Optional[torch.Tensor] = None,
               img_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One item's (2, N) fp32 float top-left corners; ``diff``: its
        (H, W) diff map; ``img_hw``: its true size when (h, w) is a padded
        bucket. Uniform corners are on the CPU, weighted ones on the diff's
        device."""
        return self.sample_batch(
            generator, h, w, patch_dim, num_samples, 1,
            diff=None if diff is None else diff[None],
            img_hw=None if img_hw is None else torch.as_tensor(img_hw).reshape(1, 2))[0, 0]
