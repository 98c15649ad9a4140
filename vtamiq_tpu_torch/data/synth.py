"""Synthetic IQA pairs in memory: procedural images, graded distortions and
latent quality labels.

Port of the in-memory generators of ``vtamiq_tpu/data/synth.py`` (numpy and
scipy, unchanged): ``make_base_image`` draws structured content, a bank of
12 distortion types applies a severity in (0, 1], and
``severity_to_quality`` gives a quality label monotone in severity with
observer noise. Nothing here reads or writes files (the dataset writers
belong with the host data pipeline).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["make_base_image", "apply_distortion", "severity_to_quality",
           "DISTORTION_BANK"]


# --------------------------------------------------------------------------
# procedural base images
# --------------------------------------------------------------------------

def make_base_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Structured content in [0,1]: smooth color gradients + soft shapes +
    high-frequency texture (so blur/noise/quantization distortions have
    visibly graded effects and diff/SSIM maps are non-trivial)."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.5, 3.0, 2)
        py, px = rng.uniform(0.0, 2 * np.pi, 2)
        img[..., c] = 0.5 + 0.22 * np.sin(2 * np.pi * fy * yy + py) \
            * np.cos(2 * np.pi * fx * xx + px)

    # soft ellipses of random color (object-like regions)
    for _ in range(14):
        cy, cx = rng.uniform(0.0, 1.0, 2)
        ry, rx = rng.uniform(0.04, 0.22, 2)
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        soft = np.clip(1.0 - d2, 0.0, 1.0).astype(np.float32)[..., None]
        color = rng.uniform(0.05, 0.95, 3).astype(np.float32)
        img = img * (1.0 - 0.8 * soft) + 0.8 * soft * color

    # high-frequency texture (two oriented gratings + fine noise)
    for _ in range(2):
        f = rng.uniform(25.0, 60.0)
        th = rng.uniform(0.0, np.pi)
        grat = np.sin(2 * np.pi * f * (yy * np.cos(th) + xx * np.sin(th)))
        img += 0.04 * grat[..., None].astype(np.float32)
    img += rng.normal(0.0, 0.015, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


# --------------------------------------------------------------------------
# graded distortion bank
# --------------------------------------------------------------------------

def _box_blur(img: np.ndarray, radius: int) -> np.ndarray:
    from scipy import ndimage
    size = 2 * radius + 1
    return ndimage.uniform_filter(img, size=(size, size, 1), mode="nearest")


def _pixelate(img: np.ndarray, k: int) -> np.ndarray:
    h, w, c = img.shape
    hk, wk = (h // k) * k, (w // k) * k
    blocks = img[:hk, :wk].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))
    up = np.repeat(np.repeat(blocks, k, axis=0), k, axis=1)
    out = img.copy()
    out[:hk, :wk] = up
    return out


def _d_gauss_noise(rng, img, s):
    return img + rng.normal(0.0, 0.01 + 0.22 * s, img.shape)


def _d_impulse_noise(rng, img, s):
    out = img.copy()
    mask = rng.random(img.shape[:2]) < 0.12 * s
    out[mask] = rng.random((int(mask.sum()), 3))
    return out


def _d_blur(rng, img, s):
    return _box_blur(img, 1 + int(round(5 * s)))


def _d_pixelate(rng, img, s):
    return _pixelate(img, 2 + int(round(12 * s)))


def _d_quantize(rng, img, s):
    levels = max(2, int(round(2 + 36 * (1.0 - s))))
    return np.floor(img * levels) / levels


def _d_contrast(rng, img, s):
    c = 1.0 - 0.75 * s
    return img * c + 0.5 * (1.0 - c)


def _d_brighten(rng, img, s):
    return img + 0.45 * s


def _d_darken(rng, img, s):
    return img - 0.45 * s


def _d_color_shift(rng, img, s):
    shift = rng.uniform(-0.3, 0.3, 3) * s
    return img + shift[None, None, :]


def _d_desaturate(rng, img, s):
    gray = img.mean(axis=-1, keepdims=True)
    return img + (gray - img) * s


def _d_jpeg_blockiness(rng, img, s):
    return _d_quantize(rng, _pixelate(img, 8), 0.4 + 0.6 * s)


def _d_blur_noise(rng, img, s):
    return _d_gauss_noise(rng, _d_blur(rng, img, 0.7 * s), 0.5 * s)


DISTORTION_BANK = [
    _d_gauss_noise, _d_impulse_noise, _d_blur, _d_pixelate, _d_quantize,
    _d_contrast, _d_brighten, _d_darken, _d_color_shift, _d_desaturate,
    _d_jpeg_blockiness, _d_blur_noise,
]


def apply_distortion(rng: np.random.Generator, img: np.ndarray,
                     dist_type: int, level: int, num_levels: int,
                     type_gain: float) -> np.ndarray:
    """Distortion ``dist_type`` (0-based; cycles through the bank with a
    per-type gain so repeated bank entries still differ) at severity
    ``level`` in 1..num_levels."""
    s = min(1.0, (level / num_levels) * type_gain)
    fn = DISTORTION_BANK[dist_type % len(DISTORTION_BANK)]
    return np.clip(fn(rng, img, s), 0.0, 1.0)


def severity_to_quality(rng: np.random.Generator, level: int, num_levels: int,
                        type_gain: float, noise: float = 0.03) -> float:
    """Latent quality in [0,1] (1 = pristine), monotone-decreasing in level
    with observer noise — the shape real MOS studies produce."""
    s = (level / num_levels) * type_gain
    q = math.exp(-2.1 * s)
    return float(np.clip(q + rng.normal(0.0, noise), 0.0, 1.0))


def _type_gains(rng: np.random.Generator, num_types: int) -> np.ndarray:
    return rng.uniform(0.55, 1.35, num_types)
