"""Color-space conversions and PU (perceptually uniform) encoding.

Port of ``vtamiq_tpu/utils/color_spaces.py``: the numpy functions as the
JAX package has them (sRGB <-> linear, luminance, XYZ, CIELab, PU21), and
torch versions of its device functions for the ``use_pu`` input mode
(``srgb_to_linear_torch``, ``pu21_encode_torch``,
``pu_display_encode_torch``).

The torch versions compute in fp32 with the constants rounded to fp32, op
for op as XLA compiles the JAX functions on the CPU: a division by a
constant is a product with its fp32 reciprocal and ``a * b + c`` rounds
once (fused). Powers go through fp64; XLA's CPU power (the C library's
``powf``) and this one differ in the last bit of about 1 value in 2,000.
"""

from __future__ import annotations

import numpy as np

# sRGB <-> linear ------------------------------------------------------------

def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    srgb = np.asarray(srgb, dtype=np.float32)
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(lin: np.ndarray) -> np.ndarray:
    lin = np.asarray(lin, dtype=np.float32)
    return np.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * np.clip(lin, 0, None) ** (1 / 2.4) - 0.055).astype(np.float32)


# luminance / XYZ ------------------------------------------------------------

_RGB2XYZ = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=np.float32)

_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)

# D65 reference white
_D65 = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)


def rgb_to_luminance(rgb_linear: np.ndarray) -> np.ndarray:
    """Relative luminance Y from linear RGB (Rec.709 primaries)."""
    rgb_linear = np.asarray(rgb_linear, dtype=np.float32)
    return rgb_linear @ _RGB2XYZ[1]


def rgb_to_xyz(rgb_linear: np.ndarray) -> np.ndarray:
    return np.asarray(rgb_linear, dtype=np.float32) @ _RGB2XYZ.T


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    return np.asarray(xyz, dtype=np.float32) @ _XYZ2RGB.T


# CIELab ----------------------------------------------------------------------

def _lab_f(t: np.ndarray) -> np.ndarray:
    delta = 6.0 / 29.0
    return np.where(t > delta ** 3, np.cbrt(t), t / (3 * delta ** 2) + 4.0 / 29.0)


def _lab_f_inv(t: np.ndarray) -> np.ndarray:
    delta = 6.0 / 29.0
    return np.where(t > delta, t ** 3, 3 * delta ** 2 * (t - 4.0 / 29.0))


def xyz_to_lab(xyz: np.ndarray) -> np.ndarray:
    xyz = np.asarray(xyz, dtype=np.float32) / _D65
    fx, fy, fz = _lab_f(xyz[..., 0]), _lab_f(xyz[..., 1]), _lab_f(xyz[..., 2])
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return np.stack([L, a, b], axis=-1)


def lab_to_xyz(lab: np.ndarray) -> np.ndarray:
    lab = np.asarray(lab, dtype=np.float32)
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    xyz = np.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], axis=-1)
    return xyz * _D65


def rgb_to_lab(rgb_linear: np.ndarray) -> np.ndarray:
    return xyz_to_lab(rgb_to_xyz(rgb_linear))


# PU21 encoding ----------------------------------------------------------------

# PU21 "banding & glare" coefficients (Mantiuk & Azimi 2021, public spec):
# encodes absolute luminance [0.005, 10000] cd/m^2 into an approximately
# perceptually uniform [0, ~600] range.
_PU21_P = np.array([0.353487901, 0.3734658629, 8.277049286e-05,
                    0.9062562627, 0.09150303166, 0.9099517204, 596.3148142],
                   dtype=np.float64)


def pu21_encode(luminance: np.ndarray) -> np.ndarray:
    """Absolute luminance (cd/m^2) -> PU21-encoded values."""
    y = np.clip(np.asarray(luminance, dtype=np.float64), 0.005, 10000.0)
    p = _PU21_P
    v = p[6] * (((p[0] + p[1] * y ** p[3]) / (1.0 + p[2] * y ** p[3])) ** p[4] - p[5])
    return np.maximum(v, 0.0).astype(np.float32)


def pu21_decode(v: np.ndarray) -> np.ndarray:
    """Inverse of pu21_encode (numerical, vectorized bisection)."""
    v = np.asarray(v, dtype=np.float64)
    lo = np.full(v.shape, 0.005)
    hi = np.full(v.shape, 10000.0)
    for _ in range(50):
        mid = np.sqrt(lo * hi)  # geometric bisection (log-spaced domain)
        too_low = pu21_encode(mid) < v
        lo = np.where(too_low, mid, lo)
        hi = np.where(too_low, hi, mid)
    return np.sqrt(lo * hi).astype(np.float32)


def _f32(c: float) -> float:
    return float(np.float32(c))


def _pow_f32(x, exponent: float):
    """fp32 x ** fp32(exponent), through fp64: correctly rounded but for a
    double rounding."""
    import torch
    return torch.pow(x.double(), _f32(exponent)).to(torch.float32)


def _fma_f32(a, b: float, c: float):
    """fp32 a * b + c with one rounding of the product's sum, as XLA fuses
    it (the fp64 product of fp32 factors is exact)."""
    import torch
    return (a.double() * _f32(b) + _f32(c)).to(torch.float32)


def srgb_to_linear_torch(srgb):
    """sRGB -> linear on an fp32 tensor (the curve of srgb_to_linear)."""
    import torch
    srgb = srgb.to(torch.float32)
    curved = _pow_f32((torch.clamp(srgb, min=0.0) + _f32(0.055)) * _f32(1 / np.float32(1.055)),
                      2.4)
    return torch.where(srgb <= _f32(0.04045), srgb * _f32(1 / np.float32(12.92)), curved)


def pu21_encode_torch(luminance):
    """PU21 encoding of an fp32 tensor of luminance in cd/m^2 (the
    coefficients of pu21_encode)."""
    import torch
    p = _PU21_P
    y = torch.clamp(luminance.to(torch.float32), _f32(0.005), 10000.0)
    yp = _pow_f32(y, p[3])
    ratio = _fma_f32(yp, p[1], p[0]) / _fma_f32(yp, p[2], 1.0)
    return torch.clamp(_f32(p[6]) * (_pow_f32(ratio, p[4]) - _f32(p[5])), min=0.0)


def pu_display_encode_torch(srgb, peak_luminance: float = 100.0):
    """The ``use_pu`` model inputs of sRGB images in [0, 1] on fp32 tensors:
    per channel sRGB -> linear, the SDR display model (black level 0.5
    cd/m^2), PU21, over PU21 of the peak (``pu_encode_srgb``)."""
    import torch
    lum = _fma_f32(srgb_to_linear_torch(srgb), peak_luminance - 0.5, 0.5)
    peak = float(pu21_encode_torch(torch.tensor([peak_luminance], dtype=torch.float32)))
    return pu21_encode_torch(lum) * _f32(1 / np.float32(peak))


def display_model_sdr(srgb: np.ndarray, peak_luminance: float = 100.0,
                      black_level: float = 0.5) -> np.ndarray:
    """Simple SDR display model: sRGB [0,1] -> absolute luminance cd/m^2
    (gamma display + black level), the front end of the use_pu pipeline."""
    lin = srgb_to_linear(np.asarray(srgb, dtype=np.float32))
    lum = rgb_to_luminance(lin) if lin.ndim >= 1 and lin.shape[-1] == 3 else lin
    return (peak_luminance - black_level) * lum + black_level


def pu_encode_srgb(srgb: np.ndarray, peak_luminance: float = 100.0,
                   normalize: bool = True) -> np.ndarray:
    """Full use_pu path: sRGB image -> display simulation -> PU21 encoding,
    optionally rescaled to ~[0,1] for network input."""
    srgb = np.asarray(srgb, dtype=np.float32)
    lin = srgb_to_linear(srgb)
    lum = (peak_luminance - 0.5) * lin + 0.5  # per-channel display model
    pu = pu21_encode(lum)
    if normalize:
        pu = pu / pu21_encode(np.asarray(peak_luminance))
    return pu.astype(np.float32)
