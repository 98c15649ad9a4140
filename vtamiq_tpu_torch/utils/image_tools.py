"""Image manipulation helpers (a copy of ``vtamiq_tpu/utils/image_tools.py``).

Numpy, channels-last. Not on the hot path (device-side ops live in
``vtamiq_tpu_torch.ops``); these serve dataset preparation, visualization
and metrics. ``resize_image`` imports cv2, or else PIL, when it is called.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def normalize_array(a: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    a = np.asarray(a, dtype=float)
    amin, amax = a.min(), a.max()
    return (a - amin) / max(amax - amin, eps)


def resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize via cv2 when available, else PIL."""
    try:
        import cv2
        return cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    except ImportError:  # pragma: no cover
        from PIL import Image
        arr = np.asarray(img)
        was_float = np.issubdtype(arr.dtype, np.floating)
        im = Image.fromarray((arr * 255).astype(np.uint8) if was_float else arr)
        out = np.asarray(im.resize((width, height), Image.BILINEAR))
        return out.astype(np.float32) / 255.0 if was_float else out


def crop_image(img: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    return img[i:i + h, j:j + w]


def center_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    i = max(0, (ih - h) // 2)
    j = max(0, (iw - w) // 2)
    return img[i:i + h, j:j + w]


def extract_windows(img: np.ndarray, window: Tuple[int, int],
                    stride: Tuple[int, int]) -> np.ndarray:
    """Sliding-window view: (H, W[, C]) -> (nH, nW, wh, ww[, C]).

    Stride-tricks equivalent of skimage's view_as_windows (used by the
    reference's cell-sum reduction, patch_sampling.py:271)."""
    wh, ww = window
    sh, sw = stride
    h, w = img.shape[:2]
    nh = (h - wh) // sh + 1
    nw = (w - ww) // sw + 1
    strides = (img.strides[0] * sh, img.strides[1] * sw) + img.strides
    shape = (nh, nw, wh, ww) + img.shape[2:]
    return np.lib.stride_tricks.as_strided(img, shape=shape, strides=strides,
                                           writeable=False)


def reinhard_tmo(img: np.ndarray, white_point: Optional[float] = None) -> np.ndarray:
    """Simple Reinhard tone-mapping for HDR display (TMO helper parity)."""
    img = np.asarray(img, dtype=np.float32)
    if white_point is None:
        return img / (1.0 + img)
    w2 = white_point * white_point
    return img * (1.0 + img / w2) / (1.0 + img)
