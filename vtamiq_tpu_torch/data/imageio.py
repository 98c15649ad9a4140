"""Host-side image decode and preprocessing (numpy, channels-last).

Port of ``vtamiq_tpu/data/imageio.py``. ``imread`` decodes with the port's
native decoder (``data/native_io.py``). PIL is imported only for a format
that the native build lacks, or where the native decoder cannot be built
(with a warning): a missing codec with no PIL installed raises, naming the
file and the library. HDR EXR files go through ``cv2``, imported when one is
read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import log_warn
from . import native_io

# imagenet normalization constants (torchvision's VGG16 transform params)
IMAGENET_NORM_MEAN = (0.485, 0.456, 0.406)
IMAGENET_NORM_STD = (0.229, 0.224, 0.225)
DEFAULT_NORM_MEAN = (0.5, 0.5, 0.5)
DEFAULT_NORM_STD = (0.5, 0.5, 0.5)

_warned_native = False


def _pil_read(path: str, reason: str) -> np.ndarray:
    """PIL's decode, scaled as the native decoder scales: ``x *
    float32(1/255)`` (``x / 255`` would differ by one rounding)."""
    try:
        from PIL import Image
    except ImportError:
        raise IOError(f"imread: cannot decode [{path}]: {reason}, and PIL is not "
                      f"installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) * np.float32(1.0 / 255.0)


def imread(path: str, is_hdr: bool = False) -> np.ndarray:
    """Read an image as float32 HWC RGB in [0,1] (or raw floats for HDR EXR)."""
    global _warned_native
    if is_hdr:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2
        img = cv2.imread(path, flags=cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"imread: failed to read HDR image [{path}]")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
    if not native_io.available():
        reason = f"the native decoder is unavailable ({native_io.unavailable_reason()})"
        if not _warned_native:
            log_warn(f"imread: {reason}; decoding with PIL.")
            _warned_native = True
        return _pil_read(path, reason)
    try:
        return native_io.decode_rgb(path)
    except native_io.CodecUnavailableError as e:
        return _pil_read(path, str(e))


def transform_img(
    img: np.ndarray,
    crop_params: Optional[Tuple[int, int, int, int]] = None,
    h_flip: bool = False,
    v_flip: bool = False,
    norm_mean: Optional[Tuple[float, float, float]] = None,
    norm_std: Optional[Tuple[float, float, float]] = None,
    grayscale: bool = False,
) -> np.ndarray:
    """Crop / flip / grayscale / normalize a float32 HWC image; 'horizontal'
    flips are left-right, 'vertical' up-down."""
    out = img
    if crop_params is not None:
        i, j, h, w = crop_params
        out = out[i:i + h, j:j + w]
    if h_flip:
        out = out[:, ::-1]
    if v_flip:
        out = out[::-1, :]
    if grayscale:
        lum = (0.2989 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2])
        out = np.stack([lum, lum, lum], axis=-1)
    if norm_mean is not None and norm_std is not None:
        out = (out - np.asarray(norm_mean, np.float32)) / np.asarray(norm_std, np.float32)
    return np.ascontiguousarray(out, dtype=np.float32)
