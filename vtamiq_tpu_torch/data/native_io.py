"""ctypes bindings for the port's host image decoder (``csrc/image_io.cpp``).

Decodes BMP, JPEG where the build found libjpeg, and PNG where it found
libpng or, failing that, zlib (the source's own PNG decoder),
straight into float32 HWC buffers with the flips and the normalization
fused, one image at a time or a batch on a thread pool. The library builds
with ``g++`` at first use (``_build.build_host``), never at import.

Nothing here falls back to another decoder. A file of a codec that the build
lacks raises ``CodecUnavailableError``, which names the missing library;
``imread`` (``data/imageio.py``) decides what to do about it.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import _build

_STATUS = {1: "cannot open the file", 2: "unreadable or unsupported image file"}
_MISSING = {3: ("jpeg", "libjpeg (jpeglib.h)"),
            4: ("png", "libpng (png.h) and zlib (zlib.h)")}


class CodecUnavailableError(IOError):
    """The file's format needs a codec library the decoder was built without."""

    def __init__(self, path: str, codec: str, library: str):
        super().__init__(f"[{path}] is a {codec.upper()} file and the native decoder was "
                         f"built without {library}")
        self.path, self.codec, self.library = path, codec, library


def _raise(status: int, path: str, what: str):
    if status in _MISSING:
        raise CodecUnavailableError(path, *_MISSING[status])
    raise IOError(f"{what} failed for [{path}]: {_STATUS.get(status, f'status {status}')}")


_lock = threading.Lock()
_lib = None
_info: Optional[_build.HostBuildInfo] = None

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)


def _load():
    global _lib, _info
    with _lock:
        if _lib is None:
            info = _build.build_host()
            lib = ctypes.CDLL(info.path)
            lib.vtamiq_io_codecs.argtypes = []
            lib.vtamiq_io_codecs.restype = ctypes.c_int
            lib.vtamiq_image_size.argtypes = [ctypes.c_char_p, _c_int_p, _c_int_p]
            lib.vtamiq_image_size.restype = ctypes.c_int
            lib.vtamiq_decode_rgb_f32.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, _c_float_p, _c_float_p]
            lib.vtamiq_decode_rgb_f32.restype = ctypes.c_int
            lib.vtamiq_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                _c_int_p, _c_int_p, ctypes.POINTER(ctypes.c_long), _c_int_p, _c_int_p,
                _c_float_p, _c_float_p, ctypes.c_int, _c_int_p]
            lib.vtamiq_decode_batch.restype = ctypes.c_int
            _info, _lib = info, lib
        return _lib


_available: Optional[bool] = None
_unavailable_reason = ""


def available() -> bool:
    """Whether the decoder builds and loads here (built at the first call)."""
    global _available, _unavailable_reason
    if _available is None:
        try:
            _load()
            _available = True
        except Exception as e:  # noqa: BLE001 — reported by unavailable_reason()
            _available, _unavailable_reason = False, f"{type(e).__name__}: {e}"
    return _available


def unavailable_reason() -> str:
    return _unavailable_reason


def build_info() -> _build.HostBuildInfo:
    """The decoder's build: library path, build seconds, codecs it holds."""
    _load()
    return _info


def codecs() -> List[str]:
    """The codecs this build holds: "bmp", "jpeg" where libjpeg was found,
    "png" (libpng) or "png-zlib" (the source's PNG decoder on zlib)."""
    mask = _load().vtamiq_io_codecs()
    names = [name for bit, name in ((1, "bmp"), (2, "jpeg")) if mask & bit]
    if mask & 4:
        names.append("png-zlib" if mask & 8 else "png")
    return names


def decodes(fmt: str) -> bool:
    """Whether this build decodes ``fmt`` ("bmp", "jpeg" or "png")."""
    return any(c.split("-")[0] == fmt for c in codecs())


def _norm(values):
    if values is None:
        return None, None
    arr = np.ascontiguousarray(values, np.float32)
    return arr, arr.ctypes.data_as(_c_float_p)


def image_size(path: str) -> Tuple[int, int]:
    """(h, w) of an image from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    status = _load().vtamiq_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if status:
        _raise(status, path, "vtamiq_image_size")
    return h.value, w.value


def decode_rgb(path: str, h: Optional[int] = None, w: Optional[int] = None,
               h_flip: bool = False, v_flip: bool = False,
               norm_mean=None, norm_std=None) -> np.ndarray:
    """Decode one image to float32 (h, w, 3); [0,1] or normalized."""
    lib = _load()
    if h is None or w is None:
        h, w = image_size(path)
    out = np.empty((h, w, 3), np.float32)
    mean, mean_p = _norm(norm_mean)
    std, std_p = _norm(norm_std)
    status = lib.vtamiq_decode_rgb_f32(path.encode(), out.ctypes.data, h, w, 0,
                                       int(h_flip), int(v_flip), mean_p, std_p)
    if status:
        _raise(status, path, "vtamiq_decode_rgb_f32")
    return out


def default_threads() -> int:
    return max(1, (os.cpu_count() or 1) - 1)


def decode_batch_into(paths: Sequence[str], sizes: Sequence[Tuple[int, int]],
                      out_ptrs: Sequence[int], row_strides: Sequence[int],
                      h_flips: Optional[Sequence[bool]] = None,
                      v_flips: Optional[Sequence[bool]] = None,
                      norm_mean=None, norm_std=None, num_threads: int = 0) -> None:
    """Decode ``paths[i]`` (true size ``sizes[i]``) into the float32 buffer at
    address ``out_ptrs[i]``, rows ``row_strides[i]`` floats apart (the top-left
    corner of a padded slot, or a whole tensor of its own). The caller keeps
    the buffers alive and large enough. Raises on the first failed item."""
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.c_void_p * n)(*out_ptrs)
    c_hs = (ctypes.c_int * n)(*[int(s[0]) for s in sizes])
    c_ws = (ctypes.c_int * n)(*[int(s[1]) for s in sizes])
    c_strides = (ctypes.c_long * n)(*[int(s) for s in row_strides])
    c_hf = (ctypes.c_int * n)(*[int(b) for b in (h_flips or [0] * n)])
    c_vf = (ctypes.c_int * n)(*[int(b) for b in (v_flips or [0] * n)])
    statuses = (ctypes.c_int * n)()
    mean, mean_p = _norm(norm_mean)
    std, std_p = _norm(norm_std)
    failures = lib.vtamiq_decode_batch(c_paths, n, c_outs, c_hs, c_ws, c_strides, c_hf, c_vf,
                                       mean_p, std_p, num_threads or default_threads(),
                                       statuses)
    if failures:
        i = next(i for i in range(n) if statuses[i])
        _raise(statuses[i], paths[i], f"vtamiq_decode_batch ({failures}/{n} failed)")


def decode_batch(paths: Sequence[str], sizes: Sequence[Tuple[int, int]],
                 h_flips: Optional[Sequence[bool]] = None,
                 v_flips: Optional[Sequence[bool]] = None,
                 norm_mean=None, norm_std=None, num_threads: int = 0) -> list:
    """Decode many images in parallel; a list of float32 (h, w, 3) arrays
    in input order."""
    outs = [np.empty((int(h), int(w), 3), np.float32) for h, w in sizes]
    decode_batch_into(paths, sizes, [o.ctypes.data for o in outs],
                      [int(w) * 3 for _, w in sizes], h_flips, v_flips, norm_mean,
                      norm_std, num_threads)
    return outs
