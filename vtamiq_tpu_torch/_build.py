"""Build and load the port's CUDA kernels: ``nvcc`` into plain-C shared
libraries, loaded with ``ctypes``.

Each ``csrc/*.cu`` source compiles for ``sm_90a`` into its own
``_build/lib<source>.<sha256 of the source, the headers and the flags>.so``;
the ``nvcc`` processes of all sources run at the same time. A library is
written under a temporary name and moved into place with ``os.replace``, so
no lock file exists and a build cut off halfway leaves nothing that a later
build waits on. The sources include no PyTorch header, so a build takes
seconds and needs neither ``ninja`` nor ``torch.utils.cpp_extension``. It
runs at the first kernel launch, never at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_ll_p = ctypes.POINTER(ctypes.c_longlong)
_FLASH_BWD_TAIL = [_c_ll_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p]
# C signatures of the library's entry points (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to a 32-bit int)
_SIGNATURES = {
    "vtamiq_gather_patches": [_c_void_p, _c_void_p, _c_void_p, _c_void_p,
                              _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                              _c_int, _c_float_p, _c_float_p, _c_int, _c_void_p],
    # q, k, v, mask, out, lse, strides, B, H, S, D, is_bf16, stream
    "vtamiq_flash_fwd": [_c_void_p] * 6 + [_c_ll_p, _c_int, _c_int, _c_int, _c_int,
                                           _c_int, _c_void_p],
    # q, k, v, do, lse, delta, mask, dq_acc, dk, dv, strides, B, H, S, D, is_bf16, stream
    "vtamiq_flash_bwd_fused": [_c_void_p] * 10 + _FLASH_BWD_TAIL,
    # q, k, v, do, lse, delta, mask, dq, strides, B, H, S, D, is_bf16, stream
    "vtamiq_flash_bwd_dq": [_c_void_p] * 8 + _FLASH_BWD_TAIL,
    # q, k, v, do, lse, delta, mask, dk, dv, strides, B, H, S, D, is_bf16, stream
    "vtamiq_flash_bwd_dkv": [_c_void_p] * 9 + _FLASH_BWD_TAIL,
}


@dataclass
class BuildInfo:
    paths: List[str]
    seconds: float  # wall time of the parallel build; 0.0 when all were built
    log: str        # nvcc's output (the -Xptxas -v register/smem report)


class Library:
    """Every entry point of ``_SIGNATURES`` as an attribute, from whichever
    of the loaded libraries defines it."""

    def __init__(self, cdlls: List[ctypes.CDLL]):
        for name, argtypes in _SIGNATURES.items():
            for lib in cdlls:
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    setattr(self, name, fn)
                    break
            else:
                raise RuntimeError(f"no kernel library defines {name}")


_lock = threading.Lock()
_lib: Optional[Library] = None
_info: Optional[BuildInfo] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path(src: str) -> str:
    """Where the library of one ``.cu`` source is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.{h.hexdigest()[:16]}.so")


def build() -> BuildInfo:
    """Compile every source whose exact build does not exist, all ``nvcc``
    processes at once; returns the libraries, the build's wall time and
    what nvcc printed."""
    paths = [library_path(src) for src in _sources()]
    todo = [(src, path) for src, path in zip(_sources(), paths) if not os.path.isfile(path)]
    if not todo:
        return BuildInfo(paths, 0.0, "")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    try:
        for src, path in todo:
            fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((cmd, proc, tmp, path))
        logs, failed = [], []
        for cmd, proc, tmp, path in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, path)
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return BuildInfo(paths, seconds, "".join(logs))


def load_library() -> Library:
    """The kernels' entry points, built at first use and loaded once per
    process."""
    global _lib, _info
    with _lock:
        if _lib is None:
            _info = build()
            _lib = Library([ctypes.CDLL(p) for p in _info.paths])
        return _lib


def build_info() -> Optional[BuildInfo]:
    """How this process's libraries were obtained (None before the first load)."""
    return _info
