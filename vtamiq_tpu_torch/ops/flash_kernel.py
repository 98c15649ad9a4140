"""Flash attention: the CUDA kernels' wrappers and their plain PyTorch
versions.

Replaces the Pallas TPU kernels of ``vtamiq_tpu/ops/attention.py``:

- ``flash_forward``          <- ``_flash_fwd_kernel`` (``_flash_forward``)
- ``flash_backward_fused``   <- ``_flash_bwd_fused_kernel``
- ``flash_backward_dq``      <- ``_flash_bwd_dq_kernel``
- ``flash_backward_dkv``     <- ``_flash_bwd_dkv_kernel``

The kernels are ``csrc/flash_attention.cu``. Tensors are (B, H, S, D)
views: any batch, head and token strides, a contiguous D axis, so the
model's (B, S, H, D) projections pass as ``.transpose(1, 2)`` views without
a copy. ``mask`` is (B, S) bool, False = invalid key; ``lse`` and ``delta``
are (B, H, S) fp32. The kernels take bf16 or fp32 with D = 64 and S a
multiple of ``BLOCK`` (the caller pads, ``ops/attention.py``); the plain
versions take any S and D.

Each wrapper runs its kernel for tensors on the card and its plain version
for tensors on the CPU; there is no other fallback. ``launches`` counts each
kernel's launches (the plain versions never add to it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

NEG_INF = -1e30
BLOCK = 64        # the kernels' query and key tile (tokens)
HEAD_DIM = 64     # the only head dimension the kernels are built for
# bytes of fp32 (S, S) temporaries per chunk of batch rows in the plain versions
_PLAIN_CHUNK_BYTES = 2 * 1024**3

launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check(q, k, v, mask, do=None, lse=None, delta=None):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, s, d = q.shape
    named = [("k", k), ("v", v)] + ([("do", do)] if do is not None else [])
    for name, t in named:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                             f"q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    if mask.shape != (b, s) or mask.dtype != torch.bool or mask.device != q.device:
        raise ValueError(f"mask must be ({b}, {s}) bool on {q.device}, got "
                         f"{tuple(mask.shape)} {mask.dtype} {mask.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (b, h, s) or t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError(f"{name} must be ({b}, {h}, {s}) float32 on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    return b, h, s, d


def _check_kernel(b, h, s, d, tensors, vectors):
    if d != HEAD_DIM:
        raise ValueError(f"the flash kernels take head dim {HEAD_DIM}, got {d}")
    if s % BLOCK:
        raise ValueError(f"the flash kernels take S a multiple of {BLOCK}, got {s}: "
                         f"pad the sequence (ops/attention.py::_attn_padded)")
    if b > 65535 or h > 65535:
        raise ValueError(f"B {b} and H {h} must be at most 65535")
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"the flash kernels need a contiguous D axis, got strides "
                             f"{t.stride()}")
    for t in vectors:
        if not t.is_contiguous():
            raise ValueError("mask, lse and delta must be contiguous")


def _strides(*tensors, count=None):
    """(batch, head, token) element strides of each tensor, padded with
    zeros to ``count`` tensors, as the C ``long long`` array."""
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += [0] * (3 * (count or len(tensors)) - len(vals))
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _on_card(t: torch.Tensor, who: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {t.device}")
    return True


# ---------------------------------------------------------------------------
# plain versions (dense fp32 per chunk of batch rows)
# ---------------------------------------------------------------------------

def _row_chunks(b, h, s, temporaries):
    per_row = h * s * s * 4 * temporaries
    step = max(1, int(_PLAIN_CHUNK_BYTES // max(per_row, 1)))
    return [(i, min(b, i + step)) for i in range(0, b, step)]


def _masked_logits(qf, kf, mask, scale):
    """(q k^T) * scale in fp32 with invalid keys at NEG_INF."""
    logits = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
    return logits.masked_fill_(~mask[:, None, None, :], NEG_INF)


def flash_forward_plain(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function, dense: (out (B, H, S, D) in q.dtype,
    lse (B, H, S) fp32). p is rounded to v's dtype before the p v product,
    as in the kernel; l is clamped at 1e-30."""
    b, h, s, d = _check(q, k, v, mask)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for i, j in _row_chunks(b, h, s, 2):
        logits = _masked_logits(q[i:j].float(), k[i:j].float(), mask[i:j], scale)
        m = logits.amax(-1, keepdim=True)
        p = logits.sub_(m).exp_()
        l = p.sum(-1, keepdim=True).clamp_min_(1e-30)
        pv = torch.matmul(p.to(v.dtype).float(), v[i:j].float())
        out[i:j] = (pv / l).to(q.dtype)
        lse[i:j] = (m + torch.log(l)).squeeze(-1)
    return out, lse


def flash_backward_plain(q, k, v, do, lse, delta, mask):
    """The backward kernels' function, dense (FlashAttention-2 formulas):
    p = exp(logits - lse), dv = p^T do, dp = do v^T,
    ds = p (dp - delta) * scale, dk = ds^T q, dq = ds k; p is rounded to
    do's dtype and ds to q's before their products, as in the kernels.
    Returns (dq, dk, dv) in the inputs' dtype."""
    b, h, s, d = _check(q, k, v, mask, do, lse, delta)
    scale = 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i, j in _row_chunks(b, h, s, 3):
        qf, kf, vf, dof = (t[i:j].float() for t in (q, k, v, do))
        p = _masked_logits(qf, kf, mask[i:j], scale).sub_(lse[i:j, :, :, None]).exp_()
        dv[i:j] = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof).to(v.dtype)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p.mul_(dp.sub_(delta[i:j, :, :, None])).mul_(scale).to(q.dtype).float()
        del dp
        dk[i:j] = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
        dq[i:j] = torch.matmul(ds, kf).to(q.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_forward(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of masked softmax attention; arguments as
    ``flash_forward_plain``. ``out`` has q's strides."""
    if not _on_card(q, "flash_forward"):
        return flash_forward_plain(q, k, v, mask)
    b, h, s, d = _check(q, k, v, mask)
    _check_kernel(b, h, s, d, (q, k, v), (mask,))
    from .._build import load_library
    lib = load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", lib.vtamiq_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr(), out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out),
                b, h, s, d, int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    return out, lse


def _bwd_args(q, k, v, do, lse, delta, mask):
    b, h, s, d = _check(q, k, v, mask, do, lse, delta)
    _check_kernel(b, h, s, d, (q, k, v, do), (mask, lse, delta))
    from .._build import load_library
    return (b, h, s, d), load_library()


def flash_backward_fused(q, k, v, do, lse, delta, mask):
    """(dq, dk, dv) from the single-pass backward kernel (dq summed in fp32
    with atomics, then cast); arguments as ``flash_backward_plain``."""
    if not _on_card(q, "flash_backward_fused"):
        return flash_backward_plain(q, k, v, do, lse, delta, mask)
    (b, h, s, d), lib = _bwd_args(q, k, v, do, lse, delta, mask)
    dq_acc = torch.zeros_like(q, dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_fused", lib.vtamiq_flash_bwd_fused, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                mask.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _strides(q, k, v, do, dq_acc, dk, dv), b, h, s, d,
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return dq_acc.to(q.dtype), dk, dv


def flash_backward_dq(q, k, v, do, lse, delta, mask) -> torch.Tensor:
    """dq from the split backward's dq kernel."""
    if not _on_card(q, "flash_backward_dq"):
        return flash_backward_plain(q, k, v, do, lse, delta, mask)[0]
    (b, h, s, d), lib = _bwd_args(q, k, v, do, lse, delta, mask)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dq", lib.vtamiq_flash_bwd_dq, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                mask.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq, count=7),
                b, h, s, d, int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the split backward's dkv kernel."""
    if not _on_card(q, "flash_backward_dkv"):
        return flash_backward_plain(q, k, v, do, lse, delta, mask)[1:]
    (b, h, s, d), lib = _bwd_args(q, k, v, do, lse, delta, mask)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the dq slot of the stride array is unused by this kernel
    strides = _strides(q, k, v, do, q, dk, dv)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dkv", lib.vtamiq_flash_bwd_dkv, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                mask.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, b, h, s, d,
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return dk, dv


def flash_backward(q, k, v, do, lse, delta, mask, fused: bool = True):
    """(dq, dk, dv): the fused kernel, or the split dq and dkv kernels."""
    if fused:
        return flash_backward_fused(q, k, v, do, lse, delta, mask)
    if not _on_card(q, "flash_backward"):
        return flash_backward_plain(q, k, v, do, lse, delta, mask)
    dq = flash_backward_dq(q, k, v, do, lse, delta, mask)
    return (dq,) + flash_backward_dkv(q, k, v, do, lse, delta, mask)


def delta_of(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = sum_d dO * O in fp32, (B, H, S): the backward's per-query
    term, computed outside the kernels as the JAX package does."""
    return (do.float() * out.float()).sum(-1).contiguous()
