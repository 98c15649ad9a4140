"""Attention for long patch sequences, and the policy that picks it.

Port of ``vtamiq_tpu/ops/attention.py``: ``flash_attention`` (the kernels of
``ops/flash_kernel.py`` under a ``torch.autograd.Function``: the forward
kernel saves ``out`` and ``lse``, the backward computes
``delta = sum_d dO*O`` and runs the fused or the split backward kernels),
the padding of ``_attn_padded``, ``make_attention_fn`` and
``choose_attention_fn``.

Layout: q, k, v are (B, S, H, D), as ``models/vit.py::mhsa`` builds them;
the kernels read them as (B, H, S, D) views, without a transpose copy.
The sequence pads with zeros to a multiple of ``BLOCK`` (the kernels'
64-token tile; one copy of q, k, v and, in the backward, of dO); padded keys
are masked out, padded queries are computed and dropped, and their dO is
zero. The JAX package's ``blockwise_attention`` (its CPU stand-in for the
Pallas kernels) is not ported: on the CPU the wrappers run the kernels'
plain versions.

The policy keeps the JAX package's decisions shape for shape: the 2048
patch threshold and the 5.5 GiB quadratic-logits budget are TPU figures,
kept only to decide the same shapes; measuring the H100's own is open
(ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import flash_kernel
from .flash_kernel import BLOCK, NEG_INF

# patch counts from which the JAX package may take flash attention
FLASH_ATTENTION_THRESHOLD = 2048
# the JAX package's budget for one layer's fp32 logits on the quadratic
# inference path, in bytes (a TPU memory figure, kept only to decide the
# same shapes the JAX package decides)
QUAD_INFER_LOGITS_BUDGET = int(5.5 * 1024**3)


def _seq_padding(s: int, *blocks: int) -> int:
    blk = max(blocks)
    return -(-s // blk) * blk - s


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the token axis (1) of a (B, S, H, D) tensor."""
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _attn_padded(q, k, v, mask, with_residuals: bool = False):
    """Pad S to a multiple of ``BLOCK`` and run the forward kernel.
    q, k, v (B, S, H, D); mask (B, S) bool or None. Returns out (B, S, H, D)
    and, with ``with_residuals``, the padded (B, H, S', D) views of q, k, v,
    out, the (B, H, S') lse and the padded mask, for the backward."""
    b, s = q.shape[0], q.shape[1]
    pad = _seq_padding(s, BLOCK)
    valid = torch.ones((b, s), dtype=torch.bool, device=q.device) if mask is None \
        else mask.to(torch.bool)
    if pad:
        q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out_t, lse = flash_kernel.flash_forward(qt, kt, vt, valid.contiguous())
    out = out_t.transpose(1, 2)[:, :s]
    if with_residuals:
        return out, (qt, kt, vt, out_t, lse, valid)
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward kernels over the saved (out, lse): no
    forward recompute and no (S, S) tensor."""

    @staticmethod
    def forward(ctx, q, k, v, mask, fused_bwd):
        out, residuals = _attn_padded(q, k, v, mask, with_residuals=True)
        ctx.save_for_backward(*residuals)
        ctx.seq, ctx.fused_bwd = q.shape[1], fused_bwd
        return out

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, out_t, lse, valid = ctx.saved_tensors
        s = ctx.seq
        gt = _pad_seq(g, qt.shape[2] - s).contiguous().transpose(1, 2)
        delta = flash_kernel.delta_of(gt, out_t)
        grads = flash_kernel.flash_backward(qt, kt, vt, gt, lse, delta, valid,
                                            fused=ctx.fused_bwd)
        dq, dk, dv = (t.transpose(1, 2)[:, :s] for t in grads)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None, *,
                    fused_bwd: bool = True) -> torch.Tensor:
    """Masked softmax attention over (B, S, H, D) tensors with an optional
    (B, S) key mask, through the flash kernels (their plain versions for
    CPU tensors). ``fused_bwd`` picks the single-pass backward kernel (5
    products per tile) over the split dq + dkv pair (7). Without gradients
    to record, no residuals are kept."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask, fused_bwd)
    return _attn_padded(q, k, v, mask)


def make_attention_fn(threshold: int = FLASH_ATTENTION_THRESHOLD,
                      fused_bwd: bool = True) -> Callable:
    """``attention_fn(q, k, v, mask)`` for ``models/vit.py::mhsa``: flash
    attention for sequences of at least ``threshold`` tokens, the plain
    quadratic form (fp32 logits and softmax, as the JAX package's) below."""

    def attention_fn(q, k, v, mask):
        if q.shape[1] < threshold:
            d = q.shape[-1]
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
            if mask is not None:
                logits = logits.masked_fill(~mask.to(torch.bool)[:, None, None, :], NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
            return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
        return flash_attention(q, k, v, mask, fused_bwd=fused_bwd)

    return attention_fn


def quad_logits_bytes(batch_rows: int, num_heads: int, seq: int) -> int:
    """fp32 logits of one quadratic attention layer; ``batch_rows`` counts
    encoder rows (two per pair)."""
    return batch_rows * num_heads * seq * seq * 4


def choose_attention_fn(patch_count: int, *, train: bool,
                        batch_pairs: Optional[int] = None,
                        num_heads: int = 12,
                        num_extra_tokens: int = 9) -> Optional[Callable]:
    """The JAX package's choice, shape for shape: None (plain attention) for
    short sequences and for inference whose one-layer logits fit
    ``QUAD_INFER_LOGITS_BUDGET``; the flash attention function for training
    past the threshold and for inference that does not fit (or whose batch
    is unknown)."""
    if patch_count < FLASH_ATTENTION_THRESHOLD:
        return None
    if not train and batch_pairs is not None and quad_logits_bytes(
            2 * batch_pairs, num_heads, patch_count + num_extra_tokens) \
            <= QUAD_INFER_LOGITS_BUDGET:
        return None
    return make_attention_fn()
