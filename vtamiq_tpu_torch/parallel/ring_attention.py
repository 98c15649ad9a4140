"""Ring attention: sequence parallelism for long patch sequences.

Port of ``vtamiq_tpu/parallel/ring_attention.py``. The token axis is split
over the mesh's "seq" ranks; each rank keeps its query chunk and the key,
value and key-mask chunks rotate around the ring (``parallel/comm.py::
rotate``) while an online softmax merges the chunk results. Every chunk, at
every size, goes through the flash kernels' wrappers
(``ops/flash_kernel.py``): the CUDA kernels on the card, their plain
versions on the CPU. The JAX package's einsum chunk body (for shards with no
128-aligned block) has no counterpart: each rank pads its chunk to a
multiple of ``BLOCK`` with masked keys instead (the ViT pads the whole
sequence to ``BLOCK * seq`` tokens, so its chunks need none).

- Forward: the flash forward kernel gives (o_i, lse_i) for each arriving
  chunk; chunks merge in fp32: m = max(m, lse_i), num = num * e^(m_old - m)
  + o_i * e^(lse_i - m), den likewise; out = num / den and the global
  lse = m + log(den). NEG_INF stays finite in the kernels, so a chunk of
  padding alone (lse_i near -1e30) gives exp(0) or exp(-huge), never NaN,
  and a later valid chunk's weight wipes it out.
- Backward (hand-derived, as in the JAX package): delta = sum_d dO * O once
  from the global (out, lse); with the global lse the chunk probabilities
  exp(q k_j * scale - lse) are the global softmax restricted to the chunk,
  so the backward kernels run per chunk unchanged, and (k, v, mask, dk, dv)
  rotate together so the accumulated dk, dv come home after n steps.

A simple ring that waits for each rotation; overlapping a chunk's kernels
with the next transfer is open work. q, k, v are (B, S_loc, H, D) tensors,
this rank's chunk of a (B, S, H, D) sequence; the mask is (B, S_loc) key
validity; lse is (B, H, S_loc) (the JAX package's is (B, H, S, 1)).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops import flash_kernel
from ..ops.flash_kernel import BLOCK, NEG_INF
from .comm import rotate
from .mesh import SEQ_AXIS, Mesh, make_mesh


def make_seq_mesh(seq: int = -1, data: int = 1, device=None) -> Mesh:
    """A (data, seq) mesh (model = 1); ``seq=-1`` takes the ranks that
    ``data`` leaves."""
    if seq == -1:
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}.")
        seq = n // data
    return make_mesh(data=data, model=1, seq=seq, device=device)


def _padded(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _merge(m, num, den, o_i, lse_i):
    """One online-softmax merge step, in fp32."""
    m_new = torch.maximum(m, lse_i)
    c_old, c_i = torch.exp(m - m_new), torch.exp(lse_i - m_new)
    num = num * c_old[..., None] + o_i.float() * c_i[..., None]
    return m_new, num, den * c_old + c_i


class _RingFlash(torch.autograd.Function):
    """(B, H, S_loc, D) views of this rank's padded chunk; the chunk mask
    (B, S_loc) bool."""

    @staticmethod
    def forward(ctx, qt, kt, vt, mask, group, fused_bwd):
        n = dist.get_world_size(group)
        b, h, s, d = qt.shape
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=qt.device)
        num = torch.zeros((b, h, s, d), dtype=torch.float32, device=qt.device)
        den = torch.zeros((b, h, s), dtype=torch.float32, device=qt.device)
        kc, vc, mc = kt, vt, mask
        for i in range(n):
            o_i, lse_i = flash_kernel.flash_forward(qt, kc, vc, mc)
            m, num, den = _merge(m, num, den, o_i, lse_i)
            if i < n - 1:  # the n-th rotation would only bring the chunks home
                kc, vc, mc = rotate((kc, vc, mc), group)
        den = den.clamp_min(1e-30)
        out = (num / den[..., None]).to(qt.dtype)
        lse = m + torch.log(den)
        ctx.save_for_backward(qt, kt, vt, mask, out, lse)
        ctx.group, ctx.fused_bwd = group, fused_bwd
        return out

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, mask, out, lse = ctx.saved_tensors
        n = dist.get_world_size(ctx.group)
        dot = g.to(qt.dtype)
        if dot.stride(-1) != 1:
            dot = dot.contiguous()
        delta = flash_kernel.delta_of(dot, out)
        dq = torch.zeros(qt.shape, dtype=torch.float32, device=qt.device)
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        kc, vc, mc = kt, vt, mask
        for i in range(n):
            dq_i, dk_i, dv_i = flash_kernel.flash_backward(qt, kc, vc, dot, lse, delta, mc,
                                                           fused=ctx.fused_bwd)
            dq += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
            # (k, v, mask, dk, dv) travel together: after n rotations each
            # chunk's accumulators are home with every rank's contribution
            if i < n - 1:
                kc, vc, mc, dk, dv = rotate((kc, vc, mc, dk, dv), ctx.group)
            else:
                dk, dv = rotate((dk, dv), ctx.group)
        return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], group, fused_bwd: bool = True) -> torch.Tensor:
    """Masked softmax attention of this rank's (B, S_loc, H, D) chunk of q
    over the whole sequence, whose k, v and (B, S_loc) key mask chunks the
    ranks of ``group`` hold in rank order. Returns (B, S_loc, H, D)."""
    b, s = q.shape[0], q.shape[1]
    pad = -(-s // BLOCK) * BLOCK - s
    valid = torch.ones((b, s), dtype=torch.bool, device=q.device) if mask is None \
        else mask.to(torch.bool)
    if pad:
        q, k, v = _padded(q, pad), _padded(k, pad), _padded(v, pad)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    out = _RingFlash.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           valid.contiguous(), group, fused_bwd)
    return out.transpose(1, 2)[:, :s]


def make_ring_attention(mesh: Mesh, seq_axis: str = SEQ_AXIS,
                        fused_bwd: bool = True) -> Callable:
    """``attn(q, k, v, mask=None) -> out`` over this rank's chunk: q, k, v
    (B_loc, S_loc, H, D), this rank's rows (its "data" index) and tokens
    (its ``seq_axis`` index) of the global arrays; mask (B_loc, S_loc) key
    validity. The ranks of the axis hold consecutive token chunks; every
    rank's S_loc is the same. ``fused_bwd``: the fused backward kernel, or
    the split dq and dk/dv kernels."""
    group = mesh.group(seq_axis)

    def attn(q, k, v, mask: Optional[torch.Tensor] = None):
        return ring_attention(q, k, v, mask, group, fused_bwd)

    return attn


def shard_seq(x: torch.Tensor, mesh: Mesh, seq_axis: str = SEQ_AXIS,
              dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the token axis ``dim`` of a whole sequence (its
    ``seq_axis`` index of that axis' size equal chunks); raises unless the
    axis divides."""
    n, s = mesh.size(seq_axis), x.shape[dim]
    if s % n:
        raise ValueError(f"sequence length {s} not divisible by the {seq_axis!r} "
                         f"axis size {n}; pad the token axis first.")
    return x.narrow(dim, mesh.index(seq_axis) * (s // n), s // n)


def make_ring_attention_fn(mesh: Mesh, seq_axis: str = SEQ_AXIS,
                           fused_bwd: bool = True) -> Callable:
    """Adapter for ``models/vit.py::mhsa``'s ``attention_fn`` slot: a
    sequence-sharded ViT forward (``vit_forward(mesh=...)``, each rank
    holding its token chunk) computes attention through the ring. The
    function carries the mesh as ``ring_mesh``, so the forward can check
    that it shards the tokens over the same ranks."""
    attn = make_ring_attention(mesh, seq_axis, fused_bwd)

    def attention_fn(q, k, v, mask):
        return attn(q, k, v, mask)

    attention_fn.ring_mesh = mesh
    return attention_fn
