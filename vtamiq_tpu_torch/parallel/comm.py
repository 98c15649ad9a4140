"""The collectives of the mesh steps, written out by hand.

In the JAX package, XLA inserts these: GSPMD adds the gradient psums and the
Megatron all-reduces, and ``ppermute`` moves the ring's chunks. Here every
rank is a process (``parallel/distributed.py``), so the steps call them:

- :func:`all_gather` (no gradient) and :func:`all_gather_autograd`
  (forward: all-gather; backward: all-reduce (sum), then this rank's slice);
- the Megatron pair of conjugate collectives, :func:`copy_to_model`
  (identity forward, all-reduce backward; before the column-parallel
  layers) and :func:`reduce_from_model` (all-reduce forward, identity
  backward; after the row-parallel ones);
- :func:`rotate`, the ring's step (``dist.batch_isend_irecv``);
- :func:`all_reduce_mean_`, the gradients' mean.

**Why a mesh step computes the single-process step's gradients.** The
rank and Pearson losses are batch-level: a loss per shard averaged over the
ranks (DDP's rule) is another function than the loss of the global batch.
So every rank all-gathers q over "data" with :func:`all_gather_autograd`
and computes the global loss, with the global ``valid`` count, from the
gathered q: every rank holds the same loss L. Backward, the gather's
all-reduce sums the n identical dL/dq of the n data ranks, so each rank's
slice arrives as n * dL/dq_r and each rank's parameter gradient is n times
its rows' share of dL/dtheta. Under sequence parallelism the last encoder
layer's input is gathered over "seq" the same way, and the seq ranks' shares
of the layers below add up to s times the gradient. Every parameter's
gradient is then all-reduced as a *mean over the data x seq ranks*
(``mesh.GRAD_AXES``), which divides that factor back out: the sum over
ranks of n * (share of rank r) / n is dL/dtheta. A gradient taken after a
gather (the same on every rank) is left as it is by the mean. Nothing is
reduced over "model": the Megatron pair already makes the replicated
parameters' gradients equal on every model rank, and a sharded parameter's
gradient is its own shard's.

**gloo and CUDA tensors.** gloo all-reduces, broadcasts and all-gathers
CUDA tensors itself (checked on an H100 with torch 2.11), but its sends
fail on them ("writev ... Bad address"), so under gloo :func:`rotate`
stages CUDA tensors through pinned host buffers. That is the transport the
caller chose (``initialize(backend="gloo")``, e.g. two ranks sharing one
card), not a fallback: the compute stays on the card.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def _stages(t: torch.Tensor, group) -> bool:
    """True when ``t`` must pass through host memory for a send: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (no gradient)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, into a new tensor."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_gather_autograd(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather`` whose backward all-reduces (sums) the gradient over the
    group and returns this rank's slice of it."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: the input of column-parallel
    layers, whose gradient is the sum of every model rank's share."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of
    row-parallel layers."""
    return _ReduceFromModel.apply(x, group)


def rotate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """One ring step: send each tensor to the next rank of ``group`` and
    receive the previous rank's, through ``dist.batch_isend_irecv``."""
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if n == 1:
        return list(tensors)
    i = dist.get_rank(group)
    dst, src = ranks[(i + 1) % n], ranks[(i - 1) % n]
    staged = [_stages(t, group) for t in tensors]
    sends = [_to_host(t) if s else t.contiguous() for t, s in zip(tensors, staged)]
    recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if s else torch.empty_like(t)
             for t, s in zip(sends, staged)]
    ops = []
    for t, r in zip(sends, recvs):
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, r, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device, non_blocking=True) if s else r
            for r, t, s in zip(recvs, tensors, staged)]


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the group, in place, through
    one flat all-reduce."""
    n = dist.get_world_size(group)
    if n == 1 or not tensors:
        return
    flat = _flatten_dense_tensors(list(tensors))
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for t, m in zip(tensors, _unflatten_dense_tensors(flat, list(tensors))):
        t.copy_(m)
