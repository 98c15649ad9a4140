"""Training losses, as PyTorch functions on (B,) tensors.

Port of ``vtamiq_tpu/ops/losses.py``. Every loss takes an optional
``valid`` count: items past it (a partial batch padded by repeating its
last item) count in no term. Kept from the JAX package:

- the pairwise rank loss is one masked (B, B) expression, masked before it
  divides, so the diagonal's 0/0 never reaches a gradient;
- the Pearson loss normalizes with the smooth norm sqrt(sum(x^2) + eps^2),
  so the gradient at constant predictions is finite, not NaN;
- ``loss_func_iqa`` optimizes ``rank + pears`` and ignores its weights
  unless ``weighted=True``; MAE is reported only;
- pairwise-preference training optimizes MAE only.

Clips and hinges are ``torch.maximum``/``torch.minimum``, which split the
gradient at a tie as ``jnp.maximum``/``jnp.clip`` do (``torch.clamp``
passes it whole): at constant predictions the Pearson term sits exactly at
its clip.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

RANK_LOSS_EPS = 1e-6
PEARS_LOSS_EPS = 1e-6


def _valid_mask(n: int, valid, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n,) 0/1 mask of real (non-padded) items; valid=None -> all ones."""
    if valid is None:
        return torch.ones((n,), dtype=dtype, device=device)
    return (torch.arange(n, device=device) < valid).to(dtype)


def mae_loss(d, y, valid=None):
    if valid is None:
        return torch.mean(torch.abs(d - y))
    m = _valid_mask(d.shape[0], valid, d.dtype, d.device)
    return torch.sum(torch.abs(d - y) * m) / torch.clamp(torch.sum(m), min=1.0)


def mse_loss(d, y, valid=None):
    if valid is None:
        return torch.mean((d - y) ** 2)
    m = _valid_mask(d.shape[0], valid, d.dtype, d.device)
    return torch.sum((d - y) ** 2 * m) / torch.clamp(torch.sum(m), min=1.0)


def _safe_norm(x, eps: float):
    """sqrt(sum(x^2) + eps^2): a smooth l2 norm whose gradient at x == 0 is
    exactly 0 (the backward of a plain norm at 0 is NaN)."""
    return torch.sqrt(torch.sum(torch.square(x)) + eps * eps)


def pears_loss(d, y, valid=None, eps: float = PEARS_LOSS_EPS):
    """1 - clamp(pearson(d, y), 0, 1) over the first ``valid`` items."""
    m = _valid_mask(d.shape[0], valid, torch.float32, d.device)
    count = torch.clamp(torch.sum(m), min=1.0)
    dm = (d - torch.sum(d * m) / count) * m
    ym = (y - torch.sum(y * m) / count) * m
    r = torch.dot(dm / _safe_norm(dm, eps), ym / _safe_norm(ym, eps))
    return 1.0 - torch.minimum(torch.maximum(r, r.new_zeros(())), r.new_ones(()))


def rank_loss(d, y, valid=None, eps: float = RANK_LOSS_EPS, norm_num: bool = True):
    """Pairwise hinge rank loss over all C(valid, 2) pairs: per pair (i, j),
    max(0, -(y_i - y_j)(d_i - d_j) / (|y_i - y_j| + eps)) / max(|d_i|, |d_j|),
    averaged over the pairs."""
    n = d.shape[0]
    if n < 2:
        return torch.zeros((), dtype=d.dtype, device=d.device)
    dd = d[:, None] - d[None, :]
    dy = y[:, None] - y[None, :]
    rl = -dy * dd / (torch.abs(dy) + eps)
    rl = torch.maximum(rl.new_zeros(()), rl)
    dp = torch.abs(d)
    denom = torch.maximum(dp[:, None], dp[None, :])
    # each unordered pair once (i < j); padded items excluded on both sides
    mask = torch.triu(torch.ones((n, n), dtype=d.dtype, device=d.device), diagonal=1)
    if valid is not None:
        m = _valid_mask(n, valid, d.dtype, d.device)
        mask = mask * m[:, None] * m[None, :]
    loss = torch.sum(torch.where(mask > 0, rl / torch.maximum(denom, denom.new_tensor(eps)),
                                 torch.zeros_like(rl)))
    if norm_num:
        if valid is None:
            loss = loss / max(1, n * (n - 1) // 2)
        else:
            v = torch.as_tensor(valid, device=d.device)
            loss = loss / torch.clamp(v * (v - 1) // 2, min=1).to(d.dtype)
    return loss


def spearman_loss(x, y):
    """Batched soft Spearman correlation over rank indices (rows of (B, n))."""
    xr = torch.argsort(x, dim=1).float()
    yr = torch.argsort(y, dim=1).float()
    n = x.shape[1]
    upper = 6.0 * torch.sum((yr - xr) ** 2, dim=1)
    down = n * (n ** 2 - 1.0)
    return torch.mean(1.0 - upper / down)


def loss_func_iqa(d, y, w_mae_loss: float = 0.75, w_rank_loss: float = 1.0,
                  w_pears_loss: float = 0.2, weighted: bool = False,
                  valid=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """IQA loss: (optimized loss, {"mae", "rank", "pears"}). Optimized:
    rank + pears (weights ignored), or with ``weighted=True``
    w_mae*mae + w_rank*rank + w_pears*pears."""
    mae_value = mae_loss(d, y, valid)
    rank_value = rank_loss(d, y, valid)
    pears_value = pears_loss(d, y, valid)
    if weighted:
        total = w_mae_loss * mae_value + w_rank_loss * rank_value + w_pears_loss * pears_value
    else:
        total = rank_value + pears_value
    return total, {"mae": mae_value, "rank": rank_value, "pears": pears_value}


def loss_func_pairwise(p_pred, p_label, valid: Optional[int] = None):
    """Pairwise-preference loss: MAE only."""
    return mae_loss(p_pred, p_label, valid)
