"""Model introspection: parameter tables, FLOP estimates, tensor info.

Port of ``vtamiq_tpu/models/utils.py``. Rows are named by the JAX package's
flattened keys (the port's parameter names are the same dotted paths) and
listed in its order, so ``model_params.txt`` holds the same rows in both
packages. FLOPs are computed from the architecture, counting a
multiply-accumulate as 2, at the reference's convention of one pair of
``num_patches`` 16x16x3 patches.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .checkpoint import tree_order
from .configs import VTAMIQConfig, ViTConfig


def count_parameters(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def parameter_table(params: nn.Module,
                    max_rows: Optional[int] = None) -> List[Tuple[str, tuple, int]]:
    named = dict(params.named_parameters())
    rows = []
    for name in tree_order(named):
        shape = tuple(named[name].shape)
        rows.append((name, shape, int(np.prod(shape)) if shape else 1))
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows


def print_parameters(params: nn.Module, full: bool = False, log=print) -> int:
    total = count_parameters(params)
    if full:
        for name, shape, count in parameter_table(params):
            log(f"{name:80s} {str(shape):24s} {count}")
    log(f"Total parameters: {total:,} ({total / 1e6:.2f}M)")
    return total


def save_model_params(params: nn.Module, output_dir: str,
                      filename: str = "model_params.txt"):
    os.makedirs(output_dir, exist_ok=True)
    lines = [f"{name}\t{shape}\t{count}"
             for name, shape, count in parameter_table(params)]
    lines.append(f"TOTAL\t\t{count_parameters(params)}")
    with open(os.path.join(output_dir, filename), "w") as f:
        f.write("\n".join(lines))


# --------------------------------------------------------------------------
# analytic FLOP model
# --------------------------------------------------------------------------

def vit_flops(cfg: ViTConfig, num_patches: int) -> int:
    """Forward-pass FLOPs for one image's patch sequence through the ViT."""
    h = cfg.hidden_size
    m = cfg.mlp_dim
    s = cfg.num_tokens + num_patches
    layers = cfg.effective_num_layers

    embed = 2 * num_patches * (cfg.patch_size ** 2 * 3) * h
    per_layer = (
        2 * s * h * h * 4          # QKV + out projections
        + 2 * s * s * h * 2        # QK^T and PV
        + 2 * s * h * m * 2        # MLP fc1 + fc2
    )
    return embed + layers * per_layer


def vtamiq_flops(cfg: VTAMIQConfig, num_patches: int = 500) -> int:
    """Dual-tower forward FLOPs for one ref/dist pair."""
    h = cfg.vit.hidden_size
    towers = 2 * vit_flops(cfg.vit, num_patches)
    rcab = 2 * h * h + 2 * h * (h // cfg.ca_reduction) * 2   # conv + CA gate
    decoder = cfg.num_rgs * (cfg.num_rcabs * rcab + 2 * h * h) + 2 * h * h
    predictor = 2 * h * (h // 4) + 2 * (h // 4)
    return towers + decoder + predictor


def print_flops(cfg: VTAMIQConfig, num_patches: int = 500, log=print) -> int:
    flops = vtamiq_flops(cfg, num_patches)
    log(f"VTAMIQ forward FLOPs (1 pair x {num_patches} patches x 3x"
        f"{cfg.vit.patch_size}x{cfg.vit.patch_size}): {flops / 1e9:.2f} GFLOPs")
    return flops


def tinfo(tag: str, t, log=print):
    """Shape, min, mean and max of a tensor or array."""
    a = t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    log(f"tinfo: {tag} {a.shape} {a.min():.5g} {a.mean():.5g} {a.max():.5g}")
