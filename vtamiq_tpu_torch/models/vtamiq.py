"""VTAMIQ in PyTorch: dual-tower ViT + DiffNet + quality regressor.

Port of ``vtamiq_tpu/models/vtamiq.py``. In training (``train=True`` with a
``torch.Generator`` on the compute device) the DiffNet residual groups'
DropPath (``rg_path_drop``) and the q predictor's two dropouts
(``predictor_dropout``) act; their draws cannot match JAX's PRNG, so parity
tests set both to 0. The two towers fold into one
encoder batch of 2B rows; the CLS difference and the whole head run in fp32
whatever the backbone's compute dtype, because ``cls_ref - cls_dist``
cancels and must not be rounded to bf16.

DiffNet works on (B, H) feature vectors: the reference's 1x1 Conv1d and
pooling over a length-1 axis are dense layers here, as in the JAX package.
PReLU layers have one shared slope (init 0.25).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .configs import VTAMIQConfig
from .vit import Dense, ViT, dense, drop_path, dropout, init_params_, vit_forward


# --------------------------------------------------------------------------
# parameter holders (names follow the JAX pytree paths)
# --------------------------------------------------------------------------

class CALayer(nn.Module):
    """Channel-attention gate: dim -> dim/r -> ReLU -> dim -> sigmoid."""

    def __init__(self, dim: int, reduction: int):
        super().__init__()
        self.down = Dense(dim, dim // reduction)
        self.up = Dense(dim // reduction, dim)


def make_ms_cam(dim: int, reduction: int, use_local: bool) -> nn.ModuleDict:
    """MS-CAM: a ``global`` channel-attention branch and an optional
    ``local`` one (a ModuleDict, since ``global`` is a Python keyword)."""
    branches = {"global": CALayer(dim, reduction)}
    if use_local:
        branches["local"] = CALayer(dim, reduction)
    return nn.ModuleDict(branches)


def make_aff(dim: int, reduction: int = 2, use_local: bool = True) -> nn.ModuleDict:
    """Attentional Feature Fusion parameters (an MS-CAM)."""
    return make_ms_cam(dim, reduction, use_local)


def make_iaff(dim: int, reduction: int = 2, use_local: bool = True) -> nn.ModuleDict:
    """Iterative AFF parameters: an AFF and a second MS-CAM."""
    return nn.ModuleDict({"aff": make_aff(dim, reduction, use_local),
                          "ms_cam": make_ms_cam(dim, reduction, use_local)})


class RCAB(nn.Module):
    """Residual channel-attention block: x + CA(conv(PReLU(x)))."""

    def __init__(self, dim: int, reduction: int, use_ms_cam: bool, use_local: bool):
        super().__init__()
        self.prelu = nn.Parameter(torch.empty(()))
        self.conv = Dense(dim, dim)
        if use_ms_cam:
            self.ms_cam = make_ms_cam(dim, reduction, use_local)
        else:
            self.ca = CALayer(dim, reduction)


class ResidualGroup(nn.Module):
    def __init__(self, dim: int, num_rcabs: int, reduction: int,
                 use_ms_cam: bool, use_local: bool):
        super().__init__()
        self.rcabs = nn.ModuleDict({f"rcab_{i}": RCAB(dim, reduction, use_ms_cam, use_local)
                                    for i in range(num_rcabs)})
        self.conv = Dense(dim, dim)


class QualityDecoder(nn.Module):
    def __init__(self, cfg: VTAMIQConfig):
        super().__init__()
        h = cfg.vit.hidden_size
        self.rgs = nn.ModuleDict({
            f"rg_{i}": ResidualGroup(h, cfg.num_rcabs, cfg.ca_reduction,
                                     cfg.use_ms_cam, cfg.use_local)
            for i in range(cfg.num_rgs)})
        self.conv = Dense(h, h)


class QPredictor(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.fc1 = Dense(h, h // 4)
        self.prelu = nn.Parameter(torch.empty(()))
        self.fc2 = Dense(h // 4, 1)


class VTAMIQ(nn.Module):
    """Parameters of the VTAMIQ model; ``forward`` is ``vtamiq_forward``."""

    def __init__(self, cfg: VTAMIQConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.vit.hidden_size
        self.vit = ViT(cfg.vit)
        if cfg.diff_scale:
            self.diff_scale = nn.Parameter(torch.empty(h))
        if cfg.calibrate:
            self.quality_decoder = QualityDecoder(cfg)
        self.q_predictor = QPredictor(h)

    def forward(self, patches, pos, scales=None, **kwargs):
        return vtamiq_forward(self, self.cfg, patches, pos, scales, **kwargs)


def init_vtamiq_params(cfg: VTAMIQConfig, generator: torch.Generator) -> VTAMIQ:
    """A VTAMIQ model on the CPU with every weight drawn from ``generator``
    (the JAX package's initializers; see ``vit.init_params_``)."""
    return init_params_(VTAMIQ(cfg), generator)


# --------------------------------------------------------------------------
# forward blocks
# --------------------------------------------------------------------------

def prelu(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _branch(p: CALayer, x: torch.Tensor) -> torch.Tensor:
    return dense(p.up, torch.relu(dense(p.down, x)))


def calayer(p: CALayer, x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(up(relu(down(x)))) over the feature axis of (B, H)."""
    return x * torch.sigmoid(_branch(p, x))


def ms_cam_weight(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    """MS-CAM attention weight: sigmoid(local(x) + global(x))."""
    w = _branch(p["global"], x)
    if "local" in p:
        w = w + _branch(p["local"], x)
    return torch.sigmoid(w)


def ms_cam(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    return x * ms_cam_weight(p, x)


def aff(p: nn.ModuleDict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Attentional Feature Fusion: lerp(x, y, w(x + y))."""
    w = ms_cam_weight(p, x + y)
    return x + w * (y - x)


def iaff(p: nn.ModuleDict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Iterative AFF: fuse, re-weight, lerp."""
    xi = aff(p["aff"], x, y)
    w = ms_cam_weight(p["ms_cam"], xi)
    return x + w * (y - x)


def rcab(p: RCAB, x: torch.Tensor) -> torch.Tensor:
    h = dense(p.conv, prelu(p.prelu.to(x.dtype), x))
    if hasattr(p, "ms_cam"):
        return x + ms_cam(p.ms_cam, h)
    return x + calayer(p.ca, h)


def _active(prob: float, train: bool, generator: Optional[torch.Generator]) -> float:
    return prob if (train and generator is not None) else 0.0


def residual_group(p: ResidualGroup, x: torch.Tensor, path_drop_prob: float = 0.0,
                   train: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + DP(conv(RCABs(x))); DropPath acts in training with a generator."""
    h = x
    for i in range(len(p.rcabs)):
        h = rcab(p.rcabs[f"rcab_{i}"], h)
    h = dense(p.conv, h)
    return x + drop_path(h, _active(path_drop_prob, train, generator), generator)


def quality_decoder(p: QualityDecoder, x: torch.Tensor, path_drop_prob: float = 0.0,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DiffNet: the residual groups in order, then the output dense."""
    for i in range(len(p.rgs)):
        x = residual_group(p.rgs[f"rg_{i}"], x, path_drop_prob, train, generator)
    return dense(p.conv, x)


def q_predictor(p: QPredictor, x: torch.Tensor, prob: float = 0.0, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout -> H -> H/4 -> PReLU -> Dropout -> 1; the dropouts act in
    training with a generator."""
    prob = _active(prob, train, generator)
    x = dense(p.fc1, dropout(x, prob, generator))
    x = dropout(prelu(p.prelu.to(x.dtype), x), prob, generator)
    return dense(p.fc2, x)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def vtamiq_forward(p: VTAMIQ, cfg: VTAMIQConfig, patches: torch.Tensor,
                   pos: torch.Tensor, scales: Optional[torch.Tensor] = None, *,
                   patch_mask: Optional[torch.Tensor] = None,
                   compute_dtype=torch.bfloat16, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Quality scores for batched (ref, dist) patch pairs.

    patches: (B, 2, N, P, P, 3), axis 1 = (reference, distorted); pos:
    (B, 2, N, 2) uv centers; scales: optional (B, 2, N) ints; patch_mask:
    optional (B, 2, N) bool. ``train`` with a ``generator`` (on the compute
    device) turns on DropPath and dropout; ``attention_fn``: see
    ``models/vit.py::mhsa``. Returns q: (B,) fp32."""
    b, k, n = patches.shape[0], patches.shape[1], patches.shape[2]
    if k != 2:
        raise ValueError(f"vtamiq_forward expects 2 towers (ref, dist); got {k}.")

    feats = vit_forward(
        p.vit, cfg.vit, patches.reshape((b * k,) + patches.shape[2:]),
        pos.reshape(b * k, n, 2),
        None if scales is None else scales.reshape(b * k, n),
        tokens_only=True,
        patch_mask=None if patch_mask is None else patch_mask.reshape(b * k, n),
        compute_dtype=compute_dtype, train=train, generator=generator,
        attention_fn=attention_fn)  # (2B, T, H) fp32

    feats = feats.reshape(b, k, cfg.vit.num_tokens, cfg.vit.hidden_size)
    cls_diff = feats[:, 0, cfg.token_num] - feats[:, 1, cfg.token_num]  # fp32
    if cfg.diff_scale:
        cls_diff = cls_diff * p.diff_scale
    if cfg.calibrate:
        cls_diff = quality_decoder(p.quality_decoder, cls_diff, cfg.rg_path_drop, train,
                                   generator)
    return q_predictor(p.q_predictor, cls_diff, cfg.predictor_dropout, train,
                       generator).reshape(b)
