"""Optimizer, learning-rate schedules and freeze masks, in plain tensor code.

Port of ``vtamiq_tpu/train/optim.py``, which builds an optax chain:
``clip_by_global_norm(1.0)`` -> SGD (momentum, Nesterov) / Adam / AdamW,
with ``add_decayed_weights`` where the chain has it, and the learning rate
read from the optimizer's own update count (0 at the first update).
``torch.optim`` keeps other state and applies weight decay at another
point, so the chain is written out here, element for element as optax
computes it, in fp32.

Parameters, gradients, updates and optimizer moments are dicts keyed by
parameter name (``nn.Module.named_parameters``). The freeze mask is data: a
dict of 0.0/1.0 per parameter that the train step multiplies into the
gradients *and* the updates, so a frozen tensor gets no weight decay while
its moments still see (zero) gradients; freezing or unfreezing never
rebuilds the optimizer state.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax's defaults


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def make_lr_schedule(global_config: Mapping, steps_per_epoch: int) -> Callable:
    """``schedule(count)`` -> fp32 learning rate at optimizer update
    ``count``. With ``scheduler_step_per_batch`` False the schedule advances
    once per epoch of ``steps_per_epoch`` updates."""
    lr = global_config["optimizer_learning_rate"]
    per_batch = global_config["scheduler_step_per_batch"]
    num_epochs = global_config["num_epochs"]
    kind = global_config["scheduler_type"]
    num_steps = max(1, num_epochs * (steps_per_epoch if per_batch else 1))

    if kind == "lambda":
        ratio = _f32(global_config["optimizer_learning_rate_decay_lambda_goal"] ** (1.0 / num_steps))

        def base(s):
            return _f32(lr) * ratio ** s
    elif kind == "cosine":
        alpha = global_config["optimizer_learning_rate_decay_cosine"]

        def base(s):
            s = torch.minimum(_f32(s), _f32(float(num_steps)))
            cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * s / float(num_steps)))
            return _f32(lr) * ((1 - alpha) * cosine + alpha)
    elif kind == "multistep":
        if per_batch:
            raise NotImplementedError("multistep scheduler does not support per-batch stepping.")
        gamma = global_config["optimizer_learning_rate_decay_multistep"]
        milestones = torch.tensor(list(global_config["optimizer_decay_after_n_epochs"]))

        def base(s):
            factor = torch.prod(torch.where(milestones <= s, _f32(gamma), _f32(1.0)))
            return _f32(lr) * factor
    else:
        raise ValueError(f"Unexpected scheduler_type [{kind}].")

    if per_batch:
        return base
    return lambda count: base(count // max(1, steps_per_epoch))


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor (fp32)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


class Optimizer:
    """``clip_by_global_norm(max_norm)`` then SGD, Adam or AdamW, as
    ``make_optimizer`` chains them. ``init(params)`` -> state;
    ``update(grads, state, params)`` -> updates (to add to the params), with
    the state updated in place."""

    def __init__(self, name: str, schedule: Callable, weight_decay: float = 0.0,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 max_norm: float = 1.0):
        if name not in ("SGD", "Adam", "AdamW"):
            raise ValueError(f"Unexpected optimizer [{name}].")
        self.name, self.schedule, self.weight_decay = name, schedule, weight_decay
        self.momentum, self.nesterov = momentum, nesterov
        self.max_norm = max_norm

    def init(self, params: Tensors) -> Dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        state = {"count": 0}
        if self.name == "SGD":
            if self.momentum is not None:
                state["trace"] = zeros()
        else:
            state["mu"], state["nu"] = zeros(), zeros()
        return state

    def update(self, grads: Tensors, state: Dict, params: Tensors) -> Tensors:
        g_norm = global_norm(grads)
        clip = g_norm < self.max_norm
        u = {n: torch.where(clip, g, (g / g_norm) * self.max_norm) for n, g in grads.items()}
        wd = self.weight_decay
        if self.name in ("SGD", "Adam") and wd:
            u = {n: g + wd * params[n] for n, g in u.items()}
        if self.name == "SGD":
            if self.momentum is not None:
                trace = state["trace"]
                for n, g in u.items():
                    trace[n] = g + self.momentum * trace[n]
                    u[n] = g + self.momentum * trace[n] if self.nesterov else trace[n]
        else:
            count = state["count"] + 1
            c1 = 1 - _f32(ADAM_B1) ** count
            c2 = 1 - _f32(ADAM_B2) ** count
            mu, nu = state["mu"], state["nu"]
            for n, g in u.items():
                mu[n] = (1 - ADAM_B1) * g + ADAM_B1 * mu[n]
                nu[n] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[n]
                u[n] = (mu[n] / c1.to(g.device)) / (torch.sqrt(nu[n] / c2.to(g.device)) + ADAM_EPS)
            if self.name == "AdamW":
                u = {n: g + wd * params[n] for n, g in u.items()}
        step = -self.schedule(state["count"])
        state["count"] += 1
        return {n: g * step.to(g.device) for n, g in u.items()}


def make_optimizer(global_config: Mapping, steps_per_epoch: int) -> Tuple[Optimizer, Callable]:
    """clip-by-global-norm(1.0) -> {SGD | Adam | AdamW}(schedule); returns
    (optimizer, schedule)."""
    schedule = make_lr_schedule(global_config, steps_per_epoch)
    name = global_config["optimizer"]
    kw = {}
    if name == "SGD":
        kw = dict(momentum=global_config["optimizer_sgd_momentum"],
                  nesterov=global_config["optimizer_sgd_nesterov"])
    return Optimizer(name, schedule, global_config["optimizer_weight_decay"], **kw), schedule


# --------------------------------------------------------------------------
# freeze masks
# --------------------------------------------------------------------------

def build_freeze_mask(params, freeze_state: bool,
                      freeze_dict: Optional[Mapping] = None) -> Dict[str, float]:
    """{parameter name: 1.0 trainable | 0.0 frozen} for a VTAMIQ module (or
    its ``named_parameters`` dict), with the JAX package's flags and defaults:
    freeze_dict_vit{freeze_encoder (True), freeze_encoder_layerscale
    (False), freeze_embeddings_patch, _cls_token, _extra_tokens, _pos (True),
    freeze_embeddings_scale (False)}, freeze_quality_decoder,
    freeze_q_predictor, freeze_w_predictor (False)."""
    names = [n for n, _ in params.named_parameters()] if isinstance(params, nn.Module) \
        else list(params)
    mask = {n: 1.0 for n in names}
    if not freeze_state:
        return mask
    fd = freeze_dict or {}
    fd_vit = fd.get("freeze_dict_vit", {})
    frozen_prefixes = []
    if fd_vit.get("freeze_encoder", True):
        frozen_prefixes += ["vit.encoder.layers.", "vit.encoder.final_ln."]
    for flag, leaf, default in (("freeze_embeddings_patch", "patch.", True),
                                ("freeze_embeddings_cls_token", "cls_token", True),
                                ("freeze_embeddings_extra_tokens", "extra_tokens", True),
                                ("freeze_embeddings_pos", "pos_embeddings", True),
                                ("freeze_embeddings_scale", "scale_embeddings", False)):
        if fd_vit.get(flag, default):
            frozen_prefixes.append("vit.embeddings." + leaf)
    for flag, prefix in (("freeze_quality_decoder", "quality_decoder."),
                         ("freeze_q_predictor", "q_predictor."),
                         ("freeze_w_predictor", "pref_module.")):
        if fd.get(flag, False):
            frozen_prefixes.append(prefix)
    keep_layerscale = not fd_vit.get("freeze_encoder_layerscale", False)
    for n in names:
        if any(n.startswith(p) for p in frozen_prefixes):
            layerscale = n.startswith("vit.encoder.layers.") and n.rsplit(".", 1)[-1] in ("ls1", "ls2")
            mask[n] = 1.0 if (layerscale and keep_layerscale) else 0.0
    return mask


def apply_mask(tree: Tensors, mask: Mapping[str, float]) -> Tensors:
    return {n: t * mask[n] for n, t in tree.items()}


def count_trainable(mask: Mapping[str, float]) -> int:
    """Number of trainable parameter tensors."""
    return sum(1 for m in mask.values() if m > 0)
