"""Train and eval steps: sampling -> extraction -> dual-tower forward ->
loss -> masked optimizer update.

Port of ``vtamiq_tpu/train/steps.py`` for full-reference batches (K = 2
towers): ``ExtractConfig``, ``make_extract_fn``, ``make_train_step`` and
``make_eval_step``. Each step is the extraction followed by a step on the
extracted patches (``make_train_step_on_patches``,
``make_eval_step_on_patches``), so a caller can feed patches of its own.
Patch draws come from a CPU ``torch.Generator``; dropout and DropPath draw
from a generator on the compute device. Past
``ops/attention.py::FLASH_ATTENTION_THRESHOLD`` patches the forward takes
the flash attention kernels, and the backward their backward kernels.

Not ported: pairwise/preference training (``is_pairwise=True`` raises;
``models/preference.py`` is not ported), meshes (data and tensor parallel,
ring attention), and the PU-encoding input mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.configs import VTAMIQConfig
from ..models.vtamiq import VTAMIQ, vtamiq_forward
from ..ops.attention import FLASH_ATTENTION_THRESHOLD, make_attention_fn
from ..ops.extraction import get_iqa_patches
from ..ops.losses import loss_func_iqa
from ..ops.sampling import DEFAULT_NUM_SAMPLES_RATIO, PatchSampler
from .optim import Optimizer, apply_mask, global_norm


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Knobs of the sampling + extraction stage. ``norm_mean``/``norm_std``:
    the model-input normalization, fused into the gather (None disables
    it); ``gather_dtype``: the dtype of the gathered patches."""
    patch_count: int = 384
    patch_dim: int = 16
    patch_num_scales: int = 1
    scale_num_samples_ratio: float = DEFAULT_NUM_SAMPLES_RATIO
    use_aligned_patches: bool = True
    randomize_patch_scale_order: bool = False
    norm_mean: Optional[Tuple[float, float, float]] = (0.5, 0.5, 0.5)
    norm_std: Optional[Tuple[float, float, float]] = (0.5, 0.5, 0.5)
    gather_dtype: str = "bfloat16"


def make_extract_fn(sampler: PatchSampler, ecfg: ExtractConfig) -> Callable:
    """-> ``extract(imgs_raw, generator, img_hw=None)``: (B, K, H, W, 3) raw
    fp32 images on the compute device -> (patches, pos, scales), every item
    drawing its own patch layout from the CPU ``generator``."""
    tile_norm = (ecfg.norm_mean, ecfg.norm_std, getattr(torch, ecfg.gather_dtype))

    def extract(imgs_raw: torch.Tensor, generator: torch.Generator,
                img_hw: Optional[torch.Tensor] = None):
        return get_iqa_patches(
            imgs_raw, generator, ecfg.patch_count, ecfg.patch_dim, sampler,
            ecfg.patch_num_scales, ecfg.scale_num_samples_ratio,
            ecfg.use_aligned_patches, ecfg.randomize_patch_scale_order,
            img_hw=img_hw, tile_norm=tile_norm)

    return extract


def default_attention_fn(patch_count: int) -> Optional[Callable]:
    """The steps' attention: flash attention past the long-sequence
    threshold, else None (the plain quadratic form)."""
    if patch_count >= FLASH_ATTENTION_THRESHOLD:
        return make_attention_fn()
    return None


def _check_fr(is_pairwise: bool):
    if is_pairwise:
        raise NotImplementedError("pairwise/preference training (is_pairwise=True, "
                                  "models/preference.py) is not ported to vtamiq_tpu_torch "
                                  "yet; see ROADMAP.md")


def _iqa_loss(q, qs, valid, loss_weights, weighted_loss):
    return loss_func_iqa(q, qs, loss_weights[0], loss_weights[1], loss_weights[2],
                         weighted=weighted_loss, valid=valid)


def make_train_step_on_patches(cfg: VTAMIQConfig, optimizer: Optimizer,
                               weighted_loss: bool = False,
                               compute_dtype=torch.bfloat16,
                               attention_fn: Optional[Callable] = None) -> Callable:
    """``step(params, opt_state, mask, patches, pos, scales, qs, valid,
    loss_weights, generator=None) -> (metrics, q_pred)``.

    Forward in training mode (dropout and DropPath draw from ``generator``,
    none without one), loss, gradients times the freeze ``mask``, optimizer
    update times the mask, added to ``params`` in place; ``opt_state`` is
    updated in place. ``valid``: the count of real items (the rest of the
    batch is padding and counts in no loss term); ``loss_weights``: (w_mae,
    w_rank, w_pears). ``metrics``: loss, mae, rank, pears and the global
    norm of the masked gradients, as 0-d tensors."""

    def step(params: VTAMIQ, opt_state: Dict, mask: Dict[str, float], patches, pos, scales,
             qs, valid, loss_weights: Sequence[float],
             generator: Optional[torch.Generator] = None):
        named = dict(params.named_parameters())
        q = vtamiq_forward(params, cfg, patches, pos, scales, train=True, generator=generator,
                           compute_dtype=compute_dtype, attention_fn=attention_fn)
        loss, aux = _iqa_loss(q, qs, valid, loss_weights, weighted_loss)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
        grads = apply_mask({n: torch.zeros_like(p) if grads[n] is None else grads[n]
                            for n, p in named.items()}, mask)
        updates = apply_mask(optimizer.update(grads, opt_state, named), mask)
        with torch.no_grad():
            for n, p in named.items():
                p.add_(updates[n].to(p.dtype))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   "grad_norm": global_norm(grads)}
        return metrics, q.detach()

    return step


def make_eval_step_on_patches(cfg: VTAMIQConfig, weighted_loss: bool = False,
                              compute_dtype=torch.bfloat16,
                              attention_fn: Optional[Callable] = None) -> Callable:
    """``eval_step(params, patches, pos, scales, qs, valid, loss_weights)
    -> (metrics, q_pred)``: no dropout or DropPath, no gradients."""

    def step(params: VTAMIQ, patches, pos, scales, qs, valid, loss_weights):
        with torch.no_grad():
            q = vtamiq_forward(params, cfg, patches, pos, scales,
                               compute_dtype=compute_dtype, attention_fn=attention_fn)
            loss, aux = _iqa_loss(q, qs, valid, loss_weights, weighted_loss)
        return {"loss": loss, **aux}, q

    return step


_AUTO = "auto"


def _resolve_attention(attention_fn, ecfg: ExtractConfig):
    return default_attention_fn(ecfg.patch_count) if attention_fn == _AUTO else attention_fn


def make_train_step(cfg: VTAMIQConfig, sampler: PatchSampler, ecfg: ExtractConfig,
                    optimizer: Optimizer, is_pairwise: bool = False,
                    weighted_loss: bool = False, compute_dtype=torch.bfloat16,
                    attention_fn=_AUTO) -> Callable:
    """``step(params, opt_state, mask, imgs_raw, qs, valid, loss_weights,
    sample_generator, generator=None, img_hw=None) -> (metrics, q_pred)``:
    the extraction (patches drawn from the CPU ``sample_generator``) then
    ``make_train_step_on_patches``' step. ``attention_fn``: "auto" (flash
    attention past the long-sequence threshold), None (plain attention) or
    an ``attention_fn`` of ``ops/attention.py``."""
    _check_fr(is_pairwise)
    extract = make_extract_fn(sampler, ecfg)
    on_patches = make_train_step_on_patches(cfg, optimizer, weighted_loss, compute_dtype,
                                            _resolve_attention(attention_fn, ecfg))

    def step(params, opt_state, mask, imgs_raw, qs, valid, loss_weights, sample_generator,
             generator=None, img_hw=None):
        patches, pos, scales = extract(imgs_raw, sample_generator, img_hw)
        return on_patches(params, opt_state, mask, patches, pos, scales, qs, valid,
                          loss_weights, generator)

    return step


def make_eval_step(cfg: VTAMIQConfig, sampler: PatchSampler, ecfg: ExtractConfig,
                   is_pairwise: bool = False, weighted_loss: bool = False,
                   compute_dtype=torch.bfloat16, attention_fn=_AUTO) -> Callable:
    """``eval_step(params, imgs_raw, qs, valid, loss_weights,
    sample_generator, img_hw=None) -> (metrics, q_pred)``; patches are drawn
    anew on every call."""
    _check_fr(is_pairwise)
    extract = make_extract_fn(sampler, ecfg)
    on_patches = make_eval_step_on_patches(cfg, weighted_loss, compute_dtype,
                                           _resolve_attention(attention_fn, ecfg))

    def step(params, imgs_raw, qs, valid, loss_weights, sample_generator, img_hw=None):
        patches, pos, scales = extract(imgs_raw, sample_generator, img_hw)
        return on_patches(params, patches, pos, scales, qs, valid, loss_weights)

    return step
