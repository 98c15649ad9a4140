"""Train and eval steps: sampling -> extraction -> dual-tower forward ->
loss -> masked optimizer update.

Port of ``vtamiq_tpu/train/steps.py``: ``ExtractConfig``,
``make_extract_fn``, ``make_train_step`` and ``make_eval_step``, for
full-reference batches (K = 2 towers) and pairwise-preference batches (K =
3: ref, distA, distB; the two pairs fold into one forward of batch 2B).
Each step is the extraction followed by a step on the extracted patches
(``make_train_step_on_patches``, ``make_eval_step_on_patches``), so a
caller can feed patches of its own. Patch draws come from a CPU
``torch.Generator``; dropout and DropPath draw from a generator on the
compute device. Past ``ops/attention.py::FLASH_ATTENTION_THRESHOLD`` patches
the forward takes the flash attention kernels, and the backward their
backward kernels.

With a mesh (``parallel/mesh.py``; the ``mesh=`` argument of each
``make_*`` function) a step runs on each rank of a multi-process mesh and
computes what the single-process step computes on the same global batch,
weights and generator states: the same loss and ``grad_norm``, q for every
item and updated parameters. Each rank passes its rows of the global batch
("data") and the global ``valid`` count. Every random draw is made for the
global batch and each rank keeps its rows. q is all-gathered over "data"
with an autograd gather, every rank computes the global loss from it, and
the gradients are averaged over the data x seq ranks
(``parallel/comm.py`` says why that is exact); the "model" ranks run the
encoder tensor-parallel and the "seq" ranks split its tokens over the ring
(``models/vit.py::vit_forward``). The steps return the global batch's q on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.configs import VTAMIQConfig
from ..models.preference import preference_forward, preference_sigmoid
from ..models.vtamiq import VTAMIQ, vtamiq_forward
from ..ops.attention import FLASH_ATTENTION_THRESHOLD, make_attention_fn
from ..ops.extraction import get_iqa_patches
from ..ops.losses import loss_func_iqa, loss_func_pairwise
from ..ops.sampling import DEFAULT_NUM_SAMPLES_RATIO, PatchSampler
from ..parallel.mesh import DATA_AXIS, GRAD_AXES, MODEL_AXIS, Mesh, param_shardings, seq_size
from ..utils.color_spaces import pu_display_encode_torch
from .optim import Optimizer, apply_mask, global_norm


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Knobs of the sampling + extraction stage. ``norm_mean``/``norm_std``:
    the model-input normalization, fused into the gather (None disables
    it); ``gather_dtype``: the dtype of the gathered patches;
    ``pu_display_encode``: the ``use_pu`` input mode (sRGB -> SDR display
    model -> PU21, normalization off) at ``pu_peak_luminance`` cd/m^2."""
    patch_count: int = 384
    patch_dim: int = 16
    patch_num_scales: int = 1
    scale_num_samples_ratio: float = DEFAULT_NUM_SAMPLES_RATIO
    use_aligned_patches: bool = True
    randomize_patch_scale_order: bool = False
    norm_mean: Optional[Tuple[float, float, float]] = (0.5, 0.5, 0.5)
    norm_std: Optional[Tuple[float, float, float]] = (0.5, 0.5, 0.5)
    gather_dtype: str = "bfloat16"
    pu_display_encode: bool = False
    pu_peak_luminance: float = 100.0


def make_extract_fn(sampler: PatchSampler, ecfg: ExtractConfig,
                    mesh: Optional[Mesh] = None) -> Callable:
    """-> ``extract(imgs_raw, generator, img_hw=None)``: (B, K, H, W, 3) raw
    fp32 images on the compute device -> (patches, pos, scales), every item
    drawing its own patch layout from the CPU ``generator``. With a
    ``mesh`` the B items are this rank's rows of the global batch, and the
    generator draws for the whole global batch.

    With ``pu_display_encode`` the gather reads the PU-encoded image and a
    diff-weighted sampler still reads the raw pixels. As in the JAX
    package, the encoded image is rounded once to ``gather_dtype`` and the
    pyramid pools it in that type; at one scale it stays in fp32 and the
    gather rounds each patch as it stores it, which gives the same bits."""
    gather_dtype = getattr(torch, ecfg.gather_dtype)
    if ecfg.pu_display_encode:
        tile_norm = (None, None, gather_dtype)
    else:
        tile_norm = (ecfg.norm_mean, ecfg.norm_std, gather_dtype)

    def encode(imgs_raw: torch.Tensor) -> Optional[torch.Tensor]:
        if not ecfg.pu_display_encode:
            return None
        pu = pu_display_encode_torch(imgs_raw, ecfg.pu_peak_luminance)
        return pu if ecfg.patch_num_scales == 1 else pu.to(gather_dtype)

    def extract(imgs_raw: torch.Tensor, generator: torch.Generator,
                img_hw: Optional[torch.Tensor] = None):
        tensors = encode(imgs_raw)
        return get_iqa_patches(
            imgs_raw, generator, ecfg.patch_count, ecfg.patch_dim, sampler,
            ecfg.patch_num_scales, ecfg.scale_num_samples_ratio,
            ecfg.use_aligned_patches, ecfg.randomize_patch_scale_order,
            img_hw=img_hw, tile_norm=tile_norm, tensors=tensors,
            batch_rows=None if mesh is None else mesh.batch_rows(imgs_raw.shape[0]))

    return extract


def default_attention_fn(patch_count: int) -> Optional[Callable]:
    """The steps' attention: flash attention past the long-sequence
    threshold, else None (the plain quadratic form)."""
    if patch_count >= FLASH_ATTENTION_THRESHOLD:
        return make_attention_fn()
    return None


def _mesh_attention_fn(mesh: Optional[Mesh], patch_count: int) -> Optional[Callable]:
    """The steps' attention on a mesh: the ring (over the flash kernels)
    when it has a sequence-parallel axis, else ``default_attention_fn``."""
    if seq_size(mesh) > 1:
        from ..parallel.ring_attention import make_ring_attention_fn
        return make_ring_attention_fn(mesh)
    return default_attention_fn(patch_count)


def _pair_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, 3, ...) (ref, distA, distB) -> (2B, 2, ...): (ref, distA) rows,
    then (ref, distB) rows."""
    if x is None:
        return None
    ref, d1, d2 = x[:, 0], x[:, 1], x[:, 2]
    return torch.cat([torch.stack([ref, d1], dim=1), torch.stack([ref, d2], dim=1)], dim=0)


def forward_scores(params: VTAMIQ, cfg: VTAMIQConfig, patches, pos, scales,
                   is_pairwise: bool, use_pref_module: bool, rows=None,
                   **kwargs) -> torch.Tensor:
    """(B, K, N, ...) patches -> predictions. Full reference (K = 2): the q
    scores. Pairwise (K = 3: ref, distA, distB): the preference of A, from
    one forward of batch 2B over (ref, distA) and (ref, distB); through
    ``params.pref_module`` with ``use_pref_module``, else the
    parameter-free sigmoid. ``rows``: (index, total), the items' rows in a
    global batch (``models/vtamiq.py::vtamiq_forward``). ``kwargs`` go to
    ``vtamiq_forward``."""
    if not is_pairwise:
        return vtamiq_forward(params, cfg, patches, pos, scales, rows=rows, **kwargs)
    if rows is not None:  # the pair forward's rows: (ref, distA) pairs, then (ref, distB)
        rows = (torch.cat([rows[0], rows[0] + rows[1]]), 2 * rows[1])
    q_all = vtamiq_forward(params, cfg, _pair_rows(patches), _pair_rows(pos),
                           _pair_rows(scales), rows=rows, **kwargs)
    b = patches.shape[0]
    q1, q2 = q_all[:b], q_all[b:]
    if use_pref_module:
        return preference_forward(params.pref_module, q1, q2)
    return preference_sigmoid(q1, q2)


def _loss(q, qs, valid, loss_weights, weighted_loss, is_pairwise):
    if is_pairwise:
        loss = loss_func_pairwise(q, qs, valid)
        zero = torch.zeros((), device=loss.device)
        return loss, {"mae": loss, "rank": zero, "pears": zero}
    return loss_func_iqa(q, qs, loss_weights[0], loss_weights[1], loss_weights[2],
                         weighted=weighted_loss, valid=valid)


def _rows(mesh: Optional[Mesh], b: int, device):
    """(index, total) of this rank's b rows of the global batch, or None."""
    if mesh is None:
        return None
    first, total = mesh.batch_rows(b)
    return torch.arange(first, first + b, device=device), total


def _global_batch(mesh: Optional[Mesh], q, qs, grad: bool):
    """The global batch's (q, labels): gathered over "data" (q through the
    autograd gather when ``grad``)."""
    if mesh is None:
        return q, qs
    from ..parallel.comm import all_gather, all_gather_autograd
    group = mesh.group(DATA_AXIS)
    qs = torch.as_tensor(qs, device=q.device)
    return (all_gather_autograd if grad else all_gather)(q, group), all_gather(qs, group)


def _grad_norm(grads, params: VTAMIQ, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global norm of ``grads``, TP shards summed over "model"."""
    if mesh is None or mesh.size(MODEL_AXIS) == 1:
        return global_norm(grads)
    sharded = {n for n, d in param_shardings(params, mesh).items() if d is not None}
    return global_norm(grads, sharded, mesh.group(MODEL_AXIS))


def make_train_step_on_patches(cfg: VTAMIQConfig, optimizer: Optimizer,
                               weighted_loss: bool = False,
                               compute_dtype=torch.bfloat16,
                               attention_fn: Optional[Callable] = None,
                               is_pairwise: bool = False,
                               use_pref_module: bool = False,
                               mesh: Optional[Mesh] = None) -> Callable:
    """``step(params, opt_state, mask, patches, pos, scales, qs, valid,
    loss_weights, generator=None) -> (metrics, q_pred)``.

    Forward in training mode (dropout and DropPath draw from ``generator``,
    none without one), loss, gradients times the freeze ``mask``, optimizer
    update times the mask, added to ``params`` in place; ``opt_state`` is
    updated in place. ``valid``: the count of real items (the rest of the
    batch is padding and counts in no loss term); ``loss_weights``: (w_mae,
    w_rank, w_pears). ``metrics``: loss, mae, rank, pears and the global
    norm of the masked gradients, as 0-d tensors. Pairwise (``is_pairwise``,
    K = 3): the loss is the MAE of the preferences, mae = loss and rank =
    pears = 0; with ``use_pref_module`` the preference scale
    ``params.pref_module.p`` trains with the model.

    ``mesh``: patches, pos, scales and qs are this rank's rows of the
    global batch, ``valid`` the global count, ``params`` this rank's TP
    shard and ``opt_state`` its state; q_pred is the global batch's. Under
    a sequence-parallel mesh ``attention_fn`` must be the ring
    (``_mesh_attention_fn``)."""
    def step(params: VTAMIQ, opt_state: Dict, mask: Dict[str, float], patches, pos, scales,
             qs, valid, loss_weights: Sequence[float],
             generator: Optional[torch.Generator] = None):
        named = dict(params.named_parameters())
        q = forward_scores(params, cfg, patches, pos, scales, is_pairwise, use_pref_module,
                           rows=_rows(mesh, patches.shape[0], patches.device), train=True,
                           generator=generator, compute_dtype=compute_dtype,
                           attention_fn=attention_fn, mesh=mesh)
        q, qs = _global_batch(mesh, q, qs, grad=True)
        loss, aux = _loss(q, qs, valid, loss_weights, weighted_loss, is_pairwise)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                    allow_unused=True)))
        grads = {n: torch.zeros_like(p) if grads[n] is None else grads[n]
                 for n, p in named.items()}
        if mesh is not None:
            from ..parallel.comm import all_reduce_mean_
            all_reduce_mean_(list(grads.values()), mesh.group(GRAD_AXES))
        grads = apply_mask(grads, mask)
        g_norm = _grad_norm(grads, params, mesh)
        updates = apply_mask(optimizer.update(grads, opt_state, named, g_norm), mask)
        with torch.no_grad():
            for n, p in named.items():
                p.add_(updates[n].to(p.dtype))
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   "grad_norm": g_norm}
        return metrics, q.detach()

    return step


def make_eval_step_on_patches(cfg: VTAMIQConfig, weighted_loss: bool = False,
                              compute_dtype=torch.bfloat16,
                              attention_fn: Optional[Callable] = None,
                              is_pairwise: bool = False,
                              use_pref_module: bool = False,
                              mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(params, patches, pos, scales, qs, valid, loss_weights)
    -> (metrics, q_pred)``: no dropout or DropPath, no gradients. ``mesh``:
    as in ``make_train_step_on_patches``."""

    def step(params: VTAMIQ, patches, pos, scales, qs, valid, loss_weights):
        with torch.no_grad():
            q = forward_scores(params, cfg, patches, pos, scales, is_pairwise,
                               use_pref_module, compute_dtype=compute_dtype,
                               attention_fn=attention_fn, mesh=mesh)
            q, qs = _global_batch(mesh, q, qs, grad=False)
            loss, aux = _loss(q, qs, valid, loss_weights, weighted_loss, is_pairwise)
        return {"loss": loss, **aux}, q

    return step


_AUTO = "auto"


def _extract_fn(sampler: PatchSampler, ecfg: ExtractConfig, mesh: Optional[Mesh]):
    """``make_extract_fn``, called in its two-argument form without a mesh
    (the form a caller may substitute to feed patches of its own)."""
    return make_extract_fn(sampler, ecfg) if mesh is None else make_extract_fn(sampler, ecfg,
                                                                                 mesh)


def _resolve_attention(attention_fn, ecfg: ExtractConfig, mesh: Optional[Mesh]):
    return _mesh_attention_fn(mesh, ecfg.patch_count) if attention_fn == _AUTO \
        else attention_fn


def make_train_step(cfg: VTAMIQConfig, sampler: PatchSampler, ecfg: ExtractConfig,
                    optimizer: Optimizer, is_pairwise: bool = False,
                    use_pref_module: bool = False,
                    weighted_loss: bool = False, compute_dtype=torch.bfloat16,
                    attention_fn=_AUTO, mesh: Optional[Mesh] = None) -> Callable:
    """``step(params, opt_state, mask, imgs_raw, qs, valid, loss_weights,
    sample_generator, generator=None, img_hw=None) -> (metrics, q_pred)``:
    the extraction (patches drawn from the CPU ``sample_generator``) then
    ``make_train_step_on_patches``' step. ``attention_fn``: "auto" (the ring
    on a sequence-parallel mesh, else flash attention past the long-sequence
    threshold), None (plain attention) or an ``attention_fn`` of
    ``ops/attention.py``. ``mesh``: imgs_raw, qs and img_hw are this rank's
    rows of the global batch, ``valid`` the global count (see
    ``make_train_step_on_patches``)."""
    extract = _extract_fn(sampler, ecfg, mesh)
    on_patches = make_train_step_on_patches(cfg, optimizer, weighted_loss, compute_dtype,
                                            _resolve_attention(attention_fn, ecfg, mesh),
                                            is_pairwise, use_pref_module, mesh)

    def step(params, opt_state, mask, imgs_raw, qs, valid, loss_weights, sample_generator,
             generator=None, img_hw=None):
        patches, pos, scales = extract(imgs_raw, sample_generator, img_hw)
        return on_patches(params, opt_state, mask, patches, pos, scales, qs, valid,
                          loss_weights, generator)

    return step


def make_eval_step(cfg: VTAMIQConfig, sampler: PatchSampler, ecfg: ExtractConfig,
                   is_pairwise: bool = False, use_pref_module: bool = False,
                   weighted_loss: bool = False,
                   compute_dtype=torch.bfloat16, attention_fn=_AUTO,
                   mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(params, imgs_raw, qs, valid, loss_weights,
    sample_generator, img_hw=None) -> (metrics, q_pred)``; patches are drawn
    anew on every call. ``mesh``: as in ``make_train_step``."""
    extract = _extract_fn(sampler, ecfg, mesh)
    on_patches = make_eval_step_on_patches(cfg, weighted_loss, compute_dtype,
                                           _resolve_attention(attention_fn, ecfg, mesh),
                                           is_pairwise, use_pref_module, mesh)

    def step(params, imgs_raw, qs, valid, loss_weights, sample_generator, img_hw=None):
        patches, pos, scales = extract(imgs_raw, sample_generator, img_hw)
        return on_patches(params, patches, pos, scales, qs, valid, loss_weights)

    return step
