"""Sparse-patch Vision Transformer in PyTorch.

Port of ``vtamiq_tpu/models/vit.py``. The modules below only hold
parameters, named after the JAX package's pytree paths; the forward math is
in plain functions on tensors that keep the JAX functions' names and
numerics:

- dense kernels are ``(in, out)`` and products are ``x @ kernel`` (fp32
  accumulation; the result is rounded once to the output dtype);
- LayerNorm runs in fp32 with eps 1e-6; GELU is exact (erf); softmax is fp32;
- attention logits are stored in the matmul dtype unless
  ``attn_logits_fp32`` is set or the residual stream is fp32;
- CLS takes positional slot 0; register tokens take no pos or scale
  embedding; the last layer computes only the leading ``num_tokens`` queries;
- Houlsby adapters (``num_adapters``, reduction 4) follow the attention and
  the MLP of each layer, before the LayerScale.

Training: ``train=True`` with a ``torch.Generator`` (on the compute
device) turns on the encoder DropPath when ``cfg.vit_path_drop_active``
(timm semantics: a per-sample keep mask and a 1/keep rescale; the draws
cannot match JAX's PRNG). Each layer's two keep masks are drawn before the
layer runs, so ``cfg.remat`` (``torch.utils.checkpoint`` per encoder layer,
the layer recomputed in the backward) gives the same masks, and the same
gradients, as a run without it. ``attention_fn`` (``ops/attention.py``)
replaces the quadratic attention of every layer but the last, whose
``q_len`` path stays quadratic, as in the JAX package.

The token axis is padded only on request (``pad_seq_to``; the JAX package
pads to 128 by default, for TPU lanes), with the padding masked as keys.
Under a mesh (``vit_forward(mesh=...)``, ``parallel/``) the attention and
MLP run tensor-parallel over its "model" ranks (Megatron: the column- and
row-parallel denses with one all-reduce a sublayer) and the tokens split
over its "seq" ranks, attention running the ring.
``load_vit_npz`` reads ImageNet ViT weights in the ``ViT-B_16.npz`` layout.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .configs import INIT_NORM_STD, ViTConfig

NEG_INF = -1e9


# --------------------------------------------------------------------------
# parameter holders (names follow the JAX pytree paths)
# --------------------------------------------------------------------------

class Dense(nn.Module):
    """``kernel`` (in, out) and ``bias`` (out,), the JAX layout."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, fan_out))
        self.bias = nn.Parameter(torch.empty(fan_out))


class QuantDense(nn.Module):
    """An int8 dense holder (``ops/quant.py::quantize_params_int8``):
    ``kernel_q8`` (in, out) int8, ``kernel_scale`` (out,) fp32 and ``bias``
    (out,), all buffers. ``kernel_q8`` is stored column-major (its transpose
    is contiguous), the layout cuBLASLt's int8 product takes without a copy."""

    def __init__(self, kernel_q8: torch.Tensor, kernel_scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("kernel_q8", kernel_q8.t().contiguous().t())
        self.register_buffer("kernel_scale", kernel_scale)
        self.register_buffer("bias", bias)


class LayerNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


class Attention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query, self.key, self.value, self.out = (Dense(h, h) for _ in range(4))


class Mlp(nn.Module):
    def __init__(self, h: int, m: int):
        super().__init__()
        self.fc1 = Dense(h, m)
        self.fc2 = Dense(m, h)


class Adapter(nn.Module):
    """Houlsby adapter: ``down`` (H, H/4) and ``up`` (H/4, H)."""

    def __init__(self, h: int, reduction: int = 4):
        super().__init__()
        self.down = Dense(h, h // reduction)
        self.up = Dense(h // reduction, h)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.attn = Attention(h)
        self.mlp = Mlp(h, cfg.mlp_dim)
        self.ln1 = LayerNormParams(h)
        self.ln2 = LayerNormParams(h)
        if cfg.use_layer_scale:
            self.ls1 = nn.Parameter(torch.empty(h))
            self.ls2 = nn.Parameter(torch.empty(h))
        if cfg.num_adapters > 0:
            self.adapters = nn.ModuleDict({
                f"adapter_{a}": nn.ModuleDict({"attn": Adapter(h), "mlp": Adapter(h)})
                for a in range(cfg.num_adapters)})


class Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h, p = cfg.hidden_size, cfg.patch_size
        if cfg.use_patch_embedding:
            self.patch = Dense(p * p * 3, h)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(h))
        if cfg.num_extra_tokens > 0:
            self.extra_tokens = nn.Parameter(torch.empty(cfg.num_extra_tokens, h))
        if cfg.use_pos_embedding:
            self.pos_embeddings = nn.Parameter(torch.empty(cfg.pos_grid ** 2 + 1, h))
        if cfg.use_scale_embedding:
            self.scale_embeddings = nn.Parameter(torch.empty(cfg.num_scales + 1, h))


class Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layers = nn.ModuleDict({f"layer_{i}": EncoderLayer(cfg)
                                     for i in range(cfg.effective_num_layers)})
        self.final_ln = LayerNormParams(cfg.hidden_size)


class ViT(nn.Module):
    """Parameters of the sparse-patch ViT; ``forward`` is ``vit_forward``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, patches, pos, scales=None, **kwargs):
        return vit_forward(self, self.cfg, patches, pos, scales, **kwargs)


# --------------------------------------------------------------------------
# initialization (seeded from a torch.Generator)
# --------------------------------------------------------------------------

def _xavier_(dense: Dense, generator: torch.Generator):
    """Xavier-uniform kernel + zero bias (the JAX package's _linear_init)."""
    fan_in, fan_out = dense.kernel.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    dense.kernel.uniform_(-limit, limit, generator=generator)
    dense.bias.zero_()


def _trunc_normal_(t: torch.Tensor, generator: torch.Generator):
    nn.init.trunc_normal_(t, std=INIT_NORM_STD, a=-2.0 * INIT_NORM_STD,
                          b=2.0 * INIT_NORM_STD, generator=generator)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of a ViT/VTAMIQ module tree in place with the
    JAX package's initializers: Xavier-uniform dense kernels and zero biases,
    truncated normal (std 0.02, +-2 std) tokens and embeddings, ones for
    LayerNorm scales and LayerScales, 0.25 for PReLU slopes. Draws come from
    ``generator`` in module order, so a seed fixes every weight."""
    for sub in module.modules():
        if isinstance(sub, Dense):
            _xavier_(sub, generator)
        elif isinstance(sub, LayerNormParams):
            sub.scale.fill_(1.0)
            sub.bias.zero_()
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "extra_tokens", "pos_embeddings", "scale_embeddings"):
            _trunc_normal_(p, generator)
        elif leaf in ("ls1", "ls2", "diff_scale"):
            p.fill_(1.0)
        elif leaf == "prelu":
            p.fill_(0.25)
    return module


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def layer_norm(p: LayerNormParams, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in fp32 regardless of the stream dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p.scale.float(), p.bias.float(), eps)
    return y.to(x.dtype)


def resolve_dtypes(compute_dtype):
    """Compute policy -> (stream_dtype, mm_dtype). A torch dtype means the
    residual stream and the matmul inputs share it (mm_dtype None); the
    string ``"mixed"`` means an fp32 stream with bf16 matmul inputs."""
    if isinstance(compute_dtype, str) and compute_dtype == "mixed":
        return torch.float32, torch.bfloat16
    return compute_dtype, None


def dense(p: Dense, x: torch.Tensor, dtype=None, out_dtype=None) -> torch.Tensor:
    """y = x @ kernel + bias. ``dtype``: matmul input dtype (default
    x.dtype); products accumulate in fp32. ``out_dtype`` (default ``dtype``):
    result dtype; the fp32 sum is rounded to it once, then the bias (cast to
    it) is added, as in the JAX package. A ``QuantDense`` holder takes the
    int8 path (``ops/quant.py::dense_q8``) and returns ``out_dtype``."""
    if isinstance(p, QuantDense):
        from ..ops.quant import dense_q8
        return dense_q8(p, x, out_dtype or dtype)
    dtype = dtype or x.dtype
    out_dtype = out_dtype or dtype
    return _product(p, x, dtype, out_dtype) + p.bias.to(out_dtype)


def _product(p: Dense, x: torch.Tensor, dtype, out_dtype) -> torch.Tensor:
    """x @ kernel in ``dtype``, rounded once to ``out_dtype``."""
    if out_dtype == dtype:
        return x.to(dtype) @ p.kernel.to(dtype)
    # e.g. bf16 inputs feeding an fp32 stream ("mixed"): bf16 products
    # are exact in fp32, so an fp32 product of the upcast inputs is the
    # fp32-accumulated bf16 product
    return (x.to(dtype).float() @ p.kernel.to(dtype).float()).to(out_dtype)


def dense_row_parallel(p: Dense, x: torch.Tensor, group, dtype=None,
                       out_dtype=None) -> torch.Tensor:
    """``dense`` of a kernel split by input features over the model ranks of
    ``group`` (x holds this rank's features): the partial products are
    summed over the group in fp32 (``parallel/comm.py::reduce_from_model``),
    rounded once to ``out_dtype``, then the replicated bias is added."""
    from ..parallel.comm import reduce_from_model
    dtype = dtype or x.dtype
    out_dtype = out_dtype or dtype
    partial = _product(p, x, dtype, out_dtype).float()
    return reduce_from_model(partial, group).to(out_dtype) + p.bias.to(out_dtype)


def _column_input(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel dense: its gradient sums over the
    model ranks of ``group`` (none without TP)."""
    if group is None:
        return x
    from ..parallel.comm import copy_to_model
    return copy_to_model(x, group)


def mhsa(p: Attention, x: torch.Tensor, num_heads: int,
         mask: Optional[torch.Tensor] = None, logits_fp32: bool = False,
         q_len: Optional[int] = None, mm_dtype=None,
         attention_fn: Optional[Callable] = None, return_attention: bool = False,
         tp_group=None):
    """Multi-head self-attention.

    x: (B, S, H); mask: optional (B, S) bool of valid keys (invalid keys get
    NEG_INF logits). ``q_len`` restricts the queries to the first q_len
    tokens (keys and values stay full): output (B, q_len, H).
    ``attention_fn(q, k, v, mask)`` on (B, S, heads, D) tensors replaces the
    plain quadratic form when ``q_len`` is None and ``return_attention`` is
    not set. ``return_attention``: return (out, probs) with the (B, heads,
    S_q, S) attention probabilities in the matmul dtype. ``tp_group``: the
    model ranks of a tensor-parallel mesh; q, k and v then hold this rank's
    heads (column-parallel) and ``out`` sums the ranks' partial products
    (row-parallel)."""
    b, s, h = x.shape
    d = h // num_heads
    dtype = x.dtype
    mm = mm_dtype or dtype
    x = _column_input(x, tp_group)
    heads = num_heads if tp_group is None else num_heads // tp_group.size()

    def project(ctx, sq):
        ctx = ctx.reshape(b, sq, heads * d)
        if tp_group is None:
            return dense(p.out, ctx, mm, out_dtype=dtype)
        return dense_row_parallel(p.out, ctx, tp_group, mm, out_dtype=dtype)

    if attention_fn is not None and q_len is None and not return_attention:
        q, k, v = (dense(dp, x, mm).reshape(b, s, heads, d)
                   for dp in (p.query, p.key, p.value))
        return project(attention_fn(q, k, v, mask), s)

    xq = x if q_len is None else x[:, :q_len]
    sq = xq.shape[1]
    q = dense(p.query, xq, mm).reshape(b, sq, heads, d).transpose(1, 2)
    k = dense(p.key, x, mm).reshape(b, s, heads, d).transpose(1, 2)
    v = dense(p.value, x, mm).reshape(b, s, heads, d).transpose(1, 2)

    if logits_fp32 or dtype == torch.float32:
        logits = q.float() @ k.float().transpose(-1, -2)
    else:
        logits = q @ k.transpose(-1, -2)  # stored in the matmul dtype
    logits = logits / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(mm)
    out = project((probs @ v).transpose(1, 2), sq)
    return (out, probs) if return_attention else out


def mlp_block(p: Mlp, x: torch.Tensor, mm_dtype=None, tp_group=None) -> torch.Tensor:
    """fc2(gelu(fc1(x))); with ``tp_group`` fc1 holds this rank's features
    (column-parallel) and fc2 sums the ranks' partial products
    (row-parallel)."""
    y = F.gelu(dense(p.fc1, _column_input(x, tp_group), mm_dtype))
    if tp_group is None:
        return dense(p.fc2, y, mm_dtype, out_dtype=x.dtype)
    return dense_row_parallel(p.fc2, y, tp_group, mm_dtype, out_dtype=x.dtype)


def adapter_block(p: Adapter, x: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    """Houlsby adapter: x + up(gelu(down(x)))."""
    y = F.gelu(dense(p.down, x, mm_dtype))
    return x + dense(p.up, y, mm_dtype, out_dtype=x.dtype)


def rand_rows(shape, generator: Optional[torch.Generator], device,
              rows: Optional[Tuple[torch.Tensor, int]] = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``. ``rows``: (index, total):
    the leading axis is ``index`` (a (shape[0],) int64 tensor) of a global
    batch of ``total`` rows; the draw is made for the global batch and
    these rows are kept, so every rank of a data-parallel mesh, from a
    generator in the same state, draws what one process draws for them."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    index, total = rows
    return torch.rand((total,) + tuple(shape[1:]), generator=generator,
                      device=device)[index.to(device)]


def dropout(x: torch.Tensor, prob: float, generator: Optional[torch.Generator],
            shape=None, rows=None) -> torch.Tensor:
    """Keep each element (or each cell of a ``shape`` that broadcasts to x)
    with probability 1 - prob and scale it by 1/keep; prob 0 is the identity.
    ``generator`` lives on x's device; ``rows``: see ``rand_rows``."""
    if prob <= 0.0:
        return x
    kept = rand_rows(x.shape if shape is None else shape, generator, x.device, rows) \
        < 1.0 - prob
    return apply_keep_mask(x, kept, prob)


def apply_keep_mask(x: torch.Tensor, kept: torch.Tensor, prob: float) -> torch.Tensor:
    """x / keep where ``kept`` (broadcast to x), else 0; keep = 1 - prob."""
    keep = 1.0 - prob
    return torch.where(kept, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, prob: float, generator: Optional[torch.Generator],
              rows=None) -> torch.Tensor:
    """Per-sample stochastic depth (timm semantics): each item of the batch
    axis is kept whole with probability 1 - prob, scaled by 1/keep."""
    return dropout(x, prob, generator, (x.shape[0],) + (1,) * (x.dim() - 1), rows)


def drop_path_masks(x: torch.Tensor, cfg: ViTConfig, train: bool,
                    generator: Optional[torch.Generator],
                    rows=None) -> Optional[Tuple[torch.Tensor, ...]]:
    """An encoder layer's two DropPath keep masks, (B, 1, 1) bool each
    (after the attention, after the MLP), drawn from ``generator`` in that
    order; None where DropPath does not act. ``rows``: see ``rand_rows``."""
    if not (train and cfg.vit_path_drop_active and generator is not None
            and cfg.path_drop_prob > 0.0):
        return None
    keep = 1.0 - cfg.path_drop_prob
    return tuple(rand_rows((x.shape[0], 1, 1), generator, x.device, rows) < keep
                 for _ in range(2))


def _layer_adapter(p: EncoderLayer, adapter_num: int) -> Optional[nn.ModuleDict]:
    if adapter_num < 0 or not hasattr(p, "adapters"):
        return None
    name = f"adapter_{adapter_num}"
    if name not in p.adapters:
        raise ValueError(f"adapter_num {adapter_num}: the layer has adapters "
                         f"{list(p.adapters)}")
    return p.adapters[name]


def encoder_layer(p: EncoderLayer, x: torch.Tensor, cfg: ViTConfig, mask=None,
                  q_len: Optional[int] = None, mm_dtype=None,
                  keep_masks: Optional[Tuple[torch.Tensor, ...]] = None,
                  attention_fn: Optional[Callable] = None, adapter_num: int = -1,
                  return_attention: bool = False, tp_group=None):
    """Pre-LN block: x += DP(LS1(A(MHSA(LN(x))))); x += DP(LS2(A(MLP(LN(x))))),
    A the layer's adapter ``adapter_num`` (-1: none), DP DropPath with the
    keep masks ``keep_masks`` (``drop_path_masks``; None: no DropPath).
    With ``q_len`` the block's output covers only the first q_len tokens.
    ``tp_group``: the model ranks of a tensor-parallel mesh (see ``mhsa``,
    ``mlp_block``). Returns (x, the attention probabilities with
    ``return_attention``, else None)."""
    adapter = _layer_adapter(p, adapter_num)
    out = mhsa(p.attn, layer_norm(p.ln1, x), cfg.num_heads, mask=mask,
               logits_fp32=cfg.attn_logits_fp32, q_len=q_len, mm_dtype=mm_dtype,
               attention_fn=attention_fn, return_attention=return_attention,
               tp_group=tp_group)
    h, probs = out if return_attention else (out, None)
    if adapter is not None:
        h = adapter_block(adapter["attn"], h, mm_dtype)
    if cfg.use_layer_scale:
        h = h * p.ls1.to(h.dtype)
    if keep_masks is not None:
        h = apply_keep_mask(h, keep_masks[0], cfg.path_drop_prob)
    x = (x if q_len is None else x[:, :q_len]) + h

    h = mlp_block(p.mlp, layer_norm(p.ln2, x), mm_dtype, tp_group)
    if adapter is not None:
        h = adapter_block(adapter["mlp"], h, mm_dtype)
    if cfg.use_layer_scale:
        h = h * p.ls2.to(h.dtype)
    if keep_masks is not None:
        h = apply_keep_mask(h, keep_masks[1], cfg.path_drop_prob)
    return x + h, probs


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def uv_pos_lookup(pos_table: torch.Tensor, pos: torch.Tensor, grid: int) -> torch.Tensor:
    """uv in [0,1)^2 -> learned positional embedding at
    index = floor(u*grid)*grid + floor(v*grid) + 1 (+1 skips the CLS slot),
    each floor clipped to [0, grid-1]. pos: (..., 2) -> (..., H)."""
    q = torch.clamp(torch.floor(pos * grid).to(torch.int64), 0, grid - 1)
    return pos_table[q[..., 0] * grid + q[..., 1] + 1]


def scale_lookup(scale_table: torch.Tensor, scales: torch.Tensor, num_scales: int) -> torch.Tensor:
    """Scale index -> embedding: clamp to [0, num_scales-1], then +1."""
    return scale_table[torch.clamp(scales, 0, num_scales - 1).to(torch.int64) + 1]


def embed_patches(p: ViT, cfg: ViTConfig, patches: torch.Tensor, pos: torch.Tensor,
                  scales: Optional[torch.Tensor] = None,
                  compute_dtype=torch.float32, pre_embedded: bool = False) -> torch.Tensor:
    """(B, N, P, P, 3) or (B, N, P*P*3) pixel patches [or, with
    ``pre_embedded``, (B, N, H) features that skip the patch embedding] ->
    (B, T + N, H) tokens: CLS (plus pos slot 0), the register tokens, then
    the patches. The flag is explicit: for B/16, P*P*3 == H == 768."""
    emb = p.embeddings
    b, n = patches.shape[0], patches.shape[1]
    stream, mm = resolve_dtypes(compute_dtype)

    x = patches.reshape(b, n, -1).to(mm or stream)
    if cfg.use_patch_embedding and not pre_embedded:
        x = dense(emb.patch, x, mm, out_dtype=stream)
    else:
        x = x.to(stream)
    if cfg.use_pos_embedding:
        x = x + uv_pos_lookup(emb.pos_embeddings, pos, cfg.pos_grid).to(stream)
    if cfg.use_scale_embedding:
        if scales is None:
            raise ValueError("ViT uses scale embeddings but scales is None.")
        x = x + scale_lookup(emb.scale_embeddings, scales, cfg.num_scales).to(stream)

    tokens = []
    if cfg.use_cls_token:
        cls = emb.cls_token
        if cfg.use_pos_embedding:
            cls = cls + emb.pos_embeddings[0]  # CLS gets pos slot 0 (quirk)
        tokens.append(cls.to(stream).expand(b, 1, cfg.hidden_size))
    if cfg.num_extra_tokens > 0:
        tokens.append(emb.extra_tokens.to(stream).expand(b, cfg.num_extra_tokens,
                                                         cfg.hidden_size))
    if tokens:
        x = torch.cat(tokens + [x], dim=1)
    return x


# --------------------------------------------------------------------------
# full forward
# --------------------------------------------------------------------------

def _pad_tokens(x: torch.Tensor, mask: Optional[torch.Tensor], multiple: int):
    """Zero-pad the token axis of (B, S, H) to a multiple of ``multiple``;
    the padding is masked as keys."""
    b, s = x.shape[0], x.shape[1]
    pad = -(-s // multiple) * multiple - s
    if pad == 0:
        return x, mask
    x = F.pad(x, (0, 0, 0, pad))
    if mask is None:
        mask = torch.ones(b, s, dtype=torch.bool, device=x.device)
    return x, torch.cat([mask, mask.new_zeros(b, pad)], dim=1)


def vit_forward(p: ViT, cfg: ViTConfig, patches: torch.Tensor, pos: torch.Tensor,
                scales: Optional[torch.Tensor] = None, *, tokens_only: bool = True,
                patch_mask: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16, train: bool = False,
                generator: Optional[torch.Generator] = None,
                attention_fn: Optional[Callable] = None, adapter_num: int = -1,
                pad_seq_to: Optional[int] = None, pre_embedded: bool = False,
                return_attention: bool = False, return_layers: bool = False,
                mesh=None, rows=None):
    """ViT forward over a sparse patch sequence.

    patches: (B, N, P, P, 3) (or pre-embedded (B, N, H)); pos: (B, N, 2) uv
    centers in [0, 1); scales: optional (B, N) ints; patch_mask: optional
    (B, N) bool, False = padded patch, excluded as a key (CLS and register
    tokens are always valid). Returns fp32 (B, num_tokens, H) when
    ``tokens_only`` (the last layer then computes only those queries), else
    (B, S, H). ``train`` with a ``generator`` draws the encoder's DropPath
    masks (``drop_path_masks``); ``attention_fn`` and ``adapter_num`` (-1:
    no adapter): see ``encoder_layer``.
    ``pad_seq_to``: pad the tokens to a multiple of it (masked).

    ``return_attention`` / ``return_layers``: also return each layer's
    attention probabilities (the quadratic form, in place of
    ``attention_fn``) / output states, as (x, attentions, layers); either
    turns off the last layer's query slice. In training with ``cfg.remat``
    each layer's activations are recomputed in the backward.

    ``mesh`` (``parallel/mesh.py``): its "model" ranks run the layers tensor
    parallel, each holding its shard (``parallel.mesh.shard_params``). Its
    "seq" ranks split the tokens: the sequence pads to a multiple of
    ``BLOCK * seq`` (masked), each rank keeps its chunk after the embedding
    and the layers run the ring (``attention_fn`` must be
    ``parallel.ring_attention.make_ring_attention_fn(mesh)``); the last
    layer's input is all-gathered over "seq", since its ``q_len`` queries
    read every key, so it and the rest run on every rank. ``rows``: the
    rows' places in a global batch, for the DropPath draws (``rand_rows``)."""
    b = patches.shape[0]
    t = cfg.num_tokens
    _, mm_dtype = resolve_dtypes(compute_dtype)
    x = embed_patches(p, cfg, patches, pos, scales, compute_dtype, pre_embedded)

    mask = None
    if patch_mask is not None:
        mask = torch.cat([torch.ones(b, t, dtype=torch.bool, device=x.device),
                          patch_mask.to(torch.bool)], dim=1)
    if pad_seq_to is not None:
        x, mask = _pad_tokens(x, mask, pad_seq_to)

    layers = p.encoder.layers
    n_layers = cfg.effective_num_layers
    slice_last = tokens_only and not (return_attention or return_layers)
    tp_group, seq_group, full_mask = None, None, mask
    if mesh is not None:
        from ..parallel.mesh import MODEL_AXIS, SEQ_AXIS
        if mesh.size(MODEL_AXIS) > 1:
            tp_group = mesh.group(MODEL_AXIS)
        if mesh.size(SEQ_AXIS) > 1:
            if not slice_last:
                raise ValueError("a sequence-parallel forward returns the leading tokens "
                                 "only: no return_attention, return_layers or "
                                 "tokens_only=False")
            if getattr(attention_fn, "ring_mesh", None) is not mesh:
                raise ValueError("a sequence-parallel forward needs attention_fn = "
                                 "parallel.ring_attention.make_ring_attention_fn(mesh)")
            from ..ops.flash_kernel import BLOCK
            from ..parallel.ring_attention import shard_seq
            seq_group = mesh.group(SEQ_AXIS)
            x, full_mask = _pad_tokens(x, mask, BLOCK * mesh.size(SEQ_AXIS))
            x = shard_seq(x, mesh)
            mask = None if full_mask is None else shard_seq(full_mask, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    attentions: List[torch.Tensor] = []
    states: List[torch.Tensor] = []
    for i in range(n_layers):
        q_len = t if (slice_last and i == n_layers - 1) else None
        layer = layers[f"layer_{i}"]
        if seq_group is not None and q_len is not None:
            from ..parallel.comm import all_gather_autograd
            x, mask = all_gather_autograd(x, seq_group, dim=1), full_mask
        keep_masks = drop_path_masks(x, cfg, train, generator, rows)

        def run(x, layer=layer, q_len=q_len, keep_masks=keep_masks, mask=mask):
            return encoder_layer(layer, x, cfg, mask, q_len, mm_dtype, keep_masks,
                                 attention_fn, adapter_num, return_attention, tp_group)

        if remat:
            # the keep masks are drawn above, outside the recomputed
            # function, so no random state needs restoring for the recompute
            x, probs = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                                         preserve_rng_state=False)
        else:
            x, probs = run(x)
        if return_attention:
            attentions.append(probs)
        if return_layers:
            states.append(x)

    x = layer_norm(p.encoder.final_ln, x).float()
    if tokens_only:
        x = x[:, :t]
        states = [st[:, :t] for st in states]
    if return_attention or return_layers:
        return x, attentions, states
    return x


# --------------------------------------------------------------------------
# ImageNet ViT weights (the jax-format ViT-B_16.npz layout)
# --------------------------------------------------------------------------

def _triangle_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in, out) fp32 weights of ``jax.image.resize(..., "bilinear")`` along
    one axis: a triangle kernel at half-pixel centres, widened by in/out
    when shrinking (antialiasing), normalized per output sample."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0).astype(np.float32))


def resize_bilinear(grid: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(h, w, C) -> (out_h, out_w, C) as ``jax.image.resize`` with method
    "bilinear" (antialiased when shrinking), in fp32."""
    wh = _triangle_weights(grid.shape[0], out_h)
    ww = _triangle_weights(grid.shape[1], out_w)
    return torch.einsum("ijc,ia,jb->abc", grid.float(), wh, ww)


@torch.no_grad()
def load_vit_npz(npz: Mapping, cfg: ViTConfig, params: ViT) -> ViT:
    """Load jax-format ImageNet ViT weights (a ``ViT-B_16.npz`` mapping: an
    ``np.load`` result or a dict) into the ViT module ``params``, in place.

    The npz is already in the (in, out) layout; attention kernels reshape
    from (H, heads, d) / (heads, d, H) to (H, H). A positional grid of
    another size is resized as ``jax.image.resize`` bilinear resizes it.
    Keys the file lacks, and layers it does not have, keep their values."""
    h = cfg.hidden_size
    emb = params.embeddings

    def a(name):
        return torch.from_numpy(np.array(npz[name], dtype=np.float32))

    def put(target: torch.Tensor, value: torch.Tensor):
        target.copy_(value.reshape(target.shape).to(target.dtype))

    if cfg.use_patch_embedding and "embedding/kernel" in npz:
        # HWIO (P, P, 3, H) -> (P*P*3, H): the (h, w, c) patch flatten
        put(emb.patch.kernel, a("embedding/kernel").reshape(-1, h))
        put(emb.patch.bias, a("embedding/bias"))
    if cfg.use_cls_token and "cls" in npz:
        put(emb.cls_token, a("cls"))
    key = "Transformer/posembed_input/pos_embedding"
    if cfg.use_pos_embedding and key in npz:
        posemb = a(key)
        posemb = posemb.reshape(posemb.shape[-2], posemb.shape[-1])  # (1 + G*G, H)
        if posemb.shape[0] != cfg.pos_grid ** 2 + 1:
            tok, grid_flat = posemb[:1], posemb[1:]
            gs_old, gs_new = int(math.sqrt(grid_flat.shape[0])), cfg.pos_grid
            grid = resize_bilinear(grid_flat.reshape(gs_old, gs_old, -1), gs_new, gs_new)
            posemb = torch.cat([tok, grid.reshape(gs_new * gs_new, -1)], dim=0)
        emb.pos_embeddings.copy_(posemb)

    enc = params.encoder
    if "Transformer/encoder_norm/scale" in npz:
        put(enc.final_ln.scale, a("Transformer/encoder_norm/scale"))
        put(enc.final_ln.bias, a("Transformer/encoder_norm/bias"))
    for i in range(cfg.effective_num_layers):
        root = f"Transformer/encoderblock_{i}"
        if f"{root}/LayerNorm_0/scale" not in npz:
            continue
        layer = enc.layers[f"layer_{i}"]
        attn = f"{root}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value", "out"):
            dense_p = getattr(layer.attn, name)
            put(dense_p.kernel, a(f"{attn}/{name}/kernel").reshape(h, h))
            put(dense_p.bias, a(f"{attn}/{name}/bias"))
        for ours, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            dense_p = getattr(layer.mlp, ours)
            put(dense_p.kernel, a(f"{root}/MlpBlock_3/{theirs}/kernel"))
            put(dense_p.bias, a(f"{root}/MlpBlock_3/{theirs}/bias"))
        for ours, theirs in (("ln1", "LayerNorm_0"), ("ln2", "LayerNorm_2")):
            ln = getattr(layer, ours)
            put(ln.scale, a(f"{root}/{theirs}/scale"))
            put(ln.bias, a(f"{root}/{theirs}/bias"))
    return params
