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
  embedding; the last layer computes only the leading ``num_tokens`` queries.

Training: ``train=True`` with a ``torch.Generator`` (on the compute
device) turns on the encoder DropPath when ``cfg.vit_path_drop_active``
(timm semantics: a per-sample keep mask and a 1/keep rescale; the draws
cannot match JAX's PRNG). ``attention_fn`` (``ops/attention.py``) replaces
the quadratic attention of every layer but the last, whose ``q_len`` path
stays quadratic, as in the JAX package.

Left out, against the JAX package: the token axis is not padded to a
multiple of 128 (that is TPU lane alignment; masking of invalid keys is
kept; the flash path pads to its own tile), Houlsby adapters raise at
construction, and ``cfg.remat`` raises in training.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
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
        if cfg.num_adapters > 0:
            raise NotImplementedError(
                "Houlsby adapters (ViTConfig.num_adapters > 0) are not ported "
                "to vtamiq_tpu_torch yet; see ROADMAP.md")
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
    it) is added, as in the JAX package."""
    dtype = dtype or x.dtype
    out_dtype = out_dtype or dtype
    if out_dtype == dtype:
        y = x.to(dtype) @ p.kernel.to(dtype)
    else:
        # e.g. bf16 inputs feeding an fp32 stream ("mixed"): bf16 products
        # are exact in fp32, so an fp32 product of the upcast inputs is the
        # fp32-accumulated bf16 product
        y = (x.to(dtype).float() @ p.kernel.to(dtype).float()).to(out_dtype)
    return y + p.bias.to(out_dtype)


def mhsa(p: Attention, x: torch.Tensor, num_heads: int,
         mask: Optional[torch.Tensor] = None, logits_fp32: bool = False,
         q_len: Optional[int] = None, mm_dtype=None,
         attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Multi-head self-attention.

    x: (B, S, H); mask: optional (B, S) bool of valid keys (invalid keys get
    NEG_INF logits). ``q_len`` restricts the queries to the first q_len
    tokens (keys and values stay full): output (B, q_len, H).
    ``attention_fn(q, k, v, mask)`` on (B, S, heads, D) tensors replaces the
    plain quadratic form when ``q_len`` is None."""
    b, s, h = x.shape
    d = h // num_heads
    dtype = x.dtype
    mm = mm_dtype or dtype

    if attention_fn is not None and q_len is None:
        q, k, v = (dense(dp, x, mm).reshape(b, s, num_heads, d)
                   for dp in (p.query, p.key, p.value))
        ctx = attention_fn(q, k, v, mask).reshape(b, s, h)
        return dense(p.out, ctx, mm, out_dtype=dtype)

    xq = x if q_len is None else x[:, :q_len]
    sq = xq.shape[1]
    q = dense(p.query, xq, mm).reshape(b, sq, num_heads, d).transpose(1, 2)
    k = dense(p.key, x, mm).reshape(b, s, num_heads, d).transpose(1, 2)
    v = dense(p.value, x, mm).reshape(b, s, num_heads, d).transpose(1, 2)

    if logits_fp32 or dtype == torch.float32:
        logits = q.float() @ k.float().transpose(-1, -2)
    else:
        logits = q @ k.transpose(-1, -2)  # stored in the matmul dtype
    logits = logits / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(mm)
    ctx = (probs @ v).transpose(1, 2).reshape(b, sq, h)
    return dense(p.out, ctx, mm, out_dtype=dtype)


def mlp_block(p: Mlp, x: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    y = F.gelu(dense(p.fc1, x, mm_dtype))
    return dense(p.fc2, y, mm_dtype, out_dtype=x.dtype)


def dropout(x: torch.Tensor, prob: float, generator: Optional[torch.Generator],
            shape=None) -> torch.Tensor:
    """Keep each element (or each cell of a ``shape`` that broadcasts to x)
    with probability 1 - prob and scale it by 1/keep; prob 0 is the identity.
    ``generator`` lives on x's device."""
    if prob <= 0.0:
        return x
    keep = 1.0 - prob
    kept = torch.rand(x.shape if shape is None else shape, generator=generator,
                      device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, prob: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (timm semantics): each item of the batch
    axis is kept whole with probability 1 - prob, scaled by 1/keep."""
    return dropout(x, prob, generator, (x.shape[0],) + (1,) * (x.dim() - 1))


def encoder_layer(p: EncoderLayer, x: torch.Tensor, cfg: ViTConfig, mask=None,
                  q_len: Optional[int] = None, mm_dtype=None, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """Pre-LN block: x += DP(LS1(MHSA(LN(x)))); x += DP(LS2(MLP(LN(x)))).
    With ``q_len`` the block's output covers only the first q_len tokens.
    DropPath acts in training with a generator when
    ``cfg.vit_path_drop_active``."""
    dp_prob = cfg.path_drop_prob if (train and cfg.vit_path_drop_active
                                     and generator is not None) else 0.0
    h = mhsa(p.attn, layer_norm(p.ln1, x), cfg.num_heads, mask=mask,
             logits_fp32=cfg.attn_logits_fp32, q_len=q_len, mm_dtype=mm_dtype,
             attention_fn=attention_fn)
    if cfg.use_layer_scale:
        h = h * p.ls1.to(h.dtype)
    h = drop_path(h, dp_prob, generator)
    x = (x if q_len is None else x[:, :q_len]) + h

    h = mlp_block(p.mlp, layer_norm(p.ln2, x), mm_dtype)
    if cfg.use_layer_scale:
        h = h * p.ls2.to(h.dtype)
    return x + drop_path(h, dp_prob, generator)


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
                  compute_dtype=torch.float32) -> torch.Tensor:
    """(B, N, P, P, 3) or (B, N, P*P*3) pixel patches -> (B, T + N, H)
    tokens: CLS (plus pos slot 0), the register tokens, then the patches."""
    emb = p.embeddings
    b, n = patches.shape[0], patches.shape[1]
    stream, mm = resolve_dtypes(compute_dtype)

    x = patches.reshape(b, n, -1).to(mm or stream)
    if cfg.use_patch_embedding:
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

def vit_forward(p: ViT, cfg: ViTConfig, patches: torch.Tensor, pos: torch.Tensor,
                scales: Optional[torch.Tensor] = None, *, tokens_only: bool = True,
                patch_mask: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16, train: bool = False,
                generator: Optional[torch.Generator] = None,
                attention_fn: Optional[Callable] = None) -> torch.Tensor:
    """ViT forward over a sparse patch sequence.

    patches: (B, N, P, P, 3); pos: (B, N, 2) uv centers in [0, 1);
    scales: optional (B, N) ints; patch_mask: optional (B, N) bool, False =
    padded patch, excluded as a key (CLS and register tokens are always
    valid). Returns fp32 (B, num_tokens, H) when ``tokens_only`` (the last
    layer then computes only those queries), else (B, T + N, H). ``train``,
    ``generator`` and ``attention_fn``: see ``encoder_layer``."""
    if train and cfg.remat:
        raise NotImplementedError("ViTConfig.remat (recomputing encoder layers in the "
                                  "backward) is not ported to vtamiq_tpu_torch yet; "
                                  "see ROADMAP.md")
    b = patches.shape[0]
    t = cfg.num_tokens
    _, mm_dtype = resolve_dtypes(compute_dtype)
    x = embed_patches(p, cfg, patches, pos, scales, compute_dtype)

    mask = None
    if patch_mask is not None:
        mask = torch.cat([torch.ones(b, t, dtype=torch.bool, device=x.device),
                          patch_mask.to(torch.bool)], dim=1)

    layers = p.encoder.layers
    n_layers = cfg.effective_num_layers
    for i in range(n_layers):
        q_len = t if (tokens_only and i == n_layers - 1) else None
        x = encoder_layer(layers[f"layer_{i}"], x, cfg, mask=mask, q_len=q_len,
                          mm_dtype=mm_dtype, train=train, generator=generator,
                          attention_fn=attention_fn)

    x = layer_norm(p.encoder.final_ln, x).float()
    return x[:, :t] if tokens_only else x
