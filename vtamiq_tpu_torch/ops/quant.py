"""Post-training int8 quantization for the serving path (W8A8, dynamic).

Port of ``vtamiq_tpu/ops/quant.py``, with the same names and arithmetic:

- weights: symmetric per-output-channel int8, ``scale = max(amax(col) / 127,
  1e-12)``, rounded half to even and clipped to +-127, once at load time
  (``quantize_params_int8``);
- activations: symmetric per-row int8 from the row's amax, on the fly;
- the product: int8 x int8 accumulated in int32 (``int8_matmul``), then an
  fp32 dequant, the fp32 bias, and a cast to the caller's dtype.

The product is the only matmul of the path. The JAX package leaves it to
XLA (a ``dot_general`` with an int32 result, no Pallas kernel), and the port
leaves it to the library: ``torch._int_mm`` (cuBLASLt, s8 x s8 -> s32) for
tensors on the card, its plain version ``int8_matmul_plain`` (a float64
``torch.matmul``, exact: the largest sum, 3072 * 127^2, is far inside int32
and float64's 53 bits) for tensors on the CPU. ``_int_mm`` takes
more than 16 rows and inner and outer sizes that are multiples of 8: fewer
rows are padded with zero rows, which are dropped from the result. The
activation quant and the dequant are plain PyTorch.

In the port the tree is an ``nn.Module``: ``quantize_params_int8`` returns a
new module in which every eligible ``Dense`` holder is a ``QuantDense``
(``models/vit.py``), and ``models/vit.py::dense`` dispatches on it, so every
encoder call site (q, k, v, out, fc1, fc2, the patch embed) takes the int8
path with no change. Only the scorer quantizes, and only its encoder.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import Dense, QuantDense

# leaves whose kernel has any dim below this stay un-quantized: tiny matmuls
# (adapter bottlenecks at small widths, the 1-wide head) gain nothing and
# per-channel scales would be noisy
MIN_QUANT_DIM = 64
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows

launches = 0  # torch._int_mm calls in this process; callers may reset it to 0


def quantize_dense_params(p: Dense) -> QuantDense:
    """``Dense`` {kernel, bias} -> ``QuantDense`` {kernel_q8, kernel_scale,
    bias}; the bias is shared with ``p``."""
    k = p.kernel.detach().float()
    scale = torch.clamp_min(torch.amax(torch.abs(k), dim=0) / 127.0, 1e-12)  # (out,)
    q = torch.clamp(torch.round(k / scale[None, :]), -127, 127).to(torch.int8)
    return QuantDense(q, scale, p.bias.detach())


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 on any device, as a float64
    product: exact, since every partial sum is an integer of magnitude at
    most K * 127^2, far below 2^53 (CUDA has no integer matmul)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. CUDA tensors go
    through ``torch._int_mm`` (or raise), CPU tensors through the plain
    version."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N) int8, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K = {k}, "
                         f"N = {b.shape[1]}")
    if m < INT_MM_MIN_ROWS:  # zero rows quantize to zero and are dropped
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    global launches
    launches += 1
    return torch._int_mm(a.contiguous(), b)[:m]


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 of x (..., in) in fp32: (xq int8, amax (..., 1))
    with xq = round(x * (127 / amax)), amax = max(|row|, 1e-12)."""
    xf = x.float()
    amax = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1, keepdim=True), 1e-12)
    return torch.round(xf * torch.div(127.0, amax)).to(torch.int8), amax


def dense_q8(p: QuantDense, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """int8 dense: a dynamic per-row activation quant, an int32 accumulate,
    an fp32 dequant with the fp32 bias. x: (..., in) -> (..., out) in
    ``dtype`` (default x.dtype)."""
    dtype = dtype or x.dtype
    xq, amax = quantize_rows(x)
    n = p.kernel_q8.shape[1]
    y32 = int8_matmul(xq.reshape(-1, x.shape[-1]), p.kernel_q8).reshape(*x.shape[:-1], n)
    y = y32.float() * (amax / 127.0) * p.kernel_scale
    return (y + p.bias.float()).to(dtype)


def map_dense(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A new module in which each ``Dense`` holder ``d`` at state-dict prefix
    ``name`` (e.g. ``"encoder.layers.layer_0.mlp.fc1."``) is ``fn(d, name)``;
    ``module`` is left as it is, and the new module shares every other
    parameter and buffer with it. ``QuantDense`` holders stay as they are."""
    if isinstance(module, Dense):
        return fn(module, prefix)
    if isinstance(module, QuantDense) or not module._modules:
        return module
    new = copy.copy(module)
    new._parameters = copy.copy(module._parameters)
    new._buffers = copy.copy(module._buffers)
    new._modules = type(module._modules)(
        (name, None if child is None else map_dense(child, fn, f"{prefix}{name}."))
        for name, child in module._modules.items())
    return new


def quantize_params_int8(module: nn.Module) -> nn.Module:
    """A new module in which every ``Dense`` holder with both dims of at
    least ``MIN_QUANT_DIM`` is a ``QuantDense``; the input module is left as
    it is. Idempotent. Apply to the whole model or to a submodule (the
    scorer quantizes ``params.vit`` only)."""
    def quantize(d: Dense, _name: str) -> nn.Module:
        if d.kernel.dim() == 2 and min(d.kernel.shape) >= MIN_QUANT_DIM:
            return quantize_dense_params(d)
        return d
    return map_dense(module, quantize)


def with_child(module: nn.Module, name: str, child: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose submodule ``name`` is ``child``;
    ``module`` is left as it is."""
    new = copy.copy(module)
    new._modules = copy.copy(module._modules)
    new._modules[name] = child
    return new


def count_quantized_leaves(module: nn.Module) -> int:
    """Number of int8 dense holders in a module tree."""
    return sum(isinstance(m, QuantDense) for m in module.modules())
