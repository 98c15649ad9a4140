"""The port's flash attention against the JAX package's on the CPU: the
plain versions of the CUDA kernels against the Pallas kernels run in
interpret mode, and the autograd function against ``jax.vjp`` of JAX's
``flash_attention``. Inputs are made from a seed with numpy."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vtamiq_tpu.ops import attention as jattn
from vtamiq_tpu_torch.ops import attention as tattn
from vtamiq_tpu_torch.ops import flash_kernel

B, H, S, D = 2, 2, 256, 64
BLOCK = 128
# fp32: the same math summed in another order (dense against blockwise
# online softmax; the fused backward's dq partials summed outside): a few
# fp32 ulps of the largest element.
FP32_TOL = 1e-5
# bf16: both round p and ds to bf16 before their products, but the Pallas
# kernel's p is relative to the running maximum of its key block and the
# dense version's to the row maximum, so terms differ by up to one bf16
# ulp (2^-8 relative).
BF16_TOL = 2e-2


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def inputs(dtype, seed=0, b=B, h=H, s=S, d=D):
    """q, k, v, do as (B, H, S, D) numpy fp32 (rounded to bf16 when the
    dtype is bf16) and a (B, S) mask with a padded tail and, in row 1, a
    fully masked first key block."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    mask = np.ones((b, s), bool)
    mask[:, s - 56:] = False
    mask[1, :BLOCK] = False
    return arrs, mask


def to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
def test_plain_forward_matches_pallas_forward(dtype, tol):
    (q, k, v, _), mask = inputs(dtype)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = jattn._flash_forward(*(to_jax(a, dtype) for a in (q, k, v)),
                                          jnp.asarray(mask), BLOCK, BLOCK)
    out, lse = flash_kernel.flash_forward_plain(*(to_torch(a, dtype) for a in (q, k, v)),
                                                torch.from_numpy(mask))
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert rel_err(out.float(), jout.astype(jnp.float32)) <= tol
    assert rel_err(lse, np.asarray(jlse)[..., 0]) <= tol


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
def test_plain_backward_matches_pallas_backward(dtype, tol, fused):
    """fp32 tolerance 1e-4 of the largest element: dq, dk, dv are sums of
    256 products of terms that are themselves sums (dp, delta), in other
    orders in the two versions."""
    (q, k, v, do), mask = inputs(dtype, seed=1)
    jq, jk, jv, jdo = (to_jax(a, dtype) for a in (q, k, v, do))
    jmask = jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = jattn._flash_forward(jq, jk, jv, jmask, BLOCK, BLOCK)
        want = jattn._flash_backward(jq, jk, jv, jdo, jout, jlse, jmask, BLOCK, BLOCK,
                                     fused=fused)
    delta = np.sum(np.asarray(jdo, np.float32) * np.asarray(jout.astype(jnp.float32)), -1)
    got = flash_kernel.flash_backward(
        *(to_torch(a, dtype) for a in (q, k, v, do)),
        torch.from_numpy(np.asarray(jlse)[..., 0].copy()), torch.from_numpy(delta),
        torch.from_numpy(mask), fused=fused)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert rel_err(g.float(), w.astype(jnp.float32)) <= tol
    # keys masked out get no gradient
    assert float(got[1][:, :, S - 56:].abs().max()) == 0.0
    assert float(got[2][1, :, :BLOCK].abs().max()) == 0.0


def test_delta_is_the_jax_formula():
    (q, k, v, do), mask = inputs("float32", seed=2)
    out, _ = flash_kernel.flash_forward_plain(*(to_torch(a, "float32") for a in (q, k, v)),
                                              torch.from_numpy(mask))
    want = np.sum(do * out.numpy(), -1)
    got = flash_kernel.delta_of(torch.from_numpy(do), out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_autograd_flash_attention_matches_jax_vjp(masked, fused):
    """The port's flash_attention (forward kernel, backward kernels, here
    their plain versions) against jax.vjp of JAX's flash_attention on its
    CPU path, at S = 200 (padded to 256 by the port, to 1024 by JAX), fp32,
    (B, S, H, D) layout. Tolerance 1e-5 of the largest element: the same
    math in another summation order."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 200, 2, 32
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((b, s), bool)
        mask[0, 150:] = False
        mask[1, :70] = False

    def jfn(q, k, v):
        return jattn.flash_attention(q, k, v, None if mask is None else jnp.asarray(mask),
                                     block_q=64, block_k=64, use_pallas=False)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                                fused_bwd=fused)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert out.shape == (b, s, h, d)
    assert rel_err(out.detach(), jout) <= FP32_TOL
    for got, want in zip(grads, jgrads):
        assert rel_err(got, want) <= FP32_TOL


def test_flash_attention_without_grad_skips_the_residuals():
    (q, k, v, _), mask = inputs("float32", seed=4, s=100, d=16)
    tq, tk, tv = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy()) for a in (q, k, v))
    with torch.no_grad():
        out = tattn.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    want, _ = flash_kernel.flash_forward_plain(
        *(torch.from_numpy(np.pad(a, ((0, 0), (0, 0), (0, 28), (0, 0)))) for a in (q, k, v)),
        torch.from_numpy(np.pad(mask, ((0, 0), (0, 28)))))
    np.testing.assert_allclose(out.numpy(), want.transpose(1, 2)[:, :100].numpy(),
                               rtol=0, atol=0)


def test_attention_fn_below_threshold_matches_jax():
    """make_attention_fn's quadratic branch against the JAX package's (fp32
    logits and softmax; 1e-6 of the largest element)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 96, 2, 16)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(2, 96)) > 0.2
    want = jattn.make_attention_fn(threshold=128)(*(jnp.asarray(a) for a in (q, k, v)),
                                                  jnp.asarray(mask))
    got = tattn.make_attention_fn(threshold=128)(*(torch.from_numpy(a) for a in (q, k, v)),
                                                 torch.from_numpy(mask))
    assert rel_err(got, want) <= 1e-6
    # at or past the threshold the same call takes flash attention
    flash = tattn.make_attention_fn(threshold=96)(*(torch.from_numpy(a) for a in (q, k, v)),
                                                  torch.from_numpy(mask))
    assert rel_err(flash, want) <= FP32_TOL


def test_padding_covers_the_block():
    assert tattn._seq_padding(5009, 64) == 5056 - 5009
    assert tattn._seq_padding(5056, 64) == 0
    assert tattn._seq_padding(200, 64, 128) == 56


def test_kernel_checks_run_on_the_cpu_path_too():
    """The wrappers' argument checks hold for CPU tensors as well."""
    q = torch.zeros(1, 1, 64, 64)
    with pytest.raises(ValueError, match="mask"):
        flash_kernel.flash_forward(q, q, q, torch.ones(1, 63, dtype=torch.bool))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_kernel.flash_forward(q.half(), q.half(), q.half(), torch.ones(1, 64, dtype=torch.bool))
    assert math.isfinite(float(flash_kernel.flash_forward(
        q, q, q, torch.zeros(1, 64, dtype=torch.bool))[1].max()))
