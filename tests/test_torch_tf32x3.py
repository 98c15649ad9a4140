"""The numerics of the fp32 flash kernels (``csrc/flash_attention_tf32x3.cu``:
the forward and the backward's dq and dk/dv kernels), emulated in PyTorch
on the CPU.

The kernels take fp32-accurate products on the tensor cores as 3xTF32: each
fp32 operand x is split into big = tf32_rna(x) and small = tf32_rna(x - big)
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero, to 10 mantissa
bits), and a product is big.big + big.small + small.big. The tensor cores
multiply tf32 values exactly (two 11-bit significands fit in fp32's 24), so
float64 arithmetic on the parts emulates a product. These tests show that
three terms keep fp32 accuracy, well inside the kernels' fp32 gates (1e-5
of the largest output element, 1e-4 of the largest gradient element) where
one TF32 product does not, and why the kernels sum each 16-token chunk from
zero before adding it to a long accumulator. The kernels themselves run only on a card
(``tests/test_torch_kernels_gpu.py``). Inputs are made from a seed with
numpy.
"""

import math

import numpy as np
import pytest
import torch

from vtamiq_tpu_torch.ops import flash_kernel

FP32_GRAD_GATE = 1e-4   # the kernels' gate on fp32 gradients against the plain version
FP32_OUT_GATE = 1e-5    # the forward's gate on fp32 out and lse against the plain version


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as ``cvt.rna.tf32.f32``: the 13 low mantissa bits
    dropped, rounding to nearest with ties away from zero (adding half of
    the dropped range to the magnitude bits carries into the kept ones)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_tf32x3(a, b):
    """a @ b as the kernels take it: big.big + big.small + small.big, each
    product exact, summed in float64."""
    (ab, as_), (bb, bs) = split(a), split(b)

    def mm(u, v):
        return torch.matmul(u.double(), v.double())

    return mm(as_, bb) + mm(ab, bs) + mm(ab, bb)


def mm_tf32(a, b):
    """a @ b from one TF32 product (the operands rounded to tf32)."""
    return torch.matmul(tf32_rna(a).double(), tf32_rna(b).double())


def mm_exact(a, b):
    return torch.matmul(a.double(), b.double())


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def tiles(seed, shape=(64, 64), count=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(count)]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11   # half of tf32's ulp at 1
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      one + 3 * half_ulp, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one, one + 4 * half_ulp,
                         0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    (y,) = tiles(0, (4096,), 1)
    r = tf32_rna(y * 1e3)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - y * 1e3).abs() / (y * 1e3).abs()).max()) <= 2.0 ** -11


def test_split_keeps_fp32_to_two_to_the_minus_22():
    """x - big is exact in fp32, so x = big + small up to small's own
    rounding: 2^-11 of |x - big| <= 2^-22 |x|."""
    (x,) = tiles(1, (4096,), 1)
    big, small = split(x)
    rest = x.double() - big.double() - small.double()
    assert float((rest.abs() / x.double().abs()).max()) <= 2.0 ** -22
    assert float((small.abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_term_product_is_fp32_accurate(seed):
    """64x64 fp32 tiles: the three-term product within 1e-6 of the float64
    product (it measures about 1e-7, like an fp32 product), one TF32
    product not within 1e-4."""
    a, b = tiles(seed)
    want = mm_exact(a, b)
    assert rel_err(mm_tf32x3(a, b), want) <= 1e-6
    assert rel_err(mm_tf32x3(a, b), want) <= 2 * rel_err(torch.matmul(a, b), want)
    assert rel_err(mm_tf32(a, b), want) > 1e-4


def backward(q, k, v, do, lse, delta, mask, mm):
    """The backward kernels' function with each product taken by ``mm``;
    p and ds stay fp32, as in the fp32 kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = mm(q, k.transpose(-1, -2)).float() * scale
    logits = logits.masked_fill(~mask[:, None, None, :], flash_kernel.NEG_INF)
    p = torch.exp(logits - lse[..., None])
    dv = mm(p.transpose(-1, -2), do)
    ds = p * (mm(do, v.transpose(-1, -2)).float() - delta[..., None]) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_in_tf32x3_is_well_inside_the_fp32_gates(seed):
    """The backward at (2, 2, 256, 64) with a padded tail: in 3xTF32 within
    1/50 of the fp32 gate of the float64 result and of the plain fp32
    version; in one TF32 product past the gate."""
    q, k, v, do = tiles(seed, (2, 2, 256, 64), 4)
    mask = torch.ones(2, 256, dtype=torch.bool)
    mask[:, 200:] = False
    mask[1, 64:128] = False
    out, lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    delta = flash_kernel.delta_of(do, out)
    exact = backward(*(t.double() for t in (q, k, v, do, lse, delta)), mask, torch.matmul)
    plain = flash_kernel.flash_backward_plain(q, k, v, do, lse, delta, mask)
    tf32x3 = backward(q, k, v, do, lse, delta, mask, mm_tf32x3)
    tf32 = backward(q, k, v, do, lse, delta, mask, mm_tf32)
    for got, want, fp32 in zip(tf32x3, exact, plain):
        assert rel_err(got, want) <= FP32_GRAD_GATE / 50
        assert rel_err(got, fp32) <= FP32_GRAD_GATE / 50
    assert max(rel_err(got, want) for got, want in zip(tf32, exact)) > FP32_GRAD_GATE
    # masked keys get no gradient: p is exactly 0 there, and so are its parts
    for g in tf32x3[1:]:
        assert float(g[:, :, 200:].abs().max()) == 0.0


def round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> fp32, truncating: how the tensor cores round the sums
    they add into an accumulator."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_chunked_accumulation_avoids_the_truncation_drift():
    """dv's row over 5008 queries, p >= 0, as the dk/dv kernel takes it:
    8 queries a mma.sync, 3 of them (3xTF32) per step. Adding every step
    into one accumulator with truncation drifts toward zero by a few 1e-5
    (comparable to the fp32 gate); summing each 16-query chunk from zero
    and adding it in fp32 with rounding to nearest, as the kernels do,
    stays within 2e-6."""
    rng = np.random.default_rng(0)
    n, d = 5008, 64
    p = rng.exponential(size=n) * 20 / n
    do = rng.normal(size=(n, d))
    exact = p @ do

    def err(acc):
        return float(np.abs(acc - exact).max() / np.abs(exact).max())

    long_acc = np.zeros(d, np.float32)
    chunked = np.zeros(d, np.float32)
    for c in range(0, n, 16):
        part = np.zeros(d, np.float32)
        for s in range(c, c + 16, 8):
            step = p[s:s + 8] @ do[s:s + 8]
            for _ in range(3):
                long_acc = round_toward_zero(long_acc.astype(np.float64) + step / 3)
                part = round_toward_zero(part.astype(np.float64) + step / 3)
        chunked = chunked + part
    assert err(long_acc) > 1e-5
    assert err(chunked) <= 2e-6


def mma_sum(a, b, acc=None):
    """acc + a @ b as the kernels take it on the tensor cores: the depth in
    steps of 8 (one mma.sync), each step's three products (small.big,
    big.small, big.big, in the kernels' order) added to the fp32
    accumulator with truncation."""
    (ab, as_), (bb, bs) = split(a), split(b)
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        d = slice(k0, k0 + 8)
        for u, w in ((as_, bb), (ab, bs), (ab, bb)):
            step = torch.matmul(u[..., d].double(), w[..., d, :].double())
            acc = torch.from_numpy(round_toward_zero((acc.double() + step).numpy()))
    return acc


def forward_tf32x3(q, k, v, mask, chunked=True):
    """The forward kernel's arithmetic on (B, H, S, D) fp32 inputs: S of
    each 32-key tile in 3xTF32, an online softmax over the tiles with p
    unrounded in fp32, and P V in 16-key chunks, each summed from zero and
    added to O in fp32 (``chunked``) or added into O straight away, as the
    tensor cores would with one long accumulator. q may have fewer rows
    than k and v. Returns (out, lse)."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, s), flash_kernel.NEG_INF, dtype=torch.float32)
    l = torch.zeros((b, h, s), dtype=torch.float32)
    o = torch.zeros((b, h, s, d), dtype=torch.float32)
    for t0 in range(0, k.shape[2], 32):
        x = mma_sum(q, k[:, :, t0:t0 + 32].transpose(-1, -2)) * scale
        x = x.masked_fill(~mask[:, None, None, t0:t0 + 32], flash_kernel.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None]
        m = m_new
        for c0 in (t0, t0 + 16):
            pc, vc = p[..., c0 - t0:c0 - t0 + 16], v[:, :, c0:c0 + 16]
            o = o + mma_sum(pc, vc) if chunked else mma_sum(pc, vc, o)
    l = l.clamp_min(1e-30)
    return o / l[..., None], m + torch.log(l)


def exact_forward(q, k, v, mask):
    """(out, lse) of masked softmax attention in float64."""
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~mask[:, None, None, :], flash_kernel.NEG_INF)
    return torch.matmul(torch.softmax(logits, -1), v.double()), torch.logsumexp(logits, -1)


def fp32_forward_mask(b, s):
    """A padded tail, a 32-key tile with no valid key after valid ones, and
    one before any valid key."""
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - 37:] = False
    mask[-1, 64:96] = False
    mask[0, :32] = False
    return mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_in_tf32x3_is_inside_the_fp32_gate(seed):
    """The emulated forward at (2, 2, 192, 64) with a masked tail and fully
    masked key tiles: out and lse within a quarter of the 1e-5 gate of the
    plain fp32 version and of the float64 result (they measure 1.0e-6 to
    1.7e-6, where the plain version is 5e-7 to 9e-7 from float64), p never
    NaN; one TF32 product past the gate."""
    q, k, v = tiles(seed, (2, 2, 192, 64), 3)
    mask = fp32_forward_mask(2, 192)
    out, lse = forward_tf32x3(q, k, v, mask)
    plain_out, plain_lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    exact_out, exact_lse = exact_forward(q, k, v, mask)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    for want_out, want_lse in ((plain_out, plain_lse), (exact_out, exact_lse)):
        assert rel_err(out, want_out) <= FP32_OUT_GATE / 4
        lse_scale = max(1.0, float(want_lse.abs().max()))
        lse_err = float((lse.double() - want_lse.double()).abs().max())
        assert lse_err <= FP32_OUT_GATE / 4 * lse_scale
    logits = mm_tf32(q, k.transpose(-1, -2)) / math.sqrt(64)
    logits = logits.masked_fill(~mask[:, None, None, :], flash_kernel.NEG_INF)
    tf32_out = torch.matmul(tf32_rna(torch.softmax(logits, -1).float()).double(),
                            tf32_rna(v).double())
    assert rel_err(tf32_out, exact_out) > FP32_OUT_GATE


def test_forward_chunked_accumulation_avoids_the_truncation_drift():
    """16 queries over the 5000-patch keys (5009 valid of 5056), as
    the forward kernel walks them: adding every mma.sync of P V into O with
    truncation drifts out past the 1e-5 gate; summing each 16-key chunk
    from zero and adding it in fp32, as the kernel does, stays within
    2e-6 of the float64 result."""
    q, k, v = tiles(3, (1, 1, 16, 64), 1)[0], *tiles(4, (1, 1, 5056, 64), 2)
    mask = torch.zeros(1, 5056, dtype=torch.bool)
    mask[:, :5009] = True
    exact = exact_forward(q, k, v, mask)[0]
    chunked = forward_tf32x3(q, k, v, mask)[0]
    long = forward_tf32x3(q, k, v, mask, chunked=False)[0]
    assert rel_err(chunked, exact) <= 2e-6
    assert rel_err(long, exact) > FP32_OUT_GATE
