"""The CUDA kernels against their plain versions, on a card.

These tests import neither JAX nor the JAX package, so they also run on a
machine with an NVIDIA GPU and no JAX:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Without a CUDA device they skip (the kernels have no CPU mode).
"""

import pytest
import torch

from vtamiq_tpu_torch.ops import gather_kernel

P = 16
MEAN, STD = (0.5, 0.4, 0.3), (0.5, 0.25, 0.2)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel bit for bit against the plain version on the same
    card tensors (run on a machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for h, w in ((384, 512), (384, 481)):
        img = torch.rand(4, h, w, 3, generator=gen).cuda()
        ti = torch.randint(-3, h - P + 4, (4, 500), generator=gen, dtype=torch.int32).cuda()
        tj = torch.randint(-3, w - P + 4, (4, 500), generator=gen, dtype=torch.int32).cuda()
        for norm, dt in (((MEAN, [1 / s for s in STD]), torch.bfloat16),
                         ((None, None), torch.float32)):
            before = gather_kernel.launches
            got = gather_kernel.gather_patches(img, ti, tj, P, *norm, out_dtype=dt)
            torch.cuda.synchronize()
            assert gather_kernel.launches == before + 1
            want = gather_kernel.gather_patches_plain(img, ti, tj, P, *norm, out_dtype=dt)
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# flash attention kernels
# ---------------------------------------------------------------------------

from vtamiq_tpu_torch.ops import flash_kernel  # noqa: E402

# fp32: the kernels and the plain versions differ only in summation order
# (online softmax against a dense one; the fused backward adds dq partials
# with atomics in no fixed order). bf16: both round p and ds to bf16 but at
# different points (the kernel's p is relative to the running maximum), so
# they differ by about one bf16 ulp (2^-8) per product term.
FLASH_TOL = {torch.float32: dict(out=1e-5, lse=1e-5, grad=1e-4),
             torch.bfloat16: dict(out=2e-2, lse=2e-2, grad=2e-2)}


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def flash_inputs(dtype, b=2, h=3, s=256, d=64, seed=0):
    """(B, H, S, D) views of (B, S, H, D) tensors (the model's layout), a
    mask with a padded tail and one fully masked key block, and the
    backward's do, lse and delta."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen).to(dtype).cuda().transpose(1, 2)
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - 37:] = False
    mask[1, 64:128] = False
    mask = mask.cuda()
    out, lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    delta = flash_kernel.delta_of(do, out)
    return q, k, v, do, mask, lse, delta


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_on_card(dtype):
    """The four flash kernels against their plain versions on the same card
    tensors (run on a machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    tol = FLASH_TOL[dtype]
    q, k, v, do, mask, lse, delta = flash_inputs(dtype)
    before = dict(flash_kernel.launches)

    out, lse_k = flash_kernel.flash_forward(q, k, v, mask)
    torch.cuda.synchronize()
    want_out, want_lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    assert out.stride() == q.stride()
    assert rel_err(out, want_out) <= tol["out"]
    assert float((lse_k - want_lse).abs().max()) <= tol["lse"] * max(1.0, float(want_lse.abs().max()))

    want = flash_kernel.flash_backward_plain(q, k, v, do, lse, delta, mask)
    fused = flash_kernel.flash_backward_fused(q, k, v, do, lse, delta, mask)
    dq = flash_kernel.flash_backward_dq(q, k, v, do, lse, delta, mask)
    dk, dv = flash_kernel.flash_backward_dkv(q, k, v, do, lse, delta, mask)
    torch.cuda.synchronize()
    for got in (fused, (dq, dk, dv)):
        for g, w in zip(got, want):
            assert rel_err(g, w) <= tol["grad"]
    # masked keys get no gradient
    assert float(fused[1][:, :, -37:].abs().max()) == 0.0
    assert float(dv[1, :, 64:128].abs().max()) == 0.0
    assert {n: flash_kernel.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_fused": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, mask, lse, delta = flash_inputs(torch.bfloat16, s=192)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_kernel.flash_forward(q[:, :, :100], k[:, :, :100], v[:, :, :100], mask[:, :100])
    q32 = torch.zeros(1, 1, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="head dim 64"):
        flash_kernel.flash_forward(q32, q32, q32, torch.ones(1, 64, dtype=torch.bool, device="cuda"))
    h16 = q.half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_kernel.flash_forward(h16, h16, h16, mask)
