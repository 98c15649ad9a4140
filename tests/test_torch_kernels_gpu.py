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


def _corners_past_every_edge(gen, m, h, w, p, n):
    """(M, N) int32 corners on the card, the first 8 of each image past an
    edge or a corner of the image (the kernel clamps them, as the plain
    version does)."""
    ti = torch.randint(0, h - p + 1, (m, n), generator=gen, dtype=torch.int32)
    tj = torch.randint(0, w - p + 1, (m, n), generator=gen, dtype=torch.int32)
    ti[:, :8] = torch.tensor([-7, h, 0, h - p, -1, h - p + 1, 3, 5], dtype=torch.int32)
    tj[:, :8] = torch.tensor([3, 9, -2, w, -9, w - p + 3, w - p + 1, -1], dtype=torch.int32)
    return ti.cuda(), tj.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("p", [7, 8, 16, 32])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_gather_kernel_matches_plain_over_patch_sizes_and_channels_on_card(c, p):
    """Both instances of the gather kernel (the scorer's P = 16, C = 3 and
    the generic one) bit for bit against the plain version: an odd width of
    481, corners past every edge, bf16 out with the normalization fused and
    fp32 out without it; P = 7 gives patches that are no whole number of
    16-byte chunks, P = 32 with C = 4 patches of several staged segments
    (run on a machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather kernel has no CPU mode")
    gen = torch.Generator().manual_seed(10 * c + p)
    h, w, m, n = 96, 481, 3, 137
    img = torch.rand(m, h, w, c, generator=gen).cuda()
    ti, tj = _corners_past_every_edge(gen, m, h, w, p, n)
    mean = tuple(0.1 * (i + 1) for i in range(c))
    inv_std = tuple(1.0 / (0.2 + 0.05 * i) for i in range(c))
    for norm, dt in (((mean, inv_std), torch.bfloat16), ((None, None), torch.float32)):
        before = gather_kernel.launches
        got = gather_kernel.gather_patches(img, ti, tj, p, *norm, out_dtype=dt)
        torch.cuda.synchronize()
        assert gather_kernel.launches == before + 1
        want = gather_kernel.gather_patches_plain(img, ti, tj, p, *norm, out_dtype=dt)
        assert got.shape == (m, n, p, p, c) and got.dtype == dt
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# flash attention kernels
# ---------------------------------------------------------------------------

from vtamiq_tpu_torch.ops import flash_kernel  # noqa: E402

# fp32: the kernels and the plain versions differ only in summation order
# (online softmax against a dense one; the backward's products in 3xTF32,
# about 2^-22 of each term from fp32). bf16: both round p and ds to bf16
# but at different points (the kernel's p is relative to the running
# maximum), so they differ by about one bf16 ulp (2^-8) per product term.
FLASH_TOL = {torch.float32: dict(out=1e-5, lse=1e-5, grad=1e-4),
             torch.bfloat16: dict(out=2e-2, lse=2e-2, grad=2e-2)}


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def flash_inputs(dtype, b=2, h=3, s=256, d=64, seed=0, mask=None):
    """(B, H, S, D) views of (B, S, H, D) tensors (the model's layout), a
    mask (by default a padded tail and one fully masked key block), and the
    backward's do, lse and delta."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen).to(dtype).cuda().transpose(1, 2)
                   for _ in range(4))
    if mask is None:
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
    # the fp32 forward copies rows by 16-byte cp.async: a token stride of 66
    # floats is not a multiple of 4
    wide = torch.zeros(1, 1, 64, 66, device="cuda")[..., :64]
    one = torch.ones(1, 64, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_kernel.flash_forward(wide, wide, wide, one)


def _awkward_mask(case):
    """(B, H, S, mask) of the awkward cases: S of one 64-token tile; S = 192
    (the kernels' 128-row blocks then end in a half-empty one); a batch row
    with a single valid key beside a row whose middle key tile has no valid
    key; B = H = 1."""
    if case == "s64":
        b, h, s = 2, 3, 64
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[1, 40:] = False
    elif case == "s192":
        b, h, s = 2, 3, 192
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[1, 150:] = False
    elif case == "one_key_and_empty_tile":
        b, h, s = 2, 3, 192
        mask = torch.zeros(b, s, dtype=torch.bool)
        mask[0, 5] = True
        mask[1] = True
        mask[1, 64:128] = False
    else:  # "b1_h1"
        b, h, s = 1, 1, 256
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[0, 219:] = False
    return b, h, s, mask


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["s64", "s192", "one_key_and_empty_tile", "b1_h1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_awkward_shapes_on_card(dtype, case):
    """The forward, the fused backward and the split backward's dq and
    dk/dv kernels against their plain versions where the tiles do not line
    up with the data (run on a machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    tol = FLASH_TOL[dtype]
    b, h, s, mask = _awkward_mask(case)
    q, k, v, do, mask, lse, delta = flash_inputs(dtype, b=b, h=h, s=s, seed=1, mask=mask)
    out, lse_k = flash_kernel.flash_forward(q, k, v, mask)
    fused = flash_kernel.flash_backward_fused(q, k, v, do, lse, delta, mask)
    split = (flash_kernel.flash_backward_dq(q, k, v, do, lse, delta, mask),
             *flash_kernel.flash_backward_dkv(q, k, v, do, lse, delta, mask))
    torch.cuda.synchronize()
    want_out, want_lse = flash_kernel.flash_forward_plain(q, k, v, mask)
    want = flash_kernel.flash_backward_plain(q, k, v, do, lse, delta, mask)
    assert rel_err(out, want_out) <= tol["out"]
    lse_scale = max(1.0, float(want_lse.abs().max()))
    assert float((lse_k - want_lse).abs().max()) <= tol["lse"] * lse_scale
    invalid = ~mask[:, None, :, None].expand_as(fused[1])
    for grads in (fused, split):
        for g, w in zip(grads, want):
            assert bool(torch.isfinite(g).all())
            assert rel_err(g, w) <= tol["grad"]
        # keys masked out get no gradient
        for g in grads[1:]:
            assert float(g.float()[invalid].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["s64", "s192", "one_key_and_empty_tile", "b1_h1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_is_deterministic_at_awkward_shapes_on_card(dtype, case):
    """Two launches of the forward kernel on the same inputs give the same
    out and lse bit for bit (no atomics), and finite values even for the
    row whose only valid key leaves every other key tile empty (run on a
    machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    b, h, s, mask = _awkward_mask(case)
    q, k, v, _, mask, _, _ = flash_inputs(dtype, b=b, h=h, s=s, seed=4, mask=mask)
    first = flash_kernel.flash_forward(q, k, v, mask)
    second = flash_kernel.flash_forward(q, k, v, mask)
    torch.cuda.synchronize()
    for a, b2 in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_is_deterministic_on_card(dtype):
    """Two launches of the fused backward, and of the split backward's dq
    and dk/dv kernels, on the same inputs give the same dq, dk and dv bit
    for bit (no atomics; run on a machine with an NVIDIA GPU; see
    README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    q, k, v, do, mask, lse, delta = flash_inputs(dtype, b=2, h=4, s=1024, seed=2)
    args = (q, k, v, do, lse, delta, mask)
    first = flash_kernel.flash_backward_fused(*args)
    second = flash_kernel.flash_backward_fused(*args)
    split = [(flash_kernel.flash_backward_dq(*args), *flash_kernel.flash_backward_dkv(*args))
             for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(*split):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_backward_equals_fused_on_card(dtype):
    """The split backward's dq and dk/dv kernels are the fused backward's
    two kernels, so they give its dq, dk and dv bit for bit (run on a
    machine with an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    q, k, v, do, mask, lse, delta = flash_inputs(dtype, b=2, h=3, s=448, seed=3)
    args = (q, k, v, do, lse, delta, mask)
    fused = flash_kernel.flash_backward_fused(*args)
    split = (flash_kernel.flash_backward_dq(*args), *flash_kernel.flash_backward_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(split, fused):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# weighted CAPS on the card
# ---------------------------------------------------------------------------

from vtamiq_tpu_torch.ops import sampling  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("diff_type", [sampling.DIFF_TYPE_SSIM, sampling.DIFF_TYPE_MAGNITUDE])
def test_weighted_sampler_on_card_matches_cpu(diff_type):
    """Weighted CAPS run on the card (diff maps, probability maps,
    allocation, corners) against the CPU on the card's probability maps
    copied over and the same draws: equal cell counts, corners within
    1e-3 px, and diff maps within 1e-5 of the CPU's (run on a machine with
    an NVIDIA GPU; see README)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this holds the card's weighted CAPS against the CPU")
    gen = torch.Generator().manual_seed(diff_type)
    b, h, w, p, n = 4, 192, 256, 16, 250
    ref = torch.rand(b, 1, h, w, 3, generator=gen)
    imgs = torch.cat([ref, (ref + 0.2 * torch.randn(ref.shape, generator=gen)).clamp(0, 1)], 1)
    s = sampling.PatchSampler(diff_weight=1.0, uniform_weight=0.1,
                              grid_type=sampling.GRID_TYPE_PERTURBED, diff_type=diff_type)
    diff_card = s.compute_diff(imgs.cuda())
    diff_cpu = s.compute_diff(imgs)
    assert rel_err(diff_card.cpu(), diff_cpu) <= 1e-5
    prob = s.sample_prob(h, w, diff_card)
    _, sh, sw = sampling._cell_layout(h, w, p, n)
    draws = sampling.WeightedDraws.stack([sampling.weighted_draws(gen, sh * sw, n)
                                          for _ in range(b)])
    counts = sampling.weighted_counts(prob, draws.gumbel.cuda(), h, w, p, n).cpu()
    pos = sampling.weighted_positions(prob, draws.to("cuda"), h, w, p, n).cpu()
    want_counts = sampling.weighted_counts(prob.cpu(), draws.gumbel, h, w, p, n)
    want_pos = sampling.weighted_positions(prob.cpu(), draws, h, w, p, n)
    assert torch.equal(counts, want_counts)
    assert float((pos - want_pos).abs().max()) <= 1e-3


# --------------------------------------------------------------------------
# the host data pipeline and the engine on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_loader_decodes_into_pinned_tensors_on_card(tmp_path):
    """The native batch decode writes each image into its slot of one
    pinned host tensor (padded slots for canonical buckets), which copies to
    the card without blocking and equals the images decoded one by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned host memory needs a CUDA build and card")
    from vtamiq_tpu_torch.data import datasets, native_io, synth
    from vtamiq_tpu_torch.data.pipeline import PatchDatasetLoader
    root = str(tmp_path)
    synth.generate_tid2013(f"{root}/tid2013", hw=(48, 64), image_refs=1)
    ds = datasets.TID2013Dataset(datasets_root=root)
    ds.add_split(datasets.dataset_split("S", [0]))
    for buckets in (0, 1):
        loader = PatchDatasetLoader(ds, "S", batch_size=8, patch_count=16, shuffle=True,
                                    allow_img_flip=True, seed=1, pin_memory=True,
                                    max_size_buckets=buckets)
        batches = list(loader)
        assert len(batches) == len(loader) == 15
        for batch in batches:
            assert batch.imgs_raw.is_pinned() and batch.qs.is_pinned()
            dev = batch.imgs_raw.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            for i in range(batch.valid):
                for k, path in enumerate(ds.sample_paths(int(batch.indices[i]))):
                    img = torch.from_numpy(native_io.decode_rgb(path))
                    got = dev[i, k].cpu()
                    assert any(torch.equal(got, f) for f in (
                        img, img.flip(0), img.flip(1), img.flip(0).flip(1)))


@pytest.mark.gpu
def test_engine_config3_path_two_steps_on_card(tmp_path):
    """engine.train() on the card at a small width through BASELINE config
    3's path (KADID-10k layout, weighted CAPS with the MAGNITUDE diff map,
    bf16, AdamW): two steps, one gather launch each, finite losses, and a
    checkpoint written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's device is cuda")
    import copy
    import json
    import os
    import numpy as np
    from vtamiq_tpu_torch.data import datasets, synth
    from vtamiq_tpu_torch.models.checkpoint import load_checkpoint
    from vtamiq_tpu_torch.ops import sampling
    from vtamiq_tpu_torch.train import config as C, engine
    names = ("global_config", "vit_config", "vtamiq_config", "dataset_config_base",
             "dataloader_config_base")
    snaps = {n: copy.deepcopy(getattr(C, n)) for n in names}
    registry = dict(C._DATASET_REGISTRY)
    root = str(tmp_path)
    synth.generate_kadid10k(f"{root}/kadid10k", hw=(96, 128), image_refs=1)

    class TwoBatchKADID(datasets.KADID10kDataset):
        num_ref_images, num_dist_images = 1, 8

        def __init__(self, **kw):
            kw.setdefault("datasets_root", root)
            super().__init__(**kw)

    try:
        C._DATASET_REGISTRY[C.DATASET_KADID10K] = (TwoBatchKADID,
                                                   C.setup_split_config([0], 0, 0))
        C.global_config.update(dataset=C.DATASET_KADID10K, device="cuda", do_train=True,
                               do_val=False, do_test=False, num_epochs=1, seed=3,
                               allow_use_full_dataset=False, compute_dtype="bfloat16",
                               output_dir=f"{root}/out", config_validated=False)
        C.vit_config.update(num_keep_layers=2, hidden_size=64, mlp_dim=128, num_heads=4)
        C.dataset_config_base["patch_sampler_config"] = dict(
            diff_weight=1.0, uniform_weight=0.1, grid_type=sampling.GRID_TYPE_PERTURBED,
            diff_type=sampling.DIFF_TYPE_MAGNITUDE)
        C.dataloader_config_base[C.DATALOADER_PARAMS][C.USE_DEFAULT_PARAMS] = True
        C.dataloader_config_base[C.SPLIT_NAME_TRAIN].update(batch_size=4, patch_count=100)
        before = gather_kernel.launches
        engine.train()
        assert gather_kernel.launches - before == 2
        assert engine.last_run_stats["train"][0]["batches"] == 2
        out = C.global_config["output_dir_final"]
        ckpt = load_checkpoint(os.path.join(out, "best.npz"))
        with open(os.path.join(out, "scalars.jsonl")) as f:
            assert all(np.isfinite(json.loads(line)["value"]) for line in f)
        assert ckpt["epoch"] == 1 and len(ckpt[C.MODEL_STATE_DICT]) > 0
    finally:
        for n, v in snaps.items():
            getattr(C, n).clear()
            getattr(C, n).update(v)
        C._DATASET_REGISTRY.clear()
        C._DATASET_REGISTRY.update(registry)


# --------------------------------------------------------------------------
# the PieAPP pretraining recipe and the model extras on the card
# --------------------------------------------------------------------------

def _small_cfg(**vit_over):
    from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
    vit = get_vit_config(**{**dict(num_keep_layers=2, num_extra_tokens=2, hidden_size=64,
                                   mlp_dim=128, num_heads=1), **vit_over})
    return VTAMIQConfig(vit=vit, num_rgs=1, num_rcabs=1, ca_reduction=4)


@pytest.mark.gpu
def test_pu_gather_equals_plain_on_card():
    """The use_pu mode's gather: the PU-encoded fp32 image, no
    normalization, bf16 out, rounded once by the kernel as it stores each
    patch; bit for bit against the plain version, and against the encoded
    image rounded to bf16 and then gathered."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather kernel has no CPU mode")
    from vtamiq_tpu_torch.utils.color_spaces import pu_display_encode_torch
    gen = torch.Generator().manual_seed(4)
    m, h, w, n = 6, 256, 256, 256
    pu = pu_display_encode_torch(torch.rand(m, h, w, 3, generator=gen).cuda())
    ti = torch.randint(0, h - P + 1, (m, n), generator=gen, dtype=torch.int32).cuda()
    tj = torch.randint(0, w - P + 1, (m, n), generator=gen, dtype=torch.int32).cuda()
    before = gather_kernel.launches
    got = gather_kernel.gather_patches(pu, ti, tj, P, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gather_kernel.launches == before + 1
    assert torch.equal(got, gather_kernel.gather_patches_plain(pu, ti, tj, P,
                                                               out_dtype=torch.bfloat16))
    rounded = pu.to(torch.bfloat16).float()
    assert torch.equal(got, gather_kernel.gather_patches_plain(rounded, ti, tj, P).to(
        torch.bfloat16))


@pytest.mark.gpu
def test_pairwise_step_with_preference_module_on_card():
    """One fp32 pairwise train step (K = 3, the preference module on) on
    the card against the same step on the CPU from the same weights and
    patches, TF32 off: loss to 1e-4, p after the step to 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    from vtamiq_tpu_torch.models.preference import attach_preference_module
    from vtamiq_tpu_torch.models.vtamiq import init_vtamiq_params
    from vtamiq_tpu_torch.train import optim, steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_cfg()
    base = init_vtamiq_params(cfg, torch.Generator().manual_seed(1))
    attach_preference_module(base, 6.0)
    gen = torch.Generator().manual_seed(2)
    patches = torch.rand(3, 3, 64, P, P, 3, generator=gen) * 2 - 1
    pos = torch.rand(3, 3, 64, 2, generator=gen)
    qs = torch.rand(3, generator=gen)
    out = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device)
        opt = optim.Optimizer("AdamW", lambda c: torch.tensor(1e-3), weight_decay=0.01)
        state = opt.init({n: p.detach() for n, p in model.named_parameters()})
        step = steps.make_train_step_on_patches(cfg, opt, compute_dtype=torch.float32,
                                                is_pairwise=True, use_pref_module=True)
        metrics, q = step(model, state, optim.build_freeze_mask(model, False),
                          patches.to(device), pos.to(device), None, qs.to(device), 3,
                          (1.0, 1.0, 1.0))
        out[device] = (float(metrics["loss"]), float(model.pref_module.p.detach()), q.cpu())
    (l_cpu, p_cpu, q_cpu), (l_card, p_card, q_card) = out["cpu"], out["cuda"]
    assert abs(l_card - l_cpu) <= 1e-4 and abs(p_card - p_cpu) <= 1e-6 and p_card != 6.0
    assert float((q_card - q_cpu).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_remat_step_gradients_equal_on_card():
    """A bf16 train forward and backward through the flash kernels with
    DropPath active: with remat (each encoder layer recomputed in the
    backward, its flash forward launched again) and without, every
    gradient bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    import dataclasses
    from vtamiq_tpu_torch.models.vtamiq import init_vtamiq_params, vtamiq_forward
    from vtamiq_tpu_torch.ops import flash_kernel
    from vtamiq_tpu_torch.ops.attention import make_attention_fn
    cfg = _small_cfg(path_drop_prob=0.3, vit_path_drop_active=True, num_layers=3,
                     num_keep_layers=3)
    base = init_vtamiq_params(cfg, torch.Generator().manual_seed(3)).cuda()
    gen = torch.Generator().manual_seed(4)
    patches = (torch.rand(2, 2, 300, P, P, 3, generator=gen) * 2 - 1).cuda()
    pos = torch.rand(2, 2, 300, 2, generator=gen).cuda()
    grads, fwd = [], []
    for remat in (False, True):
        c = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, remat=remat))
        model = copy.deepcopy(base)
        flash_kernel.reset_launches()
        q = vtamiq_forward(model, c, patches, pos, train=True,
                           generator=torch.Generator(device="cuda").manual_seed(5),
                           attention_fn=make_attention_fn(threshold=0))
        q.sum().backward()
        torch.cuda.synchronize()
        fwd.append(flash_kernel.launches["flash_fwd"])
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert fwd == [2, 4]  # layers - 1, then again in the recompute
    for n, g in grads[0].items():
        assert (g is None) == (grads[1][n] is None), n
        assert g is None or torch.equal(g, grads[1][n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8144, 768, 768), (8144, 768, 3072), (8144, 3072, 768),
                                   (8000, 768, 768), (18, 768, 3072), (5, 768, 768),
                                   (1, 3072, 768)])
def test_int_mm_matches_plain_product_on_card(m, k, n):
    """The int8 product of the W8A8 serving path (torch._int_mm, s8 x s8 ->
    s32) equal to the plain float64 product on the card, for the encoder's
    shapes at 500 patches, the last layer's rows at batch 1 and row counts
    under 17 (padded with zero rows); kernel_q8 column-major, as stored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm runs only on the card here")
    from vtamiq_tpu_torch.ops import quant
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).cuda()
    b = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8).cuda().t()
    before = quant.launches
    got = quant.int8_matmul(a, b)
    assert quant.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, quant.int8_matmul_plain(a, b))


@pytest.mark.gpu
def test_int8_scorer_on_card_matches_cpu_dense_calls():
    """A small int8 scorer on the card: the lazy rewrite, one gather and one
    int8 product per dense leaf a batch, and each dense_q8 output equal to
    the CPU's on the same input (1e-6 relative, no quant flip on the same
    input)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    import numpy as np
    from vtamiq_tpu_torch.inference import VTAMIQScorer
    from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
    from vtamiq_tpu_torch.ops import quant
    cfg = VTAMIQConfig(vit=get_vit_config(num_keep_layers=2, num_extra_tokens=8,
                                          hidden_size=64, mlp_dim=128, num_heads=4),
                       num_rgs=1, num_rcabs=1, ca_reduction=4)
    scorer = VTAMIQScorer(cfg=cfg, patch_count=64, seed=0, device="cuda",
                          compute_dtype=torch.float32, quantize_int8=True)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 1, (64, 96, 3)).astype(np.float32) for _ in range(4)]
    gather_kernel.launches, quant.launches = 0, 0
    q = scorer.score_batch(imgs[:2], imgs[2:])
    assert np.isfinite(q).all()
    assert quant.count_quantized_leaves(scorer.params) == 13
    assert (gather_kernel.launches, quant.launches) == (1, 13)
    gen = torch.Generator().manual_seed(1)
    holder = scorer.params.vit.encoder.layers.layer_0.mlp.fc1
    x = torch.randn(300, 64, generator=gen)
    y_card = quant.dense_q8(holder, x.cuda()).cpu()
    y_cpu = quant.dense_q8(copy.deepcopy(holder).cpu(), x)
    assert (y_card - y_cpu).abs().max() <= 1e-6 * y_cpu.abs().max()


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """Two ranks on cuda:0 over gloo (NCCL cannot put two ranks on one
    device), each running the ring in bf16 and in fp32 (TF32 off) and the
    single-device flash attention on the whole sequence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    from torch_mesh_worker import spawn_world
    cases = [{"kind": "ring_vs_flash", "name": dtype, "device": "cuda:0", "dtype": dtype,
              "seq": 2, "shape": [4, 1024, 4, 64], "valid": 1000, "seed": 3}
             for dtype in ("bfloat16", "float32")]
    return spawn_world(2, cases, {}, str(tmp_path_factory.mktemp("ring_gpu"))).results()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_tol,grad_tol", [("float32", 1e-5, 1e-4),
                                                    ("bfloat16", 2e-2, 2e-2)])
def test_ring_matches_single_device_flash_on_card(ring_world, dtype, out_tol, grad_tol):
    """The ring of two ranks sharing the card against flash attention over
    the whole sequence: each rank's output and dq, dk, dv chunks, relative
    to the largest magnitude, and one flash forward and fused backward
    launch a chunk a rank."""
    for _, values in ring_world:
        res = values[dtype]
        assert res["finite"]
        assert res["errors"]["out"] <= out_tol, res
        for key in ("dq", "dk", "dv"):
            assert res["errors"][key] <= grad_tol, res
        assert res["launches"]["flash_fwd"] == 2 and res["launches"]["flash_bwd_fused"] == 2
