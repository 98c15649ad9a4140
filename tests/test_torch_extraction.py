"""The port's patch extraction against the JAX package's get_iqa_patches:
uniform sampling with JAX's own sampled corners injected, exact in fp32;
weighted CAPS with JAX's own draws fed to the port's sampler."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.ops import sampling as js
from vtamiq_tpu.ops.extraction import avgpool2x as jax_avgpool2x
from vtamiq_tpu.ops.extraction import get_iqa_patches as jax_get_iqa_patches
from vtamiq_tpu_torch.ops import sampling as ts
from vtamiq_tpu_torch.ops.extraction import avgpool2x, get_iqa_patches
from vtamiq_tpu_torch.ops.sampling import PatchSampler
from test_torch_caps import jax_weighted_draws

P = 16
NORM = ((0.5, 0.4, 0.3), (0.5, 0.25, 0.2))


def jax_draws(key, k_imgs, h, w, patch_count, num_scales, img_hw=None, randomize=False):
    """The corners (per sampled scale, (K, 2, N_s)) and the scale-order
    permutation that the JAX package's get_iqa_patches draws from ``key``,
    following its key splits."""
    num_scales = js.compute_patch_num_scales(num_scales, h, w, P)
    budget = js.compute_num_patches_per_scale(patch_count, num_scales)
    key_order = None
    if randomize:
        key, key_order = jax.random.split(key)
    sampler = js.PatchSampler()
    cur_hw = None if img_hw is None else jnp.asarray(img_hw, jnp.int32)
    corners, total = [], 0
    for scale in range(num_scales):
        n_s = int(budget[-scale - 1])
        key, *subkeys = jax.random.split(key, 1 + k_imgs)
        if n_s > 0:
            c = sampler.sample(subkeys[0], h, w, P, n_s, None, img_hw=cur_hw)
            corners.append(np.stack([np.asarray(c)] * k_imgs))
            total += n_s
        if patch_count <= total or scale == num_scales - 1:
            break
        h, w = h // 2, w // 2
        if cur_hw is not None:
            cur_hw = cur_hw // 2
    perm = None if key_order is None else np.asarray(jax.random.permutation(key_order, total))
    return corners, perm


@pytest.mark.parametrize("shape", [(64, 96), (41, 57), (7, 9), (2, 3)])
def test_avgpool2x_exact(shape):
    x = np.random.default_rng(0).uniform(0, 1, (2, 2) + shape + (3,)).astype(np.float32)
    got = avgpool2x(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_avgpool2x(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_scales,randomize,img_hw,norm", [
    (1, False, None, False),
    (1, False, None, True),
    (3, False, None, True),
    (3, True, None, False),
    (1, False, (50, 70), True),
    (3, True, (56, 81), True),
], ids=["1scale", "1scale_norm", "3scale_norm", "3scale_shuffled", "1scale_hw",
        "3scale_hw_shuffled"])
def test_get_iqa_patches_matches_jax(num_scales, randomize, img_hw, norm):
    rng = np.random.default_rng(num_scales)
    bsz, k, h, w, count = 2, 2, 64, 96, 24
    imgs = rng.uniform(0, 1, (bsz, k, h, w, 3)).astype(np.float32)
    hw = None if img_hw is None else np.asarray([img_hw, (h - 3, w - 10)], np.int32)
    tile_norm = (NORM[0], NORM[1], jnp.float32) if norm else None

    corners = [[] for _ in range(bsz)]
    perms, want = [], []
    for b in range(bsz):
        key = jax.random.PRNGKey(10 + b)
        img_hw_b = None if hw is None else hw[b]
        c, perm = jax_draws(key, k, h, w, count, num_scales, img_hw_b, randomize)
        corners[b], perm = c, perm
        perms.append(perm)
        want.append(jax_get_iqa_patches(
            jnp.asarray(imgs[b]), jnp.asarray(imgs[b]), key, count, P, js.PatchSampler(),
            num_scales, randomize_patch_scale_order=randomize,
            img_hw=None if img_hw_b is None else jnp.asarray(img_hw_b), tile_norm=tile_norm))

    topleft = [torch.from_numpy(np.stack([corners[b][s] for b in range(bsz)]))
               for s in range(len(corners[0]))]
    patches, pos, scales = get_iqa_patches(
        torch.from_numpy(imgs), torch.Generator(), count, P, PatchSampler(), num_scales,
        randomize_patch_scale_order=randomize,
        img_hw=None if hw is None else torch.from_numpy(hw),
        tile_norm=None if tile_norm is None else (NORM[0], NORM[1], torch.float32),
        topleft=topleft,
        scale_order=torch.from_numpy(np.stack(perms)) if randomize else None)

    assert patches.shape == (bsz, k, count, P, P, 3)
    for b in range(bsz):
        jp, jpos, jsc = want[b]
        np.testing.assert_array_equal(patches[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(jpos))
        if jsc is None:
            assert scales is None
        else:
            np.testing.assert_array_equal(scales[b].numpy(), np.asarray(jsc))


def test_true_region_confines_patches():
    """With img_hw, no patch reaches the padding (filled with a sentinel)."""
    imgs = torch.full((1, 2, 64, 96, 3), 7.0)
    imgs[:, :, :40, :50] = 0.5
    patches, pos, _ = get_iqa_patches(imgs, torch.Generator().manual_seed(0), 24, P,
                                      PatchSampler(), 3, img_hw=torch.tensor([[40, 50]]))
    assert float(patches.max()) == 0.5
    assert float(pos.max()) < 1.0 and float(pos.min()) >= 0.0


def test_drawn_layout_is_seeded_and_aligned():
    imgs = torch.rand(2, 2, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    a = get_iqa_patches(imgs, torch.Generator().manual_seed(5), 24, P, PatchSampler(), 3,
                        randomize_patch_scale_order=True)
    b = get_iqa_patches(imgs, torch.Generator().manual_seed(5), 24, P, PatchSampler(), 3,
                        randomize_patch_scale_order=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pos = a[1]
    assert torch.equal(pos[:, 0], pos[:, 1])        # ref and dist share corners
    assert not torch.equal(pos[0], pos[1])          # items draw their own


def jax_weighted_draw_queue(item_keys, k_imgs, h, w, patch_count, num_scales, aligned,
                            randomize=False):
    """The weighted draws JAX's get_iqa_patches takes from each item's key,
    following its key splits, in the order the port's sampler asks for them
    (per sampled scale, per item, per image when not aligned); and each
    item's scale-order permutation."""
    num_scales = js.compute_patch_num_scales(num_scales, h, w, P)
    budget = js.compute_num_patches_per_scale(patch_count, num_scales)
    per_item, perms = [], []
    for key in item_keys:
        key_order = None
        if randomize:
            key, key_order = jax.random.split(key)
        hs, ws, draws, total = h, w, [], 0
        for scale in range(num_scales):
            n_s = int(budget[-scale - 1])
            key, *subkeys = jax.random.split(key, 1 + k_imgs)
            if n_s > 0:
                _, sh, sw = ts._cell_layout(hs, ws, P, n_s)
                draws.append([jax_weighted_draws(subkeys[d], sh * sw, n_s)
                              for d in range(1 if aligned else k_imgs)])
                total += n_s
            if patch_count <= total or scale == num_scales - 1:
                break
            hs, ws = hs // 2, ws // 2
        per_item.append(draws)
        perms.append(None if key_order is None
                     else np.asarray(jax.random.permutation(key_order, total)))
    queue = [d for s in range(len(per_item[0])) for item in per_item for d in item[s]]
    return queue, perms


def feed_draws(monkeypatch, queue):
    """The port's sampler takes its weighted draws from ``queue`` in turn."""
    it = iter(queue)
    monkeypatch.setattr(ts, "weighted_draws", lambda gen, num_cells, num_samples: next(it))
    return it


@pytest.mark.parametrize("num_scales,aligned,randomize,img_hw,diff_type,grid_type", [
    (1, True, False, None, js.DIFF_TYPE_SSIM, js.GRID_TYPE_PERTURBED),
    (1, False, False, None, js.DIFF_TYPE_MAGNITUDE, js.GRID_TYPE_HALTON),
    (3, True, True, None, js.DIFF_TYPE_MAGNITUDE, js.GRID_TYPE_PERTURBED),
    (3, False, False, None, js.DIFF_TYPE_SSIM, js.GRID_TYPE_PERTURBED),
    (3, True, False, (56, 81), js.DIFF_TYPE_MSE, js.GRID_TYPE_PERTURBED),
], ids=["1scale_ssim", "1scale_unaligned_halton", "3scale_shuffled", "3scale_unaligned_ssim",
        "3scale_hw_mse"])
def test_weighted_get_iqa_patches_matches_jax(monkeypatch, num_scales, aligned, randomize,
                                              img_hw, diff_type, grid_type):
    """Weighted CAPS through the port's extraction (each item's diff map
    from the raw images, halved down the pyramid, every scale sampled for
    the whole batch at once) against JAX's get_iqa_patches with the same
    draws: equal patches, uv positions to 1e-5."""
    rng = np.random.default_rng(20 + num_scales)
    bsz, k, h, w, count = 2, 3, 64, 96, 24
    ref = rng.uniform(0, 1, (bsz, 1, h, w, 3))
    imgs = np.clip(np.concatenate([ref, ref + rng.normal(0, 0.15, ref.shape),
                                   ref + rng.normal(0, 0.3, ref.shape)], axis=1),
                   0, 1).astype(np.float32)
    hw = None if img_hw is None else np.asarray([img_hw, (h - 3, w - 10)], np.int32)
    kw = dict(diff_weight=1.0, uniform_weight=0.1, grid_type=grid_type, diff_type=diff_type)
    keys = [jax.random.PRNGKey(30 + b) for b in range(bsz)]
    want = [jax_get_iqa_patches(
        jnp.asarray(imgs[b]), jnp.asarray(imgs[b]), keys[b], count, P, js.PatchSampler(**kw),
        num_scales, use_aligned_patches=aligned, randomize_patch_scale_order=randomize,
        img_hw=None if hw is None else jnp.asarray(hw[b]),
        tile_norm=(NORM[0], NORM[1], jnp.float32)) for b in range(bsz)]

    queue, perms = jax_weighted_draw_queue(keys, k, h, w, count, num_scales, aligned, randomize)
    rest = feed_draws(monkeypatch, queue)
    patches, pos, scales = get_iqa_patches(
        torch.from_numpy(imgs), torch.Generator(), count, P, PatchSampler(**kw), num_scales,
        use_aligned_patches=aligned, randomize_patch_scale_order=randomize,
        img_hw=None if hw is None else torch.from_numpy(hw),
        tile_norm=(NORM[0], NORM[1], torch.float32),
        scale_order=torch.from_numpy(np.stack(perms)) if randomize else None)
    assert next(rest, None) is None  # every draw taken

    assert patches.shape == (bsz, k, count, P, P, 3)
    for b in range(bsz):
        jp, jpos, jsc = want[b]
        np.testing.assert_array_equal(patches[b].numpy(), np.asarray(jp))
        np.testing.assert_allclose(pos[b].numpy(), np.asarray(jpos), rtol=0, atol=1e-5)
        if jsc is None:
            assert scales is None
        else:
            np.testing.assert_array_equal(scales[b].numpy(), np.asarray(jsc))
    if aligned:
        assert torch.equal(pos[:, 0], pos[:, 1])
    else:
        assert not torch.equal(pos[:, 0], pos[:, 1])


def test_weighted_sampling_needs_raw_images():
    s = PatchSampler(diff_weight=1.0, grid_type=ts.GRID_TYPE_PERTURBED)
    with pytest.raises(ValueError, match="raw"):
        get_iqa_patches(torch.rand(1, 2, 64, 96, 3), torch.Generator(), 24, P, s)
