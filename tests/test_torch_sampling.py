"""The port's patch sampling against the JAX package's: budget math
exactly, uniform positions from JAX's own draws to 1e-6, and the weighted
samplers' constructor (weighted CAPS itself: tests/test_torch_caps.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.ops import sampling as js
from vtamiq_tpu_torch.ops import sampling as ts


@pytest.mark.parametrize("scales,h,w,p", [(1, 384, 512, 16), (3, 384, 512, 16),
                                          (5, 64, 96, 16), (8, 512, 384, 8), (3, 40, 57, 16)])
def test_patch_num_scales(scales, h, w, p):
    assert ts.compute_patch_num_scales(scales, h, w, p) == js.compute_patch_num_scales(scales, h, w, p)


@pytest.mark.parametrize("count,scales,ratio", [(500, 1, 1.7), (500, 3, 1.7), (24, 3, 1.7),
                                                (1000, 4, 1.2), (7, 5, 2.0)])
def test_budget_math(count, scales, ratio):
    np.testing.assert_array_equal(ts.compute_num_patches_per_scale(count, scales, ratio),
                                  js.compute_num_patches_per_scale(count, scales, ratio))
    assert ts.compute_num_pixels(count, scales, ratio) == js.compute_num_pixels(count, scales, ratio)


@pytest.mark.parametrize("h,w,n", [(384, 512, 500), (64, 96, 24), (512, 384, 500),
                                   (40, 1000, 30), (100, 100, 1)])
def test_grid_dims(h, w, n):
    assert ts._perturbed_simple_grid_dims(h, w, n) == js._perturbed_simple_grid_dims(h, w, n)


def _jax_draws(key, h, w, n):
    """The draws sample_positions_uniform takes from ``key``, split the same
    way it splits them."""
    height, width = js._perturbed_simple_grid_dims(h, w, n)
    key_sel, key_jit = jax.random.split(key)
    perm = jax.random.permutation(key_sel, height * width)[:n]
    u = jax.random.uniform(key_jit, (2, n))
    return torch.from_numpy(np.array(perm)), torch.from_numpy(np.array(u))


@pytest.mark.parametrize("h,w,n,img_hw", [(64, 96, 24, None), (384, 512, 500, None),
                                          (64, 96, 24, (50, 70)), (80, 80, 40, (80, 33))])
def test_positions_from_jax_draws(h, w, n, img_hw):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = js.sample_positions_uniform(
            key, h, w, 16, n, img_hw=None if img_hw is None else jnp.asarray(img_hw, jnp.int32))
        perm, u = _jax_draws(key, h, w, n)
        got = ts.uniform_positions(
            perm, u, h, w, 16, img_hw=None if img_hw is None else torch.tensor(img_hw))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_generator_draws_are_seeded_and_in_range():
    a = ts.sample_positions_uniform(torch.Generator().manual_seed(3), 64, 96, 16, 24)
    b = ts.sample_positions_uniform(torch.Generator().manual_seed(3), 64, 96, 16, 24)
    assert torch.equal(a, b)
    assert a.shape == (2, 24)
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 64 - 16
    assert float(a[1].min()) >= 0 and float(a[1].max()) <= 96 - 16
    # distinct grid cells
    perm, _ = ts.uniform_draws(torch.Generator().manual_seed(3), 54, 24)
    assert len(set(perm.tolist())) == 24


def test_perturbed_simple_forces_uniform(capsys):
    s = ts.PatchSampler(diff_weight=1.0, centerbias_weight=0.5)
    assert s.is_uniform and s.diff_weight == 0 and s.centerbias_weight == 0
    assert "forces uniform" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [dict(diff_weight=1.0), dict(centerbias_weight=1.0)])
def test_weighted_caps_samples(kw):
    """A diff-only and a centerbias-only PERTURBED sampler build and sample
    weighted CAPS: from JAX's draws the corners equal JAX's (1e-4 px, equal
    integer parts); from the port's generator they lie in range."""
    h, w, n = 64, 96, 24
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = np.stack([ref, np.clip(ref + rng.normal(0, 0.2, ref.shape), 0, 1)]).astype(np.float32)
    jsampler = js.PatchSampler(grid_type=js.GRID_TYPE_PERTURBED, **kw)
    tsampler = ts.PatchSampler(grid_type=ts.GRID_TYPE_PERTURBED, **kw)
    assert not tsampler.is_uniform and tsampler.uses_diff == ("diff_weight" in kw)
    jdiff = jsampler.compute_diff(jnp.asarray(imgs))
    tdiff = tsampler.compute_diff(torch.from_numpy(imgs)[None])

    key = jax.random.PRNGKey(7)
    want = np.asarray(jsampler.sample(key, h, w, 16, n, jdiff))
    _, sh, sw = ts._cell_layout(h, w, 16, n)
    key_alloc, key_shift, key_slot, key_jit = jax.random.split(key, 4)
    draws = ts.WeightedDraws(*(torch.from_numpy(np.array(x))[None] for x in (
        jax.random.uniform(key_alloc, (sh * sw,)), jax.random.uniform(key_shift, (2, 1)),
        jax.random.uniform(key_slot, (n,)), jax.random.uniform(key_jit, (2, n)))))
    prob = tsampler.sample_prob(h, w, tdiff).expand(1, h, w)
    got = ts.weighted_positions(prob, draws, h, w, 16, n, ts.GRID_TYPE_PERTURBED)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.floor(got), np.floor(want))

    pos = tsampler.sample(torch.Generator().manual_seed(1), h, w, 16, n,
                          diff=None if tdiff is None else tdiff[0])
    assert pos.shape == (2, n) and pos.dtype == torch.float32
    assert float(pos.min()) >= 0
    assert float(pos[0].max()) <= h - 16 and float(pos[1].max()) <= w - 16


def test_zero_weight_raises():
    with pytest.raises(ValueError):
        ts.PatchSampler(uniform_weight=0.0)
