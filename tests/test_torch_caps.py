"""The port's weighted CAPS against the JAX package's, on the CPU: Halton
exactly, the local means, SSIM and the four diff maps to 1e-5, the center
prior to 1e-6 relative, both allocators to equal counts, and weighted
positions from JAX's own draws to 1e-4 px with equal integer corners."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from vtamiq_tpu.ops import sampling as js
from vtamiq_tpu_torch.ops import sampling as ts

P = 16


def t(x):
    return torch.from_numpy(np.array(x))


def jax_weighted_draws(key, num_cells, num_samples):
    """The uniforms sample_positions_weighted draws from ``key``, split the
    same way it splits them."""
    key_alloc, key_shift, key_slot, key_jit = jax.random.split(key, 4)
    return ts.WeightedDraws(t(jax.random.uniform(key_alloc, (num_cells,))),
                            t(jax.random.uniform(key_shift, (2, 1))),
                            t(jax.random.uniform(key_slot, (num_samples,))),
                            t(jax.random.uniform(key_jit, (2, num_samples))))


def smooth_diff(rng, h, w):
    """A non-negative map with structure: a bump, a ramp and speckle."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    bump = np.exp(-((yy - 0.3) ** 2 + (xx - 0.6) ** 2) / 0.05)
    return (bump + 0.3 * xx + 0.2 * rng.uniform(0, 1, (h, w)) ** 4).astype(np.float32)


def test_halton_exact():
    k = np.concatenate([np.arange(4096), [2 ** 20 - 1, 2 ** 23 + 7, 3 ** 15 - 1]])
    got = ts.halton_2d(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.halton_2d(jnp.asarray(k))))


@pytest.mark.parametrize("win", [3, 7, 8])
def test_local_mean(win):
    x = np.random.default_rng(win).uniform(0, 1, (2, 23, 31, 3)).astype(np.float32)
    want = np.stack([np.asarray(js.local_mean(jnp.asarray(xi), win)) for xi in x])
    got = ts.local_mean(torch.from_numpy(x).movedim(-1, -3), win).movedim(-3, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ssim_map():
    rng = np.random.default_rng(1)
    ref = rng.uniform(0, 1, (40, 57, 3)).astype(np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    want = np.asarray(js.ssim_map(jnp.asarray(ref), jnp.asarray(dist)))
    got = ts.ssim_map(torch.from_numpy(ref), torch.from_numpy(dist)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    same = ts.ssim_map(torch.from_numpy(ref), torch.from_numpy(ref))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-5)


DIFF_TYPES = [ts.DIFF_TYPE_MAGNITUDE, ts.DIFF_TYPE_DARK, ts.DIFF_TYPE_MSE, ts.DIFF_TYPE_SSIM]
DIFF_CASES = [(d, p, k) for d in DIFF_TYPES for p in (1.0, 2.0) for k in (2, 3)]


def diff_map_pairs(cases):
    """{(diff_type, diff_pow, k_imgs): (JAX's diff map, the port's for the
    same item twice under a leading batch dim)}, as numpy arrays."""
    out = {}
    for diff_type, diff_pow, k_imgs in cases:
        rng = np.random.default_rng(10 * diff_type + k_imgs)
        ref = rng.uniform(0, 1, (1, 30, 41, 3)).astype(np.float32)
        imgs = np.concatenate([ref] + [np.clip(ref + rng.normal(0, 0.1 * i, ref.shape), 0, 1)
                                       for i in range(1, k_imgs)]).astype(np.float32)
        want = np.asarray(js.compute_diff_map(jnp.asarray(imgs), diff_type, diff_pow))
        got = ts.compute_diff_map(torch.from_numpy(np.stack([imgs, imgs])), diff_type, diff_pow)
        out[(diff_type, diff_pow, k_imgs)] = (want, got.numpy())
    return out


@pytest.fixture(scope="module")
def diff_maps():
    """Every case's diff maps from a fresh interpreter: in some tier-1 runs
    the worker computed a square root at 12 bits (tests/
    test_torch_process_state.py)."""
    from test_torch_process_state import run_fresh
    return run_fresh("test_torch_caps", "diff_map_pairs", DIFF_CASES)


@pytest.mark.parametrize("k_imgs", [2, 3])
@pytest.mark.parametrize("diff_pow", [1.0, 2.0])
@pytest.mark.parametrize("diff_type", DIFF_TYPES)
def test_diff_map(diff_maps, diff_type, diff_pow, k_imgs):
    want, got = diff_maps[(diff_type, diff_pow, k_imgs)]
    got = torch.from_numpy(got)
    assert got.shape == (2,) + want.shape
    np.testing.assert_allclose(got[1].numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got[0], got[1])


def test_diff_map_rejects_unknown_type():
    with pytest.raises(ValueError, match="Unsupported diff type"):
        ts.compute_diff_map(torch.zeros(2, 8, 8, 3), 7)


@pytest.mark.parametrize("h,w", [(384, 512), (64, 96), (37, 111)])
def test_centerbias_prob(h, w):
    template = js.gaussian_centerbias_logdensity()
    np.testing.assert_array_equal(ts.gaussian_centerbias_logdensity(), template)
    want = np.asarray(js.centerbias_prob(jnp.asarray(template, jnp.float32), h, w))
    got = ts.centerbias_prob(torch.from_numpy(template.astype(np.float32)), h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_centerbias_template_lookup(tmp_path, monkeypatch):
    """``path`` first, then $VTAMIQ_CENTERBIAS_PATH, then the port's own
    asset; None when none exists, and the sampler falls back to the
    Gaussian."""
    monkeypatch.delenv("VTAMIQ_CENTERBIAS_PATH", raising=False)
    monkeypatch.setattr(ts, "_CENTERBIAS_ASSET", str(tmp_path / "absent.npy"))
    assert ts.load_centerbias_template() is None
    s = ts.PatchSampler(centerbias_weight=1.0, grid_type=ts.GRID_TYPE_PERTURBED)
    np.testing.assert_array_equal(s.centerbias_template, ts.gaussian_centerbias_logdensity())
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    np.save(a, np.ones((4, 5)))
    np.save(b, np.zeros((6, 7)))
    monkeypatch.setenv("VTAMIQ_CENTERBIAS_PATH", str(b))
    assert ts.load_centerbias_template().shape == (6, 7)
    assert ts.load_centerbias_template(str(a)).shape == (4, 5)
    np.save(a, np.ones(3))
    with pytest.raises(ValueError, match="2-D"):
        ts.load_centerbias_template(str(a))


def _cell_probs(seed, n_cells, zeros=0):
    p = np.random.default_rng(seed).uniform(0, 1, n_cells) ** 3
    p[:zeros] = 0.0
    return (p / p.sum()).astype(np.float32)


@pytest.mark.parametrize("n_cells,n,zeros", [(130, 500, 0), (40, 24, 5), (7, 100, 2)])
def test_largest_remainder_alloc(n_cells, n, zeros):
    for seed in range(3):
        p = _cell_probs(seed, n_cells, zeros)
        want = np.asarray(js._largest_remainder_alloc(jnp.asarray(p), n))
        got = ts._largest_remainder_alloc(torch.from_numpy(p), n).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == n


@pytest.mark.parametrize("n_cells,n,zeros", [(130, 500, 0), (40, 24, 5), (7, 100, 2),
                                              (130, 128, 60)])
def test_dissolve_alloc(n_cells, n, zeros):
    for seed in range(4):
        p = _cell_probs(seed, n_cells, zeros)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(js._dissolve_alloc(key, jnp.asarray(p), n))
        u = t(jax.random.uniform(key, (n_cells,)))
        got = ts._dissolve_alloc(u, torch.from_numpy(p), n).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == n and (got[:zeros] == 0).all()


def test_cell_prob_sums():
    rng = np.random.default_rng(0)
    for h, w, n in ((384, 512, 500), (64, 96, 24), (40, 57, 30)):
        prob = rng.uniform(0, 1, (h, w)).astype(np.float32)
        layout = js._cell_layout(h, w, P, n)
        assert ts._cell_layout(h, w, P, n) == layout
        want = np.asarray(js._cell_prob_sums(jnp.asarray(prob), layout[0], layout[1],
                                             layout[2], P))
        got = ts._cell_prob_sums(torch.from_numpy(prob)[None], layout[0], layout[1],
                                 layout[2], P)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


WEIGHTED_CASES = [(384, 512, 500, None), (64, 96, 24, None), (64, 96, 24, (50, 70)),
                  (80, 80, 40, (80, 33)), (40, 57, 30, None)]


@pytest.mark.parametrize("grid_type", [ts.GRID_TYPE_HALTON, ts.GRID_TYPE_PERTURBED])
@pytest.mark.parametrize("h,w,n,img_hw", WEIGHTED_CASES)
def test_positions_from_jax_draws(h, w, n, img_hw, grid_type):
    """sample_positions_weighted against the port's formula on the same
    probability map (JAX's) and JAX's own draws, 3 keys batched in one
    call: corners to 1e-4 px, their integer parts equal."""
    rng = np.random.default_rng(h + n)
    jsampler = js.PatchSampler(diff_weight=1.0, uniform_weight=0.1, grid_type=grid_type)
    jhw = None if img_hw is None else jnp.asarray(img_hw, jnp.int32)
    prob = jsampler.sample_prob(h, w, jnp.asarray(smooth_diff(rng, h, w)), img_hw=jhw)
    keys = [jax.random.PRNGKey(seed) for seed in range(3)]
    sample = jax.jit(lambda key: js.sample_positions_weighted(key, prob, h, w, P, n, grid_type,
                                                              img_hw=jhw))
    want = np.stack([np.asarray(sample(key)) for key in keys])
    _, sh, sw = ts._cell_layout(h, w, P, n)
    draws = ts.WeightedDraws.stack([jax_weighted_draws(key, sh * sw, n) for key in keys])
    thw = None if img_hw is None else torch.tensor([img_hw] * 3)
    got = ts.weighted_positions(t(prob).expand(3, h, w), draws, h, w, P, n, grid_type,
                                img_hw=thw).numpy()
    assert got.shape == (3, 2, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.floor(got), np.floor(want))
    span = (h - P, w - P) if img_hw is None else (img_hw[0] - P, img_hw[1] - P)
    assert got.min() >= 0 and (got[:, 0] <= span[0]).all() and (got[:, 1] <= span[1]).all()


@pytest.mark.parametrize("img_hw", [None, (50, 70)])
@pytest.mark.parametrize("centerbias", [0.0, 0.5])
def test_sample_prob(centerbias, img_hw):
    """The centerbias + diff + uniform mix, with the masked std over the
    true region in bucket mode: within 1e-6 (relative to the map's maximum)
    of the same formula in float64, and within 1e-5 relative of JAX's. The
    maps' normalizing fp32 sums run over 6144 pixels in another order in
    each package: XLA's here carry 1.2e-6 of error against float64."""
    h, w = 64, 96
    diff = smooth_diff(np.random.default_rng(3), h, w)
    if img_hw is not None:
        diff[img_hw[0]:] = 0.0
        diff[:, img_hw[1]:] = 0.0
    kw = dict(centerbias_weight=centerbias, diff_weight=1.0, uniform_weight=0.1,
              grid_type=ts.GRID_TYPE_PERTURBED)
    want = np.asarray(js.PatchSampler(**kw).sample_prob(
        h, w, jnp.asarray(diff), img_hw=None if img_hw is None else jnp.asarray(img_hw)))
    got = ts.PatchSampler(**kw).sample_prob(
        h, w, torch.from_numpy(diff)[None],
        img_hw=None if img_hw is None else torch.tensor([img_hw]))
    assert got.shape == (1, h, w)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=0)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-6)

    d = diff.astype(np.float64)
    valid = np.zeros((h, w))
    valid[:img_hw[0] if img_hw else h, :img_hw[1] if img_hw else w] = 1.0
    mean = (d * valid).sum() / valid.sum()
    exact = 0.1 + d / np.sqrt((((d - mean) ** 2) * valid).sum() / valid.sum())
    if centerbias:
        cb = np.asarray(js.centerbias_prob(jnp.asarray(js.gaussian_centerbias_logdensity(),
                                                       jnp.float32), h, w), np.float64)
        exact = exact + centerbias * cb / cb.max()
    exact /= exact.sum()
    assert np.abs(got[0].numpy() - exact).max() <= 1e-6 * exact.max()


def test_sample_prob_needs_the_diff():
    s = ts.PatchSampler(diff_weight=1.0, grid_type=ts.GRID_TYPE_PERTURBED)
    with pytest.raises(ValueError, match="'diff' is required"):
        s.sample_prob(32, 32, None)


def test_sampler_draws_are_seeded_in_range_and_batched():
    """sample_batch: the same seed gives the same corners; items draw in
    turn, so item b of a batch equals the b-th single-item call."""
    h, w, n = 64, 96, 24
    rng = np.random.default_rng(4)
    diff = torch.from_numpy(np.stack([smooth_diff(rng, h, w) for _ in range(3)]))
    s = ts.PatchSampler(diff_weight=1.0, uniform_weight=0.1, grid_type=ts.GRID_TYPE_PERTURBED)
    a = s.sample_batch(torch.Generator().manual_seed(3), h, w, P, n, 3, 2, diff=diff)
    b = s.sample_batch(torch.Generator().manual_seed(3), h, w, P, n, 3, 2, diff=diff)
    assert a.shape == (3, 2, 2, n) and torch.equal(a, b)
    assert not torch.equal(a[:, 0], a[:, 1])
    gen = torch.Generator().manual_seed(3)
    singles = [[s.sample(gen, h, w, P, n, diff=diff[i]) for _ in range(2)] for i in range(3)]
    assert torch.equal(a, torch.stack([torch.stack(x) for x in singles]))
    assert float(a.min()) >= 0 and float(a[..., 0, :].max()) <= h - P
    assert float(a[..., 1, :].max()) <= w - P


def test_draws_move_in_one_copy():
    d = ts.WeightedDraws.stack([ts.weighted_draws(torch.Generator().manual_seed(i), 7, 5)
                                for i in range(3)])
    assert [tuple(x.shape) for x in d] == [(3, 7), (3, 2, 1), (3, 5), (3, 2, 5)]
    moved = d.to("cpu")
    assert all(torch.equal(x, y) for x, y in zip(d, moved))


def _ks(grid_type, seed):
    """7680 draws per side of a 128-patch weighted sampler at 192x256:
    JAX's from its key splits, the port's from its generator, batched."""
    h, w, n, reps = 192, 256, 128, 60
    diff = smooth_diff(np.random.default_rng(seed), h, w)
    kw = dict(diff_weight=1.0, uniform_weight=0.1, grid_type=grid_type)
    jsampler = js.PatchSampler(**kw)
    sample = jax.jit(lambda key: jsampler.sample(key, h, w, P, n, jnp.asarray(diff)))
    key = jax.random.PRNGKey(seed)
    ours = []
    for _ in range(reps):
        key, sub = jax.random.split(key)
        ours.append(np.asarray(sample(sub)))
    ours = np.concatenate(ours, axis=1)
    port = ts.PatchSampler(**kw).sample_batch(
        torch.Generator().manual_seed(seed), h, w, P, n, reps,
        diff=torch.from_numpy(diff).expand(reps, h, w))
    port = port[:, 0].permute(1, 0, 2).reshape(2, -1).numpy()
    return [scipy.stats.ks_2samp(ours[a], port[a]).statistic for a in (0, 1)]


@pytest.mark.parametrize("grid_type", [ts.GRID_TYPE_PERTURBED, ts.GRID_TYPE_HALTON])
def test_ks_per_axis_against_jax(grid_type):
    """The port's generator draws the same distribution of corners as JAX's
    keys: per-axis two-sample KS statistic < 0.02 at 7680 draws a side."""
    stats = _ks(grid_type, seed=11)
    assert max(stats) < 0.02, stats
