"""The port's color spaces (``vtamiq_tpu_torch/utils/color_spaces.py``) and
the ``use_pu`` input mode against the JAX package's on the CPU.

The numpy functions are copies: equal bit for bit. The torch PU functions
compute in fp32 op for op as XLA compiles the JAX ones on the CPU; only
the fp32 power differs, in the last bit of about 1 value in 2,000, which
PU21's scale of 596.3 makes up to 5.6e-7 on the encoded [0, 1] scale. The
PU extraction (the encoded image kept in fp32, each patch
rounded once to bf16 as the gather stores it) is held to JAX's (the whole
encoded image rounded to bf16, then gathered) bit for bit in bf16."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.ops import sampling as js
from vtamiq_tpu.train import steps as jsteps
from vtamiq_tpu.utils import color_spaces as J
from vtamiq_tpu_torch.ops import sampling as ts
from vtamiq_tpu_torch.train import steps as tsteps
from vtamiq_tpu_torch.utils import color_spaces as T
from test_torch_extraction import feed_draws, jax_draws, jax_weighted_draw_queue

P = 16
# one ulp of the power (at most 2^-23, for powers in [1, 2)) times p6, plus
# the roundings after it: 2 x 596.3 x 2^-23 on the PU scale
PU21_ATOL = 2 * 596.3 * 2.0 ** -23
PU_ATOL = PU21_ATOL / 256.0          # over PU21 of the 100 cd/m^2 peak


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _srgb(seed, shape=(40000,)):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    x.reshape(-1)[:6] = [0.0, 0.04045, 0.0404, 0.0405, 1.0, 0.5]
    return x


@pytest.mark.parametrize("name", ["srgb_to_linear", "linear_to_srgb", "rgb_to_luminance",
                                  "rgb_to_xyz", "xyz_to_rgb", "xyz_to_lab", "lab_to_xyz",
                                  "rgb_to_lab", "pu21_encode", "pu21_decode",
                                  "display_model_sdr", "pu_encode_srgb"])
def test_numpy_functions_equal_jax_packages(name):
    x = _srgb(1, (16, 24, 3))
    if name in ("pu21_encode", "pu21_decode"):
        x = x * 200.0
    if name == "lab_to_xyz":
        x = J.rgb_to_lab(x)
    np.testing.assert_array_equal(getattr(T, name)(x), getattr(J, name)(x))


def test_torch_pu_functions_match_jax():
    """sRGB -> linear to 1 ulp. PU21 subtracts 0.90995 from a power and
    scales by 596.3: one ulp of the power becomes up to 1.4e-4 on the PU
    scale, 5.6e-7 over the peak's 256.4."""
    x = _srgb(2)
    lin = T.srgb_to_linear_torch(torch.from_numpy(x)).numpy()
    assert lin.dtype == np.float32
    assert _ulps(lin, jax.jit(J.srgb_to_linear_jnp)(x)).max() <= 1
    lum = np.concatenate([np.geomspace(1e-3, 2e4, 20000), [0.0, 0.005, 1e4, 5e4]]
                         ).astype(np.float32)
    pu = T.pu21_encode_torch(torch.from_numpy(lum)).numpy()
    want = np.asarray(jax.jit(J.pu21_encode_jnp)(lum))
    np.testing.assert_allclose(pu, want, rtol=0, atol=PU21_ATOL)
    assert np.mean(pu != want) < 0.01
    # and the host (float64) encoding to fp32 precision
    np.testing.assert_allclose(pu, J.pu21_encode(lum), rtol=0, atol=2 * PU21_ATOL)

    def jax_display(raw):
        lin = J.srgb_to_linear_jnp(raw)
        return J.pu21_encode_jnp((100.0 - 0.5) * lin + 0.5) / J.pu21_encode_jnp(
            jnp.asarray(100.0))

    img = _srgb(3, (2, 32, 48, 3))
    got = T.pu_display_encode_torch(torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(jax_display)(img))
    np.testing.assert_allclose(got, want, rtol=0, atol=PU_ATOL)
    assert np.mean(got != want) < 0.01
    np.testing.assert_allclose(got, J.pu_encode_srgb(img), rtol=0, atol=2 * PU_ATOL)


def _pu_ecfg(mod, dtype, num_scales=1):
    return mod.ExtractConfig(patch_count=40, patch_dim=P, patch_num_scales=num_scales,
                             norm_mean=None, norm_std=None, gather_dtype=dtype,
                             pu_display_encode=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pu_extraction_matches_jax(monkeypatch, dtype):
    """Config 3's weighted sampler (MAGNITUDE diff map from the raw pixels)
    with PU inputs: JAX's make_extract_fn against the port's with JAX's
    draws fed in; the patches equal bit for bit."""
    rng = np.random.default_rng(4)
    bsz, k, h, w = 2, 2, 64, 96
    ref = rng.uniform(0, 1, (bsz, 1, h, w, 3))
    raw = np.clip(np.concatenate([ref, ref + rng.normal(0, 0.1, ref.shape)], axis=1),
                  0, 1).astype(np.float32)
    kw = dict(diff_weight=1.0, uniform_weight=0.1, grid_type=js.GRID_TYPE_PERTURBED,
              diff_type=js.DIFF_TYPE_MAGNITUDE)
    key = jax.random.PRNGKey(7)
    jp, jpos, _ = jax.jit(jsteps.make_extract_fn(js.PatchSampler(**kw), _pu_ecfg(jsteps, dtype))
                          )(jnp.asarray(raw), key)
    queue, _ = jax_weighted_draw_queue(list(jax.random.split(key, bsz)), k, h, w, 40, 1, True)
    rest = feed_draws(monkeypatch, queue)
    extract = tsteps.make_extract_fn(ts.PatchSampler(**kw), _pu_ecfg(tsteps, dtype))
    patches, pos, scales = extract(torch.from_numpy(raw), torch.Generator())
    assert next(rest, None) is None and scales is None
    assert patches.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(patches.float().numpy(), np.asarray(jp, np.float32))
    else:
        np.testing.assert_allclose(patches.numpy(), np.asarray(jp), rtol=0, atol=PU_ATOL)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-5)
    assert float(patches.float().min()) >= 0.0 and float(patches.float().max()) <= 1.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pu_extraction_three_scales_matches_jax(monkeypatch, dtype):
    """Uniform CAPS over three scales: the pyramid pools the encoded image,
    in both packages; in bf16 the image is rounded first and pooled in
    bf16, so the patches are equal bit for bit."""
    rng = np.random.default_rng(5)
    raw = rng.uniform(0, 1, (1, 2, 128, 160, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jp, _, jsc = jax.jit(jsteps.make_extract_fn(js.PatchSampler(), _pu_ecfg(
        jsteps, dtype, 3)))(jnp.asarray(raw), key)
    corners, _ = jax_draws(jax.random.split(key, 1)[0], 2, 128, 160, 40, 3)
    queue = iter([torch.from_numpy(c[None]) for c in corners])
    monkeypatch.setattr(ts.PatchSampler, "sample_batch", lambda self, *a, **k: next(queue))
    extract = tsteps.make_extract_fn(ts.PatchSampler(), _pu_ecfg(tsteps, dtype, 3))
    patches, _, scales = extract(torch.from_numpy(raw), torch.Generator())
    assert next(queue, None) is None and patches.dtype == getattr(torch, dtype)
    assert len(np.unique(np.asarray(jsc))) == 3
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jsc))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(patches.float().numpy(), np.asarray(jp, np.float32))
    else:
        np.testing.assert_allclose(patches.numpy(), np.asarray(jp), rtol=0, atol=PU_ATOL)
