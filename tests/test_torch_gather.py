"""The port's patch gather against the JAX package's (XLA path on the CPU).
The CUDA kernel against its plain version: tests/test_torch_kernels_gpu.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.ops.extraction import gather_patches as jax_gather_patches
from vtamiq_tpu_torch.ops import gather_kernel
from vtamiq_tpu_torch.ops.extraction import gather_patches

P = 16
MEAN, STD = (0.5, 0.4, 0.3), (0.5, 0.25, 0.2)


def _bits(x) -> np.ndarray:
    """Exact comparison view: bf16 and fp32 both as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed, h=64, w=96, n=24, c=3, p=P):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    # float corners, with some past every edge so the clip is exercised
    topleft = np.stack([rng.uniform(-8, h - p + 8, n),
                        rng.uniform(-8, w - p + 8, n)]).astype(np.float32)
    topleft[:, 0] = [0.0, 0.0]
    topleft[:, 1] = [h - p, w - p]
    topleft[:, 2] = [h - p + 0.999, w - p + 5.5]
    return img, topleft


@pytest.mark.parametrize("tile_norm", [
    None,
    (MEAN, STD, jnp.float32),
    (MEAN, STD, jnp.bfloat16),
    (None, None, jnp.bfloat16),
], ids=["plain", "norm_fp32", "norm_bf16", "cast_bf16"])
@pytest.mark.parametrize("shape", [(64, 96), (40, 57)], ids=["64x96", "odd_40x57"])
def test_gather_matches_jax(tile_norm, shape):
    img, topleft = _inputs(1, *shape)
    want = jax_gather_patches(jnp.asarray(img), jnp.asarray(topleft), P, tile_norm=tile_norm)
    t_norm = None
    if tile_norm is not None:
        t_norm = (tile_norm[0], tile_norm[1],
                  torch.bfloat16 if tile_norm[2] == jnp.bfloat16 else torch.float32)
    got = gather_patches(torch.from_numpy(img)[None], torch.from_numpy(topleft)[None], P,
                         tile_norm=t_norm)[0]
    assert got.shape == want.shape
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("norm", ["plain", "norm_bf16"])
@pytest.mark.parametrize("c,p", [(1, 16), (4, 16), (3, 8), (1, 8), (4, 8)],
                         ids=["c1_p16", "c4_p16", "c3_p8", "c1_p8", "c4_p8"])
def test_gather_matches_jax_over_channels_and_patch_sizes(c, p, norm):
    """Channel counts of 1 and 4 and 8x8 patches (the kernel's generic
    instance on the card): the port bit for bit against the JAX package, in
    fp32 without normalization and in bf16 with it."""
    img, topleft = _inputs(3, 40, 57, c=c, p=p)
    mean = tuple(0.1 * (i + 1) for i in range(c))
    std = tuple(0.2 + 0.05 * i for i in range(c))
    jax_norm = None if norm == "plain" else (mean, std, jnp.bfloat16)
    want = jax_gather_patches(jnp.asarray(img), jnp.asarray(topleft), p, tile_norm=jax_norm)
    got = gather_patches(torch.from_numpy(img)[None], torch.from_numpy(topleft)[None], p,
                         tile_norm=None if norm == "plain" else (mean, std, torch.bfloat16))[0]
    assert got.shape == want.shape == (24, p, p, c)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_batched_gather_is_per_image():
    imgs, tls = zip(*(_inputs(s) for s in range(3)))
    got = gather_patches(torch.from_numpy(np.stack(imgs)), torch.from_numpy(np.stack(tls)), P,
                         tile_norm=(MEAN, STD, torch.float32))
    for i in range(3):
        want = jax_gather_patches(jnp.asarray(imgs[i]), jnp.asarray(tls[i]), P,
                                  tile_norm=(MEAN, STD, jnp.float32))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    img, topleft = _inputs(2)
    x = torch.from_numpy(img)[None]
    ti = torch.from_numpy(np.floor(np.clip(topleft[0], 0, 64 - P)).astype(np.int32))[None]
    tj = torch.from_numpy(np.floor(np.clip(topleft[1], 0, 96 - P)).astype(np.int32))[None]
    before = gather_kernel.launches
    got = gather_kernel.gather_patches(x, ti, tj, P, MEAN, [1 / s for s in STD], torch.bfloat16)
    want = gather_kernel.gather_patches_plain(x, ti, tj, P, MEAN, [1 / s for s in STD],
                                              torch.bfloat16)
    assert gather_kernel.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "rank", "corner_dtype", "corner_rows", "norm_len",
                                 "patch_too_big", "out_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(2, 32, 32, 3)
    ti = torch.zeros(2, 5, dtype=torch.int32)
    tj = torch.zeros(2, 5, dtype=torch.int32)
    kw = dict(patch_dim=P, mean=None, inv_std=None, out_dtype=torch.float32)
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[0]
    elif bad == "corner_dtype":
        ti = ti.long()
    elif bad == "corner_rows":
        tj = tj[:1]
    elif bad == "norm_len":
        kw.update(mean=(0.5, 0.5), inv_std=(2.0, 2.0))
    elif bad == "patch_too_big":
        kw.update(patch_dim=33)
    elif bad == "out_dtype":
        kw.update(out_dtype=torch.float16)
    with pytest.raises(ValueError):
        gather_kernel.gather_patches(x, ti, tj, **kw)
