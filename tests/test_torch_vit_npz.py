"""ImageNet ViT weights: the port's ``load_vit_npz`` and
``VTAMIQScorer.from_vit_npz`` against the JAX package's on the CPU, on
synthetic files in the ``ViT-B_16.npz`` key layout
(``synth.write_vit_npz``; no real ImageNet file is in the repository).

The positional grid is resized as ``jax.image.resize(..., "bilinear")``
resizes it: a triangle kernel at half-pixel centres, widened when the grid
shrinks (antialiasing), which ``F.interpolate`` does not do. Both
directions are held to JAX's at 1e-5: 14 -> 24 (an ImageNet-224 file into
the 384-pixel model) and 24 -> 14."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vtamiq_tpu.inference import VTAMIQScorer as JScorer
from vtamiq_tpu.models import vit as jvit
from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu_torch.data import synth
from vtamiq_tpu_torch.inference import VTAMIQScorer
from vtamiq_tpu_torch.models import vit as tvit
from vtamiq_tpu_torch.models.checkpoint import params_from_jax, params_to_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config

TOL = 1e-5      # fp32 weights; the resize sums in another order
Q_TOL = 1e-4
WIDTH = dict(hidden_size=64, mlp_dim=128, num_heads=4, num_extra_tokens=2)
NPZ_WIDTH = dict(hidden=64, heads=4, mlp=128)


def _configs(img_dim, layers):
    kw = dict(WIDTH, img_dim=img_dim, num_keep_layers=layers)
    return jget_vit_config(**kw), get_vit_config(**kw)


@pytest.mark.parametrize("grid,img_dim,file_layers,model_layers", [
    (14, 384, 3, 3),   # 14 -> 24, the ImageNet-224 file into the 384-pixel model
    (24, 224, 3, 3),   # 24 -> 14, a shrink (antialiased)
    (24, 384, 3, 3),   # the same grid: copied
    (14, 384, 1, 3),   # a file missing layers: they keep their values
])
def test_load_vit_npz_matches_jax(grid, img_dim, file_layers, model_layers):
    npz = synth.vit_npz_arrays(layers=file_layers, grid=grid, seed=grid, **NPZ_WIDTH)
    if file_layers == 1:
        del npz["cls"]  # and a missing key keeps its value too
    jcfg, tcfg = _configs(img_dim, model_layers)
    jinit = jvit.init_vit_params(jax.random.PRNGKey(0), jcfg)
    want = _flatten(jvit.load_vit_npz(npz, jcfg, jax.tree_util.tree_map(jnp.array, jinit)))
    model = tvit.ViT(tcfg)
    model.load_state_dict(params_from_jax(_flatten(jinit)))
    got = params_to_jax(tvit.load_vit_npz(npz, tcfg, model))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)
    init = _flatten(jinit)
    pos = "embeddings|pos_embeddings"
    assert got[pos].shape == (tcfg.pos_grid ** 2 + 1, 64)
    layer0 = "encoder|layers|layer_0|attn|query|kernel"
    np.testing.assert_array_equal(got[layer0], npz["Transformer/encoderblock_0/"
                                                  "MultiHeadDotProductAttention_1/query/kernel"]
                                  .reshape(64, 64))
    if file_layers < model_layers:
        last = "encoder|layers|layer_2|mlp|fc1|kernel"
        np.testing.assert_array_equal(got[last], np.asarray(init[last]))
        np.testing.assert_array_equal(got["embeddings|cls_token"],
                                      np.asarray(init["embeddings|cls_token"]))


def test_shrink_is_antialiased_unlike_plain_interpolate():
    """The 24 -> 14 resize differs from F.interpolate's bilinear (no
    antialiasing) and equals jax.image.resize; F.interpolate with
    antialias=True is another kernel again."""
    rng = np.random.default_rng(0)
    grid = rng.normal(0, 1, (24, 24, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (14, 14, 8), "bilinear"))
    got = tvit.resize_bilinear(torch.from_numpy(grid), 14, 14).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    chw = torch.from_numpy(grid).permute(2, 0, 1)[None]
    plain = F.interpolate(chw, (14, 14), mode="bilinear", align_corners=False)[0]
    assert np.abs(plain.permute(1, 2, 0).numpy() - want).max() > 1e-2
    up = np.asarray(jax.image.resize(jnp.asarray(grid[:14, :14]), (24, 24, 8), "bilinear"))
    np.testing.assert_allclose(tvit.resize_bilinear(torch.from_numpy(grid[:14, :14]), 24,
                                                    24).numpy(), up, rtol=0, atol=TOL)


def test_from_vit_npz_scores_match_jax(tmp_path):
    path = synth.write_vit_npz(str(tmp_path / "vit.npz"), layers=2, grid=14, seed=3,
                               **NPZ_WIDTH)
    kw = dict(WIDTH, num_keep_layers=2)
    head = dict(num_rgs=1, num_rcabs=1, ca_reduction=4)
    jcfg = JVTAMIQConfig(vit=jget_vit_config(**kw), **head)
    tcfg = VTAMIQConfig(vit=get_vit_config(**kw), **head)
    jscorer = JScorer.from_vit_npz(path, cfg=jcfg, patch_count=32, seed=0)
    scorer = VTAMIQScorer.from_vit_npz(path, cfg=tcfg, patch_count=32, seed=0, device="cpu",
                                       compute_dtype=torch.float32)
    # the same head and the same loaded ViT
    scorer.params.load_state_dict(params_from_jax(_flatten(jscorer.params)))
    ours = params_to_jax(scorer.params)
    loaded = {k: v for k, v in ours.items() if k.startswith("vit|encoder|layers|layer_1")}
    assert loaded and all(np.array_equal(v, np.asarray(_flatten(jscorer.params)[k]))
                          for k, v in loaded.items())
    # the port's own load gives JAX's ViT to 1e-5 (the register tokens are
    # not in the file: each package keeps its own draw)
    own = params_to_jax(VTAMIQScorer.from_vit_npz(path, cfg=tcfg, seed=0, device="cpu").params)
    for k, v in _flatten(jscorer.params).items():
        if k.startswith("vit|") and k != "vit|embeddings|extra_tokens":
            np.testing.assert_allclose(own[k], np.asarray(v), rtol=0, atol=TOL, err_msg=k)
    rng = np.random.default_rng(1)
    ref = rng.uniform(0, 1, (64, 80, 3)).astype(np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    # the port draws its own patches: score JAX's patches through both models
    from vtamiq_tpu.ops import PatchSampler as JPatchSampler
    from vtamiq_tpu.ops.extraction import get_iqa_patches as jget
    from vtamiq_tpu.models.vtamiq import vtamiq_forward as jforward
    from vtamiq_tpu_torch.models.vtamiq import vtamiq_forward
    imgs = jnp.stack([jnp.asarray(ref), jnp.asarray(dist)])
    patches, pos, _ = jget(imgs, imgs * 2 - 1, jax.random.PRNGKey(0), 32, 16, JPatchSampler())
    jq = jforward(jscorer.params, jcfg, patches[None], pos[None], compute_dtype=jnp.float32)
    with torch.no_grad():
        q = vtamiq_forward(scorer.params, tcfg, torch.from_numpy(np.asarray(patches))[None],
                           torch.from_numpy(np.asarray(pos))[None], compute_dtype=torch.float32)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=Q_TOL)
    assert np.isfinite(scorer.score_pair(ref, dist))
