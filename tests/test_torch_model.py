"""The port's ViT and VTAMIQ forward against the JAX package's, with the
JAX-initialized weights carried across by params_from_jax."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models import vit as jvit
from vtamiq_tpu.models import vtamiq as jvtamiq
from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu_torch.models import vit as tvit
from vtamiq_tpu_torch.models import vtamiq as tvtamiq
from vtamiq_tpu_torch.models.checkpoint import params_from_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config

VIT_KW = dict(num_keep_layers=2, num_extra_tokens=2, hidden_size=64, mlp_dim=128, num_heads=4)
HEAD_KW = dict(num_rgs=2, num_rcabs=2, ca_reduction=4)
N = 24
FP32_TOL = 1e-5
# bf16 policy: JAX (XLA on the CPU) and PyTorch round to bf16 at different
# points (fused vs unfused elementwise chains, GELU and softmax inputs), so
# the two bf16 runs differ by a few bf16 ulps (2^-8 relative) per layer.
# Both are held against the fp32 result of the same framework, and to each
# other, at a tolerance of that order.
BF16_TOL = 5e-2


def configs(**vit_over):
    vit_kw = {**VIT_KW, **vit_over}
    head = {k: v for k, v in vit_kw.items() if k in ("use_ms_cam", "use_local")}
    for k in head:
        vit_kw.pop(k)
    jcfg = JVTAMIQConfig(vit=jget_vit_config(**vit_kw), **HEAD_KW, **head)
    tcfg = VTAMIQConfig(vit=get_vit_config(**vit_kw), **HEAD_KW, **head)
    return jcfg, tcfg


def carried(jparams, module):
    module.load_state_dict(params_from_jax(_flatten(jparams)), strict=True)
    return module.eval()


def inputs(seed, b=2, towers=2, n=N, num_scales=0):
    rng = np.random.default_rng(seed)
    patches = rng.uniform(-1, 1, (b, towers, n, 16, 16, 3)).astype(np.float32)
    pos = rng.uniform(0, 1, (b, towers, n, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, towers, n)) > 0.3
    scales = rng.integers(0, max(num_scales, 1), (b, towers, n)).astype(np.int32)
    return patches, pos, mask, scales


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_state_dict_keys_and_shapes_match_jax_pytree():
    jcfg, tcfg = configs(use_ms_cam=True, use_local=True)
    jflat = _flatten(jvtamiq.init_vtamiq_params(jax.random.PRNGKey(0), jcfg))
    sd = tvtamiq.init_vtamiq_params(tcfg, torch.Generator().manual_seed(0)).state_dict()
    assert sorted(sd) == sorted(k.replace("|", ".") for k in jflat)
    for k, v in jflat.items():
        assert tuple(sd[k.replace("|", ".")].shape) == v.shape, k


def test_seeded_init_is_deterministic_and_follows_jax_initializers():
    _, tcfg = configs()
    a = tvtamiq.init_vtamiq_params(tcfg, torch.Generator().manual_seed(3)).state_dict()
    b = tvtamiq.init_vtamiq_params(tcfg, torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["vit.encoder.layers.layer_0.ln1.scale"] == 1)
    assert torch.all(a["vit.encoder.layers.layer_0.attn.query.bias"] == 0)
    assert float(a["q_predictor.prelu"]) == 0.25
    assert float(a["vit.embeddings.pos_embeddings"].abs().max()) <= 0.04
    lim = np.sqrt(6 / (64 + 128))
    k = a["vit.encoder.layers.layer_1.mlp.fc1.kernel"]
    assert float(k.abs().max()) <= lim and float(k.std()) > lim / 3


@pytest.mark.parametrize("tokens_only", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_scales", [0, 3])
def test_vit_forward_fp32(tokens_only, masked, num_scales):
    jcfg, tcfg = configs(num_scales=num_scales)
    jp = jvit.init_vit_params(jax.random.PRNGKey(1), jcfg.vit)
    tp = carried(jp, tvit.ViT(tcfg.vit))
    patches, pos, mask, scales = inputs(2, num_scales=num_scales)
    patches, pos, mask, scales = patches[:, 0], pos[:, 0], mask[:, 0], scales[:, 0]
    sc = scales if num_scales > 1 else None
    want = jvit.vit_forward(jp, jcfg.vit, jnp.asarray(patches), jnp.asarray(pos),
                            None if sc is None else jnp.asarray(sc), tokens_only=tokens_only,
                            patch_mask=jnp.asarray(mask) if masked else None,
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tp(t(patches), t(pos), None if sc is None else t(sc), tokens_only=tokens_only,
                 patch_mask=t(mask) if masked else None, compute_dtype=torch.float32)
    # the JAX package pads the token axis to 128 (TPU lanes) and returns the
    # padded rows with tokens_only=False; the port does not pad
    want = np.asarray(want)[:, :got.shape[1]]
    assert got.dtype == torch.float32
    assert got.shape == ((2, 3, 64) if tokens_only else (2, 3 + N, 64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("head", [{}, dict(use_ms_cam=True), dict(use_ms_cam=True, use_local=True)],
                         ids=["calayer", "ms_cam", "ms_cam_local"])
@pytest.mark.parametrize("masked", [False, True])
def test_vtamiq_forward_fp32(head, masked):
    jcfg, tcfg = configs(**head)
    jp = jvtamiq.init_vtamiq_params(jax.random.PRNGKey(4), jcfg)
    tp = carried(jp, tvtamiq.VTAMIQ(tcfg))
    patches, pos, mask, _ = inputs(5)
    want = jvtamiq.vtamiq_forward(jp, jcfg, jnp.asarray(patches), jnp.asarray(pos),
                                  patch_mask=jnp.asarray(mask) if masked else None,
                                  compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tp(t(patches), t(pos), patch_mask=t(mask) if masked else None,
                 compute_dtype=torch.float32)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("policy", ["bfloat16", "mixed"])
def test_vtamiq_forward_low_precision_policies(policy):
    jcfg, tcfg = configs()
    jp = jvtamiq.init_vtamiq_params(jax.random.PRNGKey(6), jcfg)
    tp = carried(jp, tvtamiq.VTAMIQ(tcfg))
    patches, pos, _, _ = inputs(7)
    jdt = "mixed" if policy == "mixed" else jnp.bfloat16
    tdt = "mixed" if policy == "mixed" else torch.bfloat16
    j32 = np.asarray(jvtamiq.vtamiq_forward(jp, jcfg, jnp.asarray(patches), jnp.asarray(pos),
                                            compute_dtype=jnp.float32))
    jlow = np.asarray(jvtamiq.vtamiq_forward(jp, jcfg, jnp.asarray(patches), jnp.asarray(pos),
                                             compute_dtype=jdt))
    with torch.no_grad():
        tlow = tp(t(patches), t(pos), compute_dtype=tdt).numpy()
    assert np.isfinite(tlow).all()
    scale = max(1.0, float(np.abs(j32).max()))
    assert np.abs(tlow - j32).max() <= BF16_TOL * scale
    assert np.abs(tlow - jlow).max() <= BF16_TOL * scale


def test_aff_and_iaff_match_jax():
    jp = {"aff": jvtamiq.init_aff(jax.random.PRNGKey(0), 32, 4),
          "iaff": jvtamiq.init_iaff(jax.random.PRNGKey(1), 32, 4)}
    tp = torch.nn.ModuleDict({"aff": tvtamiq.make_aff(32, 4), "iaff": tvtamiq.make_iaff(32, 4)})
    carried(jp, tp)
    rng = np.random.default_rng(0)
    x, y = (rng.normal(0, 1, (3, 32)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        np.testing.assert_allclose(tvtamiq.aff(tp["aff"], t(x), t(y)).numpy(),
                                   np.asarray(jvtamiq.aff(jp["aff"], x, y)), atol=FP32_TOL)
        np.testing.assert_allclose(tvtamiq.iaff(tp["iaff"], t(x), t(y)).numpy(),
                                   np.asarray(jvtamiq.iaff(jp["iaff"], x, y)), atol=FP32_TOL)


def test_lookups_match_jax():
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (24 * 24 + 1, 8)).astype(np.float32)
    pos = np.concatenate([rng.uniform(0, 1, (50, 2)),
                          [[0.0, 0.0], [1 - 1e-6, 1 - 1e-6], [1.0, 1.0], [-0.1, 0.5]]]
                         ).astype(np.float32)
    np.testing.assert_array_equal(tvit.uv_pos_lookup(t(table), t(pos), 24).numpy(),
                                  np.asarray(jvit.uv_pos_lookup(table, pos, 24)))
    stable = rng.normal(0, 1, (4, 8)).astype(np.float32)
    sc = np.array([-1, 0, 1, 2, 5], np.int32)
    np.testing.assert_array_equal(tvit.scale_lookup(t(stable), t(sc), 3).numpy(),
                                  np.asarray(jvit.scale_lookup(stable, sc, 3)))


def test_adapters_raise():
    """Adapters build (tests/test_torch_model_extras.py holds them to JAX);
    an adapter index the layers do not have raises, where the JAX package
    would run the layer without one."""
    _, tcfg = configs()
    vit = tvit.ViT(dataclasses.replace(tcfg.vit, num_adapters=1))
    assert "encoder.layers.layer_0.adapters.adapter_0.attn.down.kernel" in dict(
        vit.named_parameters())
    tvit.init_params_(vit, torch.Generator().manual_seed(0))
    patches = torch.zeros(1, 3, 16, 16, 3)
    pos = torch.full((1, 3, 2), 0.5)
    vit(patches, pos, compute_dtype=torch.float32, adapter_num=0)
    with pytest.raises(ValueError, match="adapter_num 1"):
        vit(patches, pos, compute_dtype=torch.float32, adapter_num=1)


# ---------------------------------------------------------------------------
# attention_fn plumbing, training mode: dropout and DropPath
# ---------------------------------------------------------------------------

from vtamiq_tpu.ops import attention as jattention  # noqa: E402
from vtamiq_tpu_torch.ops import attention as tattention  # noqa: E402


@pytest.mark.parametrize("masked", [False, True])
def test_attention_fn_flash_matches_quadratic_and_jax(masked):
    """The flash attention function threaded through mhsa, encoder_layer
    and vit_forward (threshold 0: every layer but the last, whose q_len path
    stays quadratic, takes it) against the quadratic forward and against
    the JAX forward with its own flash function, fp32."""
    jcfg, tcfg = configs()
    jp = jvtamiq.init_vtamiq_params(jax.random.PRNGKey(8), jcfg)
    tp = carried(jp, tvtamiq.VTAMIQ(tcfg))
    patches, pos, mask, _ = inputs(9)
    pm = t(mask) if masked else None
    with torch.no_grad():
        quad = tp(t(patches), t(pos), patch_mask=pm, compute_dtype=torch.float32)
        flash = tp(t(patches), t(pos), patch_mask=pm, compute_dtype=torch.float32,
                   attention_fn=tattention.make_attention_fn(threshold=0))
    want = jvtamiq.vtamiq_forward(jp, jcfg, jnp.asarray(patches), jnp.asarray(pos),
                                  patch_mask=jnp.asarray(mask) if masked else None,
                                  compute_dtype=jnp.float32,
                                  attention_fn=jattention.make_attention_fn(threshold=0))
    np.testing.assert_allclose(flash.numpy(), quad.numpy(), rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)


def test_mhsa_takes_attention_fn_only_without_q_len():
    _, tcfg = configs()
    layer = tvit.init_params_(tvit.EncoderLayer(tcfg.vit), torch.Generator().manual_seed(0))
    x = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(1))
    calls = []

    def spy(q, k, v, mask):
        calls.append(q.shape)
        return tattention.make_attention_fn(threshold=10**9)(q, k, v, mask)

    with torch.no_grad():
        full = tvit.mhsa(layer.attn, x, 4, attention_fn=spy)
        plain = tvit.mhsa(layer.attn, x, 4)
        tvit.mhsa(layer.attn, x, 4, q_len=3, attention_fn=spy)
    assert calls == [(2, 11, 4, 16)]
    np.testing.assert_allclose(full.numpy(), plain.numpy(), rtol=0, atol=FP32_TOL)


def test_drop_path_is_per_sample_with_rescale():
    x = torch.ones(4000, 3, 5)
    gen = torch.Generator().manual_seed(0)
    y = tvit.drop_path(x, 0.25, gen)
    per_sample = y.reshape(4000, -1)
    kept = per_sample[:, 0] != 0
    # every sample is kept whole (scaled by 1/keep) or dropped whole
    assert torch.all(per_sample[kept] == 1 / 0.75) and torch.all(per_sample[~kept] == 0)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03  # 4000 draws: sd 0.007
    assert tvit.drop_path(x, 0.0, gen) is x


def test_predictor_dropout_is_elementwise_with_rescale():
    x = torch.ones(200, 64)
    y = tvit.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.9)
    assert abs(float(kept.float().mean()) - 0.9) < 0.01  # 12800 draws: sd 0.003
    assert 0 < int((~kept).any(dim=1).sum()) < 200       # not whole rows


def _head_cfgs(**over):
    jcfg, tcfg = configs()
    return dataclasses.replace(tcfg, **over)


def _forward(tp, cfg, train, seed=None, **kw):
    patches, pos, mask, _ = inputs(11)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return tvtamiq.vtamiq_forward(tp, cfg, t(patches), t(pos), patch_mask=t(mask),
                                      compute_dtype=torch.float32, train=train,
                                      generator=gen, **kw)


def test_train_mode_draws_only_with_a_generator():
    """rg_path_drop and predictor_dropout act in training with a generator;
    training without one, or with both probabilities 0, is the eval
    forward; the same seed gives the same draws."""
    jcfg, tcfg = configs()
    tp = carried(jvtamiq.init_vtamiq_params(jax.random.PRNGKey(12), jcfg), tvtamiq.VTAMIQ(tcfg))
    cfg = dataclasses.replace(tcfg, rg_path_drop=0.5, predictor_dropout=0.5)
    eval_q = _forward(tp, cfg, False)
    assert torch.equal(_forward(tp, cfg, True), eval_q)
    assert torch.equal(_forward(tp, cfg, False, seed=0), eval_q)
    off = dataclasses.replace(cfg, rg_path_drop=0.0, predictor_dropout=0.0)
    assert torch.equal(_forward(tp, off, True, seed=0), eval_q)
    a, b = _forward(tp, cfg, True, seed=0), _forward(tp, cfg, True, seed=0)
    assert torch.equal(a, b) and not torch.equal(a, eval_q)
    assert not torch.equal(a, _forward(tp, cfg, True, seed=1))


@pytest.mark.parametrize("active", [False, True])
def test_encoder_drop_path_follows_vit_path_drop_active(active):
    jcfg, tcfg = configs()
    tp = carried(jvtamiq.init_vtamiq_params(jax.random.PRNGKey(13), jcfg), tvtamiq.VTAMIQ(tcfg))
    vit = dataclasses.replace(tcfg.vit, path_drop_prob=0.5, vit_path_drop_active=active)
    cfg = dataclasses.replace(tcfg, vit=vit, rg_path_drop=0.0, predictor_dropout=0.0)
    same = torch.equal(_forward(tp, cfg, True, seed=0), _forward(tp, cfg, False))
    assert same != active


def test_remat_raises_in_training_only():
    """Remat no longer raises: the same outputs as without it, in eval and
    in training (the gradients: tests/test_torch_model_extras.py)."""
    jcfg, tcfg = configs()
    tp = carried(jvtamiq.init_vtamiq_params(jax.random.PRNGKey(14), jcfg), tvtamiq.VTAMIQ(tcfg))
    cfg = dataclasses.replace(tcfg, vit=dataclasses.replace(tcfg.vit, remat=True))
    assert torch.equal(_forward(tp, cfg, False), _forward(tp, tcfg, False))
    patches, pos, mask, _ = inputs(11)
    vit = dataclasses.replace(cfg.vit, path_drop_prob=0.5, vit_path_drop_active=True)
    outs = [tvtamiq.vtamiq_forward(tp, dataclasses.replace(cfg, vit=dataclasses.replace(
        vit, remat=remat)), t(patches), t(pos), patch_mask=t(mask), compute_dtype=torch.float32,
        train=True, generator=torch.Generator().manual_seed(0)) for remat in (True, False)]
    assert outs[0].requires_grad and torch.equal(outs[0], outs[1])
