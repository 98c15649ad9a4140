"""The port's train and eval steps against the JAX package's
``make_train_step``/``make_eval_step`` on the CPU, fp32, dropout and
DropPath off, on the patches JAX's own extraction draws.

At 2048 patches both packages take their flash-attention branch (JAX its
blockwise reference on the CPU, the port the flash kernels' plain
versions); at 500 patches neither does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.ops import PatchSampler as JPatchSampler
from vtamiq_tpu.train import optim as joptim
from vtamiq_tpu.train import steps as jsteps
from vtamiq_tpu_torch.models.checkpoint import params_from_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ
from vtamiq_tpu_torch.ops import attention as tattention
from vtamiq_tpu_torch.ops import sampling as ts
from vtamiq_tpu_torch.ops.sampling import PatchSampler
from vtamiq_tpu_torch.train import optim, steps
from test_torch_extraction import feed_draws, jax_weighted_draw_queue

VIT_KW = dict(num_keep_layers=2, num_extra_tokens=2, hidden_size=64, mlp_dim=128, num_heads=4)
HEAD_KW = dict(num_rgs=1, num_rcabs=2, ca_reduction=4, rg_path_drop=0.0, predictor_dropout=0.0)
JCFG = JVTAMIQConfig(vit=jget_vit_config(**VIT_KW), **HEAD_KW)
CFG = VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW)
# SGD keeps a gradient's rounding noise at its own scale (Adam would blow
# the noise of gradients that are zero in exact arithmetic, such as the key
# bias's, up to a full step); the optimizers have their own tests
GCONF = dict(optimizer="SGD", optimizer_weight_decay=0.01, optimizer_learning_rate=0.02,
             scheduler_step_per_batch=True, scheduler_type="lambda",
             optimizer_learning_rate_decay_lambda_goal=0.1, num_epochs=2,
             optimizer_decay_after_n_epochs=[1], optimizer_learning_rate_decay_multistep=0.1,
             optimizer_learning_rate_decay_cosine=0.01,
             optimizer_sgd_momentum=0.9, optimizer_sgd_nesterov=True)
FREEZE = {"freeze_dict_vit": {"freeze_encoder": False, "freeze_embeddings_patch": False}}
LW = (0.75, 1.0, 0.2)
B, IMG_H, IMG_W = 4, 64, 96
# fp32 on both sides; attention is blockwise online softmax in JAX and
# dense in the port, so sums run in other orders: relative 1e-4, and an
# absolute floor of 1e-7 for values that are rounding noise (gradients
# that are zero in exact arithmetic, times the learning rate)
RTOL, ATOL = 1e-4, 1e-7


def batch(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (B, 2, IMG_H, IMG_W, 3)).astype(np.float32)
    return raw, rng.uniform(0, 1, B).astype(np.float32)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def assert_params_match(module, jparams):
    want = _flatten(jparams)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name.replace(".", "|")],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def assert_metrics_match(got, want):
    for key in ("loss", "mae", "rank", "pears", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=RTOL, abs=ATOL), key


@pytest.mark.parametrize("patch_count,n_steps", [(2048, 2), (500, 1)])
def test_train_steps_match_jax(patch_count, n_steps):
    ecfg = jsteps.ExtractConfig(patch_count=patch_count, gather_dtype="float32")
    jopt, _ = joptim.make_optimizer(GCONF, 4)
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    jmask = joptim.build_freeze_mask(jp, True, FREEZE)
    jstate = jopt.init(jp)
    jstep = jsteps.make_train_step(JCFG, JPatchSampler(), ecfg, jopt, compute_dtype=jnp.float32)
    jextract = jax.jit(jsteps.make_extract_fn(JPatchSampler(), ecfg))

    module = VTAMIQ(CFG)
    module.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    topt, _ = optim.make_optimizer(GCONF, 4)
    tstate = topt.init({n: p.detach() for n, p in module.named_parameters()})
    tmask = optim.build_freeze_mask(module, True, FREEZE)
    attention_fn = steps.default_attention_fn(patch_count)
    assert (attention_fn is None) == (patch_count < tattention.FLASH_ATTENTION_THRESHOLD)
    tstep = steps.make_train_step_on_patches(CFG, topt, compute_dtype=torch.float32,
                                             attention_fn=attention_fn)

    for i in range(n_steps):
        raw, qs = batch(i)
        valid = B - i  # the second batch carries one padded item
        key = jax.random.PRNGKey(10 + i)
        patches, pos, scales = jextract(jnp.asarray(raw), jax.random.split(key)[0])
        jp, jstate, jmetrics, jq = jstep(jp, jstate, jmask, jnp.asarray(raw), jnp.asarray(qs),
                                         jnp.asarray(valid), key, jnp.asarray(LW))
        metrics, q = tstep(module, tstate, tmask, t(patches), t(pos), t(scales), t(qs),
                           valid, LW)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
        assert_metrics_match(metrics, jmetrics)
        assert_params_match(module, jp)
    assert tstate["count"] == n_steps


def test_eval_step_matches_jax():
    ecfg = jsteps.ExtractConfig(patch_count=2048, gather_dtype="float32")
    jp = jinit(jax.random.PRNGKey(1), JCFG)
    module = VTAMIQ(CFG)
    module.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    raw, qs = batch(5)
    key = jax.random.PRNGKey(3)
    jeval = jsteps.make_eval_step(JCFG, JPatchSampler(), ecfg, compute_dtype=jnp.float32)
    jmetrics, jq = jeval(jp, jnp.asarray(raw), jnp.asarray(qs), jnp.asarray(3), key,
                         jnp.asarray(LW))
    patches, pos, scales = jsteps.make_extract_fn(JPatchSampler(), ecfg)(jnp.asarray(raw), key)
    teval = steps.make_eval_step_on_patches(CFG, compute_dtype=torch.float32,
                                            attention_fn=steps.default_attention_fn(2048))
    metrics, q = teval(module, t(patches), t(pos), t(scales), t(qs), 3, LW)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
    for key_ in ("loss", "mae", "rank", "pears"):
        assert float(metrics[key_]) == pytest.approx(float(jmetrics[key_]), rel=RTOL, abs=ATOL)


def test_train_step_from_raw_images_draws_and_updates():
    """make_train_step: extraction from a CPU generator, then the step; the
    same seed gives the same result; pairwise steps build."""
    ecfg = steps.ExtractConfig(patch_count=24, gather_dtype="float32")
    raw, qs = batch(7)

    def run(seed):
        module = VTAMIQ(CFG)
        module.load_state_dict(params_from_jax(_flatten(jinit(jax.random.PRNGKey(0), JCFG))))
        opt, _ = optim.make_optimizer(dict(GCONF, optimizer="AdamW"), 4)
        state = opt.init({n: p.detach() for n, p in module.named_parameters()})
        step = steps.make_train_step(CFG, PatchSampler(), ecfg, opt,
                                     compute_dtype=torch.float32)
        mask = optim.build_freeze_mask(module, False)
        metrics, q = step(module, state, mask, t(raw), t(qs), B, LW,
                          torch.Generator().manual_seed(seed))
        return metrics, q, module.q_predictor.fc2.kernel.detach().clone()

    m1, q1, w1 = run(0)
    m2, q2, w2 = run(0)
    assert torch.equal(q1, q2) and torch.equal(w1, w2)
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0
    # pairwise steps build (tests/test_torch_preference.py runs them)
    assert callable(steps.make_train_step(CFG, PatchSampler(), ecfg, None, is_pairwise=True))
    assert callable(steps.make_eval_step(CFG, PatchSampler(), ecfg, is_pairwise=True))


def test_frozen_parameters_do_not_move():
    """The mask multiplies the gradients and the updates: a frozen tensor
    gets no weight decay and keeps its value."""
    module = VTAMIQ(CFG)
    module.load_state_dict(params_from_jax(_flatten(jinit(jax.random.PRNGKey(2), JCFG))))
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    opt, _ = optim.make_optimizer(dict(GCONF, optimizer="AdamW"), 4)
    state = opt.init(before)
    mask = optim.build_freeze_mask(module, True, {"freeze_dict_vit": {}})
    rng = np.random.default_rng(0)
    patches = t(rng.uniform(-1, 1, (B, 2, 24, 16, 16, 3)).astype(np.float32))
    pos = t(rng.uniform(0, 1, (B, 2, 24, 2)).astype(np.float32))
    step = steps.make_train_step_on_patches(CFG, opt, compute_dtype=torch.float32)
    step(module, state, mask, patches, pos, None, t(batch(0)[1]), B, LW)
    for n, p in module.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == (mask[n] > 0), n


def test_weighted_train_steps_match_jax(monkeypatch):
    """BASELINE config 3's sampler (weighted CAPS, MAGNITUDE diff map,
    PERTURBED cells) through make_train_step: the port extracts its own
    patches from the raw images with JAX's draws fed to its sampler, two
    steps against JAX's make_train_step, fp32, at the tolerances above."""
    patch_count, n_steps = 500, 2
    kw = dict(diff_weight=1.0, uniform_weight=0.1, grid_type=ts.GRID_TYPE_PERTURBED,
              diff_type=ts.DIFF_TYPE_MAGNITUDE)
    jsampler, tsampler = JPatchSampler(**kw), PatchSampler(**kw)
    assert not tsampler.is_uniform and tsampler.grid_type == ts.GRID_TYPE_PERTURBED
    jopt, _ = joptim.make_optimizer(GCONF, 4)
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    jmask = joptim.build_freeze_mask(jp, True, FREEZE)
    jstate = jopt.init(jp)
    jstep = jsteps.make_train_step(JCFG, jsampler, jsteps.ExtractConfig(
        patch_count=patch_count, gather_dtype="float32"), jopt, compute_dtype=jnp.float32)

    module = VTAMIQ(CFG)
    module.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    topt, _ = optim.make_optimizer(GCONF, 4)
    tstate = topt.init({n: p.detach() for n, p in module.named_parameters()})
    tmask = optim.build_freeze_mask(module, True, FREEZE)
    tstep = steps.make_train_step(CFG, tsampler, steps.ExtractConfig(
        patch_count=patch_count, gather_dtype="float32"), topt, compute_dtype=torch.float32)

    for i in range(n_steps):
        raw, qs = batch(i)
        valid = B - i
        key = jax.random.PRNGKey(10 + i)
        item_keys = list(jax.random.split(jax.random.split(key)[0], B))
        queue, _ = jax_weighted_draw_queue(item_keys, 2, IMG_H, IMG_W, patch_count, 1, True)
        rest = feed_draws(monkeypatch, queue)
        jp, jstate, jmetrics, jq = jstep(jp, jstate, jmask, jnp.asarray(raw), jnp.asarray(qs),
                                         jnp.asarray(valid), key, jnp.asarray(LW))
        metrics, q = tstep(module, tstate, tmask, t(raw), t(qs), valid, LW, torch.Generator())
        assert next(rest, None) is None
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
        assert_metrics_match(metrics, jmetrics)
        assert_params_match(module, jp)
