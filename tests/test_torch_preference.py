"""Pairwise preference training: the port's ``models/preference.py`` and
the pairwise (K = 3) train and eval steps against the JAX package's on the
CPU, fp32, dropout and DropPath off, on the patches JAX's own extraction
draws.

Both preference maps are held to JAX's, each with its own sign: the module
reads sigmoid(p * (q2 - q1)), the default sigmoid(q1 - q2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models import preference as jpref
from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.ops import PatchSampler as JPatchSampler
from vtamiq_tpu.train import optim as joptim
from vtamiq_tpu.train import steps as jsteps
from vtamiq_tpu_torch.models import preference as tpref
from vtamiq_tpu_torch.models.checkpoint import params_from_jax
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ
from vtamiq_tpu_torch.ops.sampling import PatchSampler
from vtamiq_tpu_torch.train import optim, steps
from test_torch_train_step import CFG, JCFG, LW, t

PREF_TOL = 1e-6   # the preference maps alone: fp32, the same few operations
RTOL, ATOL = 1e-4, 1e-7   # a whole step, fp32: sums in other orders
PARAM_TOL = 1e-5
B, IMG_H, IMG_W = 4, 48, 64
GCONF = dict(optimizer="AdamW", optimizer_weight_decay=0.01, optimizer_learning_rate=1e-3,
             scheduler_step_per_batch=True, scheduler_type="lambda",
             optimizer_learning_rate_decay_lambda_goal=0.1, num_epochs=2,
             optimizer_decay_after_n_epochs=[1], optimizer_learning_rate_decay_multistep=0.1,
             optimizer_learning_rate_decay_cosine=0.01,
             optimizer_sgd_momentum=0.9, optimizer_sgd_nesterov=True)


def test_preference_maps_match_jax_with_their_signs():
    rng = np.random.default_rng(0)
    q1, q2 = (rng.normal(0, 2, (16,)).astype(np.float32) for _ in range(2))
    module = tpref.PreferenceModule(6.0)
    assert float(module.p.detach()) == 6.0 and module.p.requires_grad
    jp = jpref.init_preference_params(6.0)
    got = tpref.preference_forward(module, t(q1), t(q2)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jpref.preference_forward(jp, q1, q2)),
                               rtol=0, atol=PREF_TOL)
    got = tpref.preference_sigmoid(t(q1), t(q2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpref.preference_sigmoid(q1, q2)),
                               rtol=0, atol=PREF_TOL)
    # opposite signs: a better (lower) q1 is preferred by the module, not by
    # the default map
    better = tpref.preference_forward(module, torch.tensor([0.0]), torch.tensor([1.0]))
    assert float(better) > 0.5
    assert float(tpref.preference_sigmoid(torch.tensor([0.0]), torch.tensor([1.0]))) < 0.5
    assert tpref.preference_forward(module, t(q1[:, None]), t(q2[:, None])).shape == (16,)


def _triplets(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (B, 3, IMG_H, IMG_W, 3)).astype(np.float32)
    return raw, rng.uniform(0, 1, B).astype(np.float32)


def _models(seed, use_pref_module):
    jp = jinit(jax.random.PRNGKey(seed), JCFG)
    module = VTAMIQ(CFG)
    module.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    if use_pref_module:
        jp["pref_module"] = jpref.init_preference_params(6.0)
        tpref.attach_preference_module(module, 6.0)
    return jp, module


def test_pair_rows_fold_ref_dista_then_ref_distb():
    x = torch.arange(2 * 3).reshape(2, 3)  # items 0, 1; towers ref, A, B
    np.testing.assert_array_equal(steps._pair_rows(x).numpy(),
                                  [[0, 1], [3, 4], [0, 2], [3, 5]])


@pytest.mark.parametrize("use_pref_module,optimizer", [(True, "SGD"), (False, "SGD"),
                                                       (True, "AdamW")])
def test_pairwise_train_step_matches_jax(use_pref_module, optimizer):
    """SGD keeps each gradient's rounding noise at its own scale, so every
    parameter is held to JAX's after each of two steps; AdamW (the
    recipe's optimizer) turns the noise of gradients that are zero in exact
    arithmetic into full steps, so with it the loss, q and ``p`` are held
    after one step."""
    gconf = dict(GCONF, optimizer=optimizer,
                 optimizer_learning_rate=0.02 if optimizer == "SGD" else 1e-3)
    ecfg = jsteps.ExtractConfig(patch_count=64, gather_dtype="float32")
    jopt, _ = joptim.make_optimizer(gconf, 4)
    jp, module = _models(0, use_pref_module)
    jmask = joptim.build_freeze_mask(jp, False)
    jstate = jopt.init(jp)
    jstep = jsteps.make_train_step(JCFG, JPatchSampler(), ecfg, jopt, is_pairwise=True,
                                   use_pref_module=use_pref_module, compute_dtype=jnp.float32)
    jextract = jax.jit(jsteps.make_extract_fn(JPatchSampler(), ecfg))

    topt, _ = optim.make_optimizer(gconf, 4)
    tstate = topt.init({n: p.detach() for n, p in module.named_parameters()})
    tmask = optim.build_freeze_mask(module, False)
    assert ("pref_module.p" in tmask) == use_pref_module
    tstep = steps.make_train_step_on_patches(CFG, topt, compute_dtype=torch.float32,
                                             is_pairwise=True, use_pref_module=use_pref_module)
    for i in range(2 if optimizer == "SGD" else 1):
        raw, qs = _triplets(i)
        valid = B - i  # the second batch carries one padded item
        key = jax.random.PRNGKey(20 + i)
        patches, pos, scales = jextract(jnp.asarray(raw), jax.random.split(key)[0])
        assert patches.shape[:3] == (B, 3, 64)
        jp, jstate, jmetrics, jq = jstep(jp, jstate, jmask, jnp.asarray(raw), jnp.asarray(qs),
                                         jnp.asarray(valid), key, jnp.asarray(LW))
        metrics, q = tstep(module, tstate, tmask, t(patches), t(pos), t(scales), t(qs),
                           valid, LW)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
        for key_ in ("loss", "mae", "rank", "pears", "grad_norm"):
            assert float(metrics[key_]) == pytest.approx(float(jmetrics[key_]), rel=RTOL,
                                                          abs=ATOL), key_
        assert float(metrics["rank"]) == float(metrics["pears"]) == 0.0
        assert float(metrics["mae"]) == float(metrics["loss"])
        if optimizer == "SGD":
            want = _flatten(jp)
            for name, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[name.replace(".", "|")],
                                           rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=name)
    if use_pref_module:  # p trains (and, under AdamW, decays) with the model
        p = float(module.pref_module.p.detach())
        assert p != 6.0 and p == pytest.approx(float(jp["pref_module"]["p"]), abs=PARAM_TOL)


@pytest.mark.parametrize("use_pref_module", [True, False])
def test_pairwise_eval_step_matches_jax(use_pref_module):
    ecfg = jsteps.ExtractConfig(patch_count=64, gather_dtype="float32")
    jp, module = _models(1, use_pref_module)
    if use_pref_module:  # a trained scale, not the initial one
        jp["pref_module"]["p"] = jnp.asarray(4.5, jnp.float32)
        with torch.no_grad():
            module.pref_module.p.fill_(4.5)
    raw, qs = _triplets(5)
    key = jax.random.PRNGKey(3)
    jeval = jsteps.make_eval_step(JCFG, JPatchSampler(), ecfg, is_pairwise=True,
                                  use_pref_module=use_pref_module, compute_dtype=jnp.float32)
    jmetrics, jq = jeval(jp, jnp.asarray(raw), jnp.asarray(qs), jnp.asarray(3), key,
                         jnp.asarray(LW))
    patches, pos, scales = jsteps.make_extract_fn(JPatchSampler(), ecfg)(jnp.asarray(raw), key)
    teval = steps.make_eval_step_on_patches(CFG, compute_dtype=torch.float32,
                                            is_pairwise=True, use_pref_module=use_pref_module)
    metrics, q = teval(module, t(patches), t(pos), t(scales), t(qs), 3, LW)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
    for key_ in ("loss", "mae", "rank", "pears"):
        assert float(metrics[key_]) == pytest.approx(float(jmetrics[key_]), rel=RTOL, abs=ATOL)


def test_pairwise_steps_from_raw_images():
    """make_train_step / make_eval_step with is_pairwise: the extraction
    draws K = 3 towers, the same seed gives the same step."""
    ecfg = steps.ExtractConfig(patch_count=24, gather_dtype="float32")
    raw, qs = _triplets(7)

    def run(seed):
        _, module = _models(2, True)
        opt, _ = optim.make_optimizer(GCONF, 4)
        state = opt.init({n: p.detach() for n, p in module.named_parameters()})
        step = steps.make_train_step(CFG, PatchSampler(), ecfg, opt, is_pairwise=True,
                                     use_pref_module=True, compute_dtype=torch.float32)
        metrics, q = step(module, state, optim.build_freeze_mask(module, False), t(raw), t(qs),
                          B, LW, torch.Generator().manual_seed(seed))
        return metrics, q, float(module.pref_module.p.detach())

    (m1, q1, p1), (m2, q2, p2) = run(0), run(0)
    assert torch.equal(q1, q2) and p1 == p2 != 6.0
    assert q1.shape == (B,) and bool(((q1 >= 0) & (q1 <= 1)).all())
    assert np.isfinite(float(m1["loss"]))
    _, module = _models(2, False)
    evaluate = steps.make_eval_step(CFG, PatchSampler(), ecfg, is_pairwise=True,
                                    compute_dtype=torch.float32)
    metrics, q = evaluate(module, t(raw), t(qs), B, LW, torch.Generator().manual_seed(1))
    assert q.shape == (B,) and float(metrics["rank"]) == 0.0
