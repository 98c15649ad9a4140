"""The port's optimizer chain, schedules and freeze masks against the JAX
package's optax chain, on the same parameters, gradients and mask."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.train import optim as joptim
from vtamiq_tpu_torch.models.checkpoint import params_from_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ
from vtamiq_tpu_torch.train import optim

VIT_KW = dict(num_keep_layers=1, num_extra_tokens=2, hidden_size=32, mlp_dim=64, num_heads=2)
HEAD_KW = dict(num_rgs=1, num_rcabs=1, ca_reduction=4)
JCFG = JVTAMIQConfig(vit=jget_vit_config(**VIT_KW), **HEAD_KW)
CFG = VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW)
# a large learning rate, so that five updates move the parameters visibly
GCONF = dict(optimizer="AdamW", optimizer_weight_decay=0.01, optimizer_learning_rate=0.05,
             scheduler_step_per_batch=True, scheduler_type="lambda",
             optimizer_learning_rate_decay_lambda_goal=0.01, num_epochs=3,
             optimizer_decay_after_n_epochs=[1, 2],
             optimizer_learning_rate_decay_multistep=0.1,
             optimizer_learning_rate_decay_cosine=0.01,
             optimizer_sgd_momentum=0.9, optimizer_sgd_nesterov=True)
STEPS_PER_EPOCH = 2
# fp32 on both sides, the same formulas; sums over leaves (the global norm)
# in another order
PARAM_TOL = 1e-6
FREEZE = {"freeze_dict_vit": {}, "freeze_q_predictor": True}


@functools.lru_cache(maxsize=1)
def jparams():
    """JAX parameters (immutable arrays, so one draw serves every test)."""
    return jinit(jax.random.PRNGKey(0), JCFG)


def tmodule(jp):
    m = VTAMIQ(CFG)
    m.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    return m


def jmask_flat(jp, freeze_state, freeze_dict):
    flat = _flatten(joptim.build_freeze_mask(jp, freeze_state, freeze_dict))
    return {k.replace("|", "."): float(v) for k, v in flat.items()}


CASES = [(opt, kind, per_batch) for opt in ("SGD", "Adam", "AdamW")
         for kind, per_batch in (("lambda", True), ("lambda", False), ("cosine", True),
                                 ("cosine", False), ("multistep", False))]


@pytest.mark.parametrize("name,kind,per_batch", CASES)
def test_five_masked_steps_match_optax(name, kind, per_batch):
    """Five updates with a freeze mask: gradients and updates both masked,
    as the train step does; gradient norms around the clip threshold."""
    conf = dict(GCONF, optimizer=name, scheduler_type=kind, scheduler_step_per_batch=per_batch)
    jp = jparams()
    module = tmodule(jp)
    tp = dict(module.named_parameters())
    mask = optim.build_freeze_mask(module, True, FREEZE)
    jm = joptim.build_freeze_mask(jp, True, FREEZE)

    jopt, _ = joptim.make_optimizer(conf, STEPS_PER_EPOCH)
    jstate = jopt.init(jp)
    topt, _ = optim.make_optimizer(conf, STEPS_PER_EPOCH)
    tstate = topt.init({n: p.detach() for n, p in tp.items()})

    rng = np.random.default_rng(7)
    shapes = {n: v.shape for n, v in sorted(_flatten(jp).items())}
    jupdate = jax.jit(jopt.update)
    for step in range(5):
        scale = (0.02, 0.3, 0.005, 0.1, 0.02)[step]
        g = {n: np.asarray(rng.normal(size=shape) * scale, np.float32)
             for n, shape in shapes.items()}
        jg = jax.tree_util.tree_map(jnp.asarray, _unflatten_like(jp, g))
        jg = joptim.apply_mask(jg, jm)
        upd, jstate = jupdate(jg, jstate, jp)
        jp = optax.apply_updates(jp, joptim.apply_mask(upd, jm))

        tg = optim.apply_mask({n.replace("|", "."): torch.from_numpy(v) for n, v in g.items()},
                              mask)
        with torch.no_grad():
            cur = {n: p.detach() for n, p in tp.items()}
            tu = optim.apply_mask(topt.update(tg, tstate, cur), mask)
            for n, p in tp.items():
                p.add_(tu[n])
    assert tstate["count"] == 5
    want = _flatten(jp)
    for n, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n.replace(".", "|")],
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=n)


def _unflatten_like(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}|") for k, v in tree.items()}
    return flat[prefix.rstrip("|")]


@pytest.mark.parametrize("kind,per_batch", [("lambda", True), ("lambda", False),
                                            ("cosine", True), ("cosine", False),
                                            ("multistep", False)])
def test_schedules_match_jax(kind, per_batch):
    conf = dict(GCONF, scheduler_type=kind, scheduler_step_per_batch=per_batch)
    js = joptim.make_lr_schedule(conf, STEPS_PER_EPOCH)
    ts = optim.make_lr_schedule(conf, STEPS_PER_EPOCH)
    for count in range(8):
        assert float(ts(count)) == pytest.approx(float(js(jnp.asarray(count))), rel=1e-6)


def test_multistep_per_batch_and_unknown_names_raise():
    with pytest.raises(NotImplementedError, match="per-batch"):
        optim.make_lr_schedule(dict(GCONF, scheduler_type="multistep"), 2)
    with pytest.raises(ValueError, match="scheduler_type"):
        optim.make_lr_schedule(dict(GCONF, scheduler_type="nope"), 2)
    with pytest.raises(ValueError, match="optimizer"):
        optim.make_optimizer(dict(GCONF, optimizer="Lion"), 2)


@pytest.mark.parametrize("freeze_state,freeze_dict", [
    (False, {}),
    (True, {"freeze_dict_vit": {}}),
    (True, {"freeze_dict_vit": {"freeze_encoder_layerscale": True,
                                "freeze_embeddings_scale": True,
                                "freeze_embeddings_pos": False},
            "freeze_quality_decoder": True, "freeze_q_predictor": True}),
    (True, {"freeze_dict_vit": {"freeze_encoder": False, "freeze_embeddings_patch": False}}),
])
def test_freeze_mask_matches_jax(freeze_state, freeze_dict):
    jp = jparams()
    got = optim.build_freeze_mask(tmodule(jp), freeze_state, freeze_dict)
    want = jmask_flat(jp, freeze_state, freeze_dict)
    assert got == want
    assert optim.count_trainable(got) == joptim.count_trainable(
        joptim.build_freeze_mask(jp, freeze_state, freeze_dict))


def test_global_norm_matches_optax():
    jp = jparams()
    want = float(optax.global_norm(jp))
    got = float(optim.global_norm({n: p.detach() for n, p in tmodule(jp).named_parameters()}))
    assert got == pytest.approx(want, rel=1e-6)
