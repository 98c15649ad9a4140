"""The committed B16-6L checkpoint through the port's reader, against the
JAX package's load_checkpoint + merge_params, and one pair at full width."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models.checkpoint import MODEL_STATE_DICT, _flatten
from vtamiq_tpu.models.checkpoint import load_checkpoint as jload
from vtamiq_tpu.models.checkpoint import merge_params as jmerge
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit, vtamiq_forward as jforward
from vtamiq_tpu_torch.inference import VTAMIQScorer
from vtamiq_tpu_torch.models.checkpoint import load_checkpoint, merge_params, params_from_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, vtamiq_forward

CKPT = os.path.join(os.path.dirname(__file__), "..", ".int8_regen_out",
                    "1787216693-TID2013-VTAMIQ-ViT-B16-6L-4R-2e-16b-384p", "best.npz")
JCFG = JVTAMIQConfig(vit=jget_vit_config(num_keep_layers=6, num_extra_tokens=8))


@pytest.fixture(scope="module")
def loaded():
    """(JAX params after load + merge, the port's CPU scorer from the file)."""
    ckpt = jload(CKPT)
    jp = jmerge(jinit(jax.random.PRNGKey(0), JCFG), ckpt[MODEL_STATE_DICT], strict=True)
    scorer = VTAMIQScorer.from_checkpoint(CKPT, device="cpu", compute_dtype=torch.float32)
    return jp, scorer


def test_every_tensor_equals_jax(loaded):
    jp, scorer = loaded
    jflat = _flatten(jp)
    sd = scorer.params.state_dict()
    assert sorted(sd) == sorted(k.replace("|", ".") for k in jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(sd[k.replace("|", ".")].numpy(), v, err_msg=k)


def test_reader_keys_and_strict_merge():
    ckpt = load_checkpoint(CKPT)
    assert ckpt["meta"]["epoch"] == ckpt["epoch"]
    flat = ckpt[MODEL_STATE_DICT]
    assert "vit|encoder|layers|layer_5|mlp|fc1|kernel" in flat
    assert flat["vit|embeddings|patch|kernel"].shape == (16 * 16 * 3, 768)
    # a file missing one of the model's tensors still merges what matches
    model = VTAMIQ(VTAMIQConfig(vit=get_vit_config(num_keep_layers=6, num_extra_tokens=8)))
    stats = {}
    sd = params_from_jax(flat)
    sd.pop("diff_scale")
    merge_params(model, sd, stats=stats)
    assert stats == {"merged": len(flat) - 1, "kept": 1}
    assert torch.equal(model.vit.embeddings.patch.kernel.detach(),
                       torch.from_numpy(flat["vit|embeddings|patch|kernel"]))
    with pytest.raises(KeyError):
        merge_params(model, sd, strict=True)


def test_full_width_pair_matches_jax(loaded):
    jp, scorer = loaded
    rng = np.random.default_rng(0)
    patches = rng.uniform(-1, 1, (1, 2, 64, 16, 16, 3)).astype(np.float32)
    patches[0, 1] += rng.normal(0, 0.1, patches[0, 1].shape).astype(np.float32)
    pos = rng.uniform(0, 1, (1, 2, 64, 2)).astype(np.float32)
    pos[0, 1] = pos[0, 0]
    want = np.asarray(jforward(jp, JCFG, jnp.asarray(patches), jnp.asarray(pos),
                               compute_dtype=jnp.float32))
    with torch.no_grad():
        got = vtamiq_forward(scorer.params, scorer.cfg, torch.from_numpy(patches),
                             torch.from_numpy(pos), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# round trips between the packages (small model): parameters bit for bit,
# optimizer moments and count to 1e-7 (the same fp32 values stored as npz)
# --------------------------------------------------------------------------

SMALL_VIT = dict(num_keep_layers=2, num_extra_tokens=2, hidden_size=32, mlp_dim=64, num_heads=2)
SMALL_HEAD = dict(num_rgs=1, num_rcabs=2, ca_reduction=4)
ADAMW = dict(optimizer="AdamW", optimizer_weight_decay=0.01, optimizer_learning_rate=1e-3,
             scheduler_step_per_batch=False, scheduler_type="lambda",
             optimizer_learning_rate_decay_lambda_goal=0.1, num_epochs=2,
             optimizer_sgd_momentum=0.9, optimizer_sgd_nesterov=True)


def _small_module(seed):
    from vtamiq_tpu_torch.models.vtamiq import init_vtamiq_params
    cfg = VTAMIQConfig(vit=get_vit_config(**SMALL_VIT), **SMALL_HEAD)
    return init_vtamiq_params(cfg, torch.Generator().manual_seed(seed))


def _filled_state(opt, module, seed):
    """An optimizer state with moments and a count that are not zeros."""
    state = opt.init({n: p.detach() for n, p in module.named_parameters()})
    g = torch.Generator().manual_seed(seed)
    for key in ("mu", "nu", "trace"):
        for t in state.get(key, {}).values():
            t.copy_(torch.rand(t.shape, generator=g))
    state["count"] = 7
    return state


def test_port_checkpoint_loads_in_jax(tmp_path):
    from vtamiq_tpu.models.checkpoint import restore_opt_state as jrestore
    from vtamiq_tpu.train import optim as joptim
    from vtamiq_tpu_torch.models.checkpoint import params_to_jax, save_checkpoint
    from vtamiq_tpu_torch.train import optim
    module = _small_module(5)
    opt, _ = optim.make_optimizer(ADAMW, 4)
    state = _filled_state(opt, module, 1)
    save_checkpoint(str(tmp_path), "p.npz", {MODEL_STATE_DICT: params_to_jax(module)}, 3, 0.5,
                    opt_state=state, extra_meta={"w_mae": 0.25})

    ckpt = jload(str(tmp_path / "p.npz"))
    assert ckpt["epoch"] == 3 and ckpt["meta"]["w_mae"] == 0.25
    jcfg = JVTAMIQConfig(vit=jget_vit_config(**SMALL_VIT), **SMALL_HEAD)
    jp = jmerge(jinit(jax.random.PRNGKey(0), jcfg), ckpt[MODEL_STATE_DICT], strict=True)
    for name, p in module.named_parameters():
        np.testing.assert_array_equal(_flatten(jp)[name.replace(".", "|")],
                                      p.detach().numpy(), err_msg=name)

    jopt, _ = joptim.make_optimizer(ADAMW, 4)
    jstate = jrestore(jopt.init(jp), ckpt["__opt_leaves__"])
    adam = jstate[1][0]
    assert int(adam.count) == 7 and int(jstate[1][2].count) == 7
    for key in ("mu", "nu"):
        flat = _flatten(getattr(adam, key))
        for name, t in state[key].items():
            np.testing.assert_allclose(flat[name.replace(".", "|")], t.numpy(), rtol=0,
                                       atol=1e-7, err_msg=f"{key} {name}")


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
def test_jax_checkpoint_restores_in_port(tmp_path, name):
    from vtamiq_tpu.models.checkpoint import save_checkpoint as jsave
    from vtamiq_tpu.train import optim as joptim
    from vtamiq_tpu_torch.models.checkpoint import OPT_LEAVES, restore_opt_state
    from vtamiq_tpu_torch.train import optim
    conf = dict(ADAMW, optimizer=name)
    jcfg = JVTAMIQConfig(vit=jget_vit_config(**SMALL_VIT), **SMALL_HEAD)
    jp = jinit(jax.random.PRNGKey(4), jcfg)
    jopt, _ = joptim.make_optimizer(conf, 4)
    jstate = jopt.init(jp)
    # two real updates, so every moment and both counts are filled in
    for i in range(2):
        grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.01 * (i + 1)), jp)
        updates, jstate = jopt.update(grads, jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)
    jsave(str(tmp_path), "j.npz", {MODEL_STATE_DICT: jp}, 2, 0.7, opt_state=jstate)

    ckpt = load_checkpoint(str(tmp_path / "j.npz"))
    module = _small_module(0)
    merge_params(module, params_from_jax(ckpt[MODEL_STATE_DICT]), strict=True)
    opt, _ = optim.make_optimizer(conf, 4)
    state = restore_opt_state(opt.init({n: p.detach() for n, p in module.named_parameters()}),
                              ckpt[OPT_LEAVES])
    assert state["count"] == 2
    jleaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    for path, leaf in jleaves:
        keys = [getattr(k, "key", None) for k in path]
        field = next((getattr(k, "name", None) for k in path
                      if getattr(k, "name", None) in ("mu", "nu", "trace")), None)
        if field is None:
            assert int(leaf) == 2
            continue
        pname = ".".join(k for k in keys if isinstance(k, str))
        np.testing.assert_allclose(state[field][pname].numpy(), np.asarray(leaf), rtol=0,
                                   atol=1e-7, err_msg=f"{field} {pname}")
    for n, p in module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _flatten(jp)[n.replace(".", "|")])
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_opt_state(opt.init({n: p.detach() for n, p in module.named_parameters()}),
                          ckpt[OPT_LEAVES][:-1])


def test_pretraining_gates_and_param_table():
    from vtamiq_tpu.models.checkpoint import apply_pretraining_gates as jgates
    from vtamiq_tpu.models.utils import parameter_table as jtable, vtamiq_flops as jflops
    from vtamiq_tpu_torch.models.checkpoint import apply_pretraining_gates, params_to_jax
    from vtamiq_tpu_torch.models.utils import parameter_table, vtamiq_flops
    module = _small_module(1)
    flat = params_to_jax(module)
    jcfg = JVTAMIQConfig(vit=jget_vit_config(**SMALL_VIT), **SMALL_HEAD)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    for allow_vit in (True, False):
        for allow_diffnet in (True, False):
            got = apply_pretraining_gates(flat, allow_vit, allow_diffnet)
            want = _flatten(jgates(jp, allow_vit, allow_diffnet))
            assert sorted(got) == sorted(want)
    assert parameter_table(module) == jtable(jp)
    assert vtamiq_flops(module.cfg, 500) == jflops(jcfg, 500)
