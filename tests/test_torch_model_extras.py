"""The model's extras against the JAX package's on the CPU, fp32: Houlsby
adapters (forward and gradients, the freeze mask's adapter flag), encoder
remat, the introspection outputs (``return_attention``, ``return_layers``),
``pre_embedded``, ``pad_seq_to`` and ``vtamiq_forward_single_tower``.

Tolerances: 1e-5 absolute on forward values, and on gradients 1e-5 of
each tensor's largest (at least 1), fp32 on both sides with sums in other
orders. Remat is held to the run without it bit
for bit (torch.equal): the same operations run in the same order, and the
DropPath masks are drawn once, before each layer."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models import vit as jvit
from vtamiq_tpu.models import vtamiq as jvtamiq
from vtamiq_tpu.models.checkpoint import _flatten
from vtamiq_tpu.train import optim as joptim
from vtamiq_tpu_torch.models import vit as tvit
from vtamiq_tpu_torch.models import vtamiq as tvtamiq
from vtamiq_tpu_torch.train import optim
from test_torch_model import N, carried, configs, inputs, t

TOL = 1e-5


def _adapter_models(num_adapters=2, seed=0):
    jcfg, tcfg = configs(num_adapters=num_adapters)
    jp = jvtamiq.init_vtamiq_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, carried(jp, tvtamiq.VTAMIQ(tcfg))


def test_adapter_parameters_follow_the_jax_pytree():
    jcfg, tcfg, jp, tp = _adapter_models()
    names = {n.replace(".", "|") for n, _ in tp.named_parameters()}
    assert names == set(_flatten(jp))
    assert "vit|encoder|layers|layer_1|adapters|adapter_1|mlp|up|kernel" in names
    assert tuple(tp.vit.encoder.layers.layer_0.adapters.adapter_0.attn.down.kernel.shape) == \
        (64, 16)  # reduction 4


@pytest.mark.parametrize("adapter_num", [None, 1, -1])
def test_adapters_forward_and_gradients_match_jax(adapter_num):
    """None selects adapter 0 (the ViT has adapters), -1 runs none."""
    jcfg, tcfg, jp, tp = _adapter_models()
    # non-zero up projections, so the adapters change the tokens
    rng = np.random.default_rng(5)
    for i in range(2):
        for a in range(2):
            for branch in ("attn", "mlp"):
                up = jp["vit"]["encoder"]["layers"][f"layer_{i}"]["adapters"][f"adapter_{a}"][
                    branch]["up"]
                up["bias"] = jnp.asarray(rng.normal(0, 0.1, up["bias"].shape), jnp.float32)
    tp = carried(jp, tvtamiq.VTAMIQ(tcfg))
    patches, pos, mask, _ = inputs(3)

    def jloss(params):
        q = jvtamiq.vtamiq_forward(params, jcfg, jnp.asarray(patches), jnp.asarray(pos),
                                   patch_mask=jnp.asarray(mask), compute_dtype=jnp.float32,
                                   adapter_num=adapter_num)
        return jnp.sum(q * jnp.asarray([1.0, -2.0])), q

    (_, jq), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    q = tvtamiq.vtamiq_forward(tp, tcfg, t(patches), t(pos), patch_mask=t(mask),
                               compute_dtype=torch.float32, adapter_num=adapter_num)
    (q * torch.tensor([1.0, -2.0])).sum().backward()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=0, atol=TOL)
    jflat = _flatten(jgrads)
    for name, p in tp.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        want = jflat[name.replace(".", "|")]
        # to 1e-5 of the tensor's largest gradient (the CLS token's reach 70)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=0, atol=TOL * scale, err_msg=name)
    used = 0 if adapter_num is None else adapter_num
    grad_of = lambda a: tp.vit.encoder.layers.layer_0.adapters[f"adapter_{a}"].attn.up.bias.grad
    for a in range(2):
        assert (grad_of(a) is not None and bool(grad_of(a).abs().sum() > 0)) == (a == used)


@pytest.mark.parametrize("freeze_adapters", [False, True])
def test_freeze_mask_with_adapters_matches_jax(freeze_adapters):
    _, _, jp, tp = _adapter_models()
    fd = {"freeze_dict_vit": {"freeze_encoder_adapters": freeze_adapters}}
    want = {k: float(v) for k, v in _flatten(joptim.build_freeze_mask(jp, True, fd)).items()}
    got = optim.build_freeze_mask(tp, True, fd)
    assert {k.replace(".", "|"): v for k, v in got.items()} == want
    adapters = [n for n in got if ".adapters." in n]
    assert adapters and all(got[n] == (0.0 if freeze_adapters else 1.0) for n in adapters)
    assert got["vit.encoder.layers.layer_0.attn.query.kernel"] == 0.0


@pytest.mark.parametrize("attention", ["quadratic", "flash"])
def test_remat_gradients_equal_the_plain_run_with_droppath(attention):
    """A train forward and backward with DropPath active (p = 0.5) and
    dropout in the head: remat recomputes each encoder layer in the
    backward and gives the same loss and every gradient bit for bit."""
    from vtamiq_tpu_torch.ops.attention import make_attention_fn
    _, tcfg = configs()
    vit = dataclasses.replace(tcfg.vit, path_drop_prob=0.5, vit_path_drop_active=True)
    patches, pos, mask, _ = inputs(9, n=40)
    attention_fn = make_attention_fn(threshold=0) if attention == "flash" else None
    base = tvtamiq.init_vtamiq_params(tcfg, torch.Generator().manual_seed(4))
    results = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, vit=dataclasses.replace(vit, remat=remat))
        model = tvtamiq.init_vtamiq_params(cfg, torch.Generator().manual_seed(4))
        model.load_state_dict(base.state_dict())
        gen = torch.Generator().manual_seed(11)
        q = tvtamiq.vtamiq_forward(model, cfg, t(patches), t(pos), patch_mask=t(mask),
                                   compute_dtype=torch.float32, train=True, generator=gen,
                                   attention_fn=attention_fn)
        q.sum().backward()
        results.append((q.detach(), {n: p.grad for n, p in model.named_parameters()},
                        gen.get_state()))
    (q1, g1, s1), (q2, g2, s2) = results
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    assert set(g1) == set(g2)
    for n in g1:
        assert (g1[n] is None) == (g2[n] is None), n
        assert g1[n] is None or torch.equal(g1[n], g2[n]), n
    # DropPath dropped some rows: the masks differ from the no-DropPath run
    plain = tvtamiq.vtamiq_forward(base, tcfg, t(patches), t(pos), patch_mask=t(mask),
                                   compute_dtype=torch.float32, attention_fn=attention_fn)
    assert not torch.equal(plain.detach(), q1)


@pytest.mark.parametrize("tokens_only", [True, False])
def test_return_attention_and_layers_match_jax(tokens_only):
    jcfg, tcfg = configs()
    jp = jvit.init_vit_params(jax.random.PRNGKey(2), jcfg.vit)
    tp = carried(jp, tvit.ViT(tcfg.vit))
    patches, pos, mask, _ = inputs(4)
    patches, pos, mask = patches[:, 0], pos[:, 0], mask[:, 0]
    spy_calls = []

    def spy(q, k, v, m):  # an attention_fn the introspection path must bypass
        spy_calls.append(1)
        raise AssertionError("attention_fn used with return_attention")

    jx, jattn, jlayers = jvit.vit_forward(
        jp, jcfg.vit, jnp.asarray(patches), jnp.asarray(pos), tokens_only=tokens_only,
        patch_mask=jnp.asarray(mask), compute_dtype=jnp.float32, pad_seq_to=None,
        return_attention=True, return_layers=True)
    with torch.no_grad():
        x, attn, layers = tp(t(patches), t(pos), tokens_only=tokens_only, patch_mask=t(mask),
                             compute_dtype=torch.float32, attention_fn=spy,
                             return_attention=True, return_layers=True)
    assert not spy_calls and len(attn) == len(layers) == 2
    s = 3 + N
    assert attn[-1].shape == (2, 4, s, s)  # the last layer computes every query
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    for got, want in zip(attn + layers, list(jattn) + list(jlayers)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the tokens equal the plain forward's, whose last layer slices its queries
    with torch.no_grad():
        plain = tp(t(patches), t(pos), tokens_only=tokens_only, patch_mask=t(mask),
                   compute_dtype=torch.float32)
    np.testing.assert_allclose(x.numpy(), plain.numpy(), rtol=0, atol=TOL)
    # return_layers alone keeps attention_fn (as in the JAX package)
    with torch.no_grad():
        tp(t(patches), t(pos), compute_dtype=torch.float32,
           attention_fn=lambda q, k, v, m: spy_calls.append(1) or tvit.F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2),
           return_layers=True)
    assert len(spy_calls) == 2


@pytest.mark.parametrize("pad_seq_to", [None, 8, 128])
def test_pre_embedded_and_pad_seq_to_match_jax(pad_seq_to):
    jcfg, tcfg = configs()
    jp = jvit.init_vit_params(jax.random.PRNGKey(6), jcfg.vit)
    tp = carried(jp, tvit.ViT(tcfg.vit))
    rng = np.random.default_rng(6)
    feats = rng.normal(0, 1, (2, N, 64)).astype(np.float32)
    pos = rng.uniform(0, 1, (2, N, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, N)) > 0.2
    for tokens_only in (True, False):
        want = jvit.vit_forward(jp, jcfg.vit, jnp.asarray(feats), jnp.asarray(pos),
                                tokens_only=tokens_only, patch_mask=jnp.asarray(mask),
                                compute_dtype=jnp.float32, pad_seq_to=pad_seq_to,
                                pre_embedded=True)
        with torch.no_grad():
            got = tp(t(feats), t(pos), tokens_only=tokens_only, patch_mask=t(mask),
                     compute_dtype=torch.float32, pad_seq_to=pad_seq_to, pre_embedded=True)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # padding masks its tokens: the kept tokens equal the unpadded run's
    with torch.no_grad():
        unpadded = tp(t(feats), t(pos), tokens_only=False, patch_mask=t(mask),
                      compute_dtype=torch.float32, pre_embedded=True)
    np.testing.assert_allclose(got.numpy()[:, :3 + N], unpadded.numpy(), rtol=0, atol=TOL)


def test_single_tower_forward_matches_jax():
    jcfg, tcfg, jp, tp = _adapter_models(num_adapters=1, seed=8)
    patches, pos, mask, _ = inputs(8, b=1)
    want = jvtamiq.vtamiq_forward_single_tower(jp, jcfg, jnp.asarray(patches[0]),
                                               jnp.asarray(pos[0]), compute_dtype=jnp.float32)
    with torch.no_grad():
        got = tvtamiq.vtamiq_forward_single_tower(tp, tcfg, t(patches[0]), t(pos[0]),
                                                  compute_dtype=torch.float32)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=TOL)
