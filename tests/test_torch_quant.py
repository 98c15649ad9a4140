"""The port's int8 W8A8 serving path (``vtamiq_tpu_torch/ops/quant.py``)
against the JAX package's (``vtamiq_tpu/ops/quant.py``) on the CPU.

Weights come from JAX's initializer and reach the port through
``params_from_jax``; inputs are numpy draws from fixed seeds. The port's
quantized kernels equal JAX's bit for bit and its int32 product is exact.
Through a whole forward, fp32 rounding upstream of a dense layer (LayerNorm,
GELU, softmax, sums in another order) can move an activation across a
rounding midpoint of its per-row quant, so one int8 activation flips by one
step; the forwards are compared with that in mind (see each test).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vtamiq_tpu.ops.quant as jq
from vtamiq_tpu.inference import VTAMIQScorer as JScorer
from vtamiq_tpu.models.checkpoint import MODEL_STATE_DICT, _flatten, save_checkpoint
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vit import vit_forward as jvit_forward
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit
from vtamiq_tpu.models.vtamiq import vtamiq_forward as jforward
from vtamiq_tpu_torch.inference import VTAMIQScorer
from vtamiq_tpu_torch.models.checkpoint import params_from_jax, params_to_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vit import Dense, QuantDense, dense, vit_forward
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, vtamiq_forward
from vtamiq_tpu_torch.ops import attention as tattention
from vtamiq_tpu_torch.ops import quant as tq

VIT_KW = dict(num_keep_layers=2, num_extra_tokens=8, hidden_size=64, mlp_dim=128, num_heads=4)
HEAD_KW = dict(num_rgs=2, num_rcabs=2, ca_reduction=8)
CFG = VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW)
JCFG = JVTAMIQConfig(vit=jget_vit_config(**VIT_KW), **HEAD_KW)
# 2 layers x (q, k, v, out, fc1, fc2) + the patch embed at hidden 64
N_QUANTIZED = 13


def dense_leaf(rng, d_in, d_out):
    k = (rng.normal(size=(d_in, d_out)) * 0.05).astype(np.float32)
    b = (rng.normal(size=d_out) * 0.01).astype(np.float32)
    d = Dense(d_in, d_out)
    with torch.no_grad():
        d.kernel.copy_(torch.from_numpy(k))
        d.bias.copy_(torch.from_numpy(b))
    return {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, d


def port_model(jparams):
    model = VTAMIQ(CFG)
    model.load_state_dict(params_from_jax(_flatten(jparams)), strict=True)
    return model.eval()


def jax_quantized_encoder(jparams):
    return {**jparams, "vit": jq.quantize_params_int8(jparams["vit"])}


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (768, 768), (768, 3072), (3072, 768)])
def test_quantize_dense_params_matches_jax(d_in, d_out):
    jp, tp = dense_leaf(np.random.default_rng(d_in + d_out), d_in, d_out)
    want = jq.quantize_dense_params(jp)
    got = tq.quantize_dense_params(tp)
    assert got.kernel_q8.dtype == torch.int8 and got.kernel_q8.shape == (d_in, d_out)
    np.testing.assert_array_equal(got.kernel_q8.numpy(), np.asarray(want["kernel_q8"]))
    np.testing.assert_allclose(got.kernel_scale.numpy(), np.asarray(want["kernel_scale"]),
                               rtol=1e-7, atol=0)
    # stored column-major, the layout cuBLASLt's int8 product takes
    assert got.kernel_q8.t().is_contiguous()
    assert torch.equal(got.bias, tp.bias.detach())
    # every column's largest weight maps to +-127
    assert torch.all(got.kernel_q8.abs().amax(0) == 127)


def test_round_half_to_even_as_jnp_round():
    """Quant steps exactly at .5 round to even in both packages."""
    k = np.array([[0.5, 1.5], [2.5, -0.5], [-1.5, 127.0], [63.5, -127.0]], np.float32)
    k = np.repeat(k, 16, axis=0)  # 64 x 2
    d = Dense(64, 2)
    with torch.no_grad():
        d.kernel.copy_(torch.from_numpy(k))
        d.bias.zero_()
    got = tq.quantize_dense_params(d).kernel_q8.numpy()
    want = np.asarray(jq.quantize_dense_params({"kernel": jnp.asarray(k),
                                                "bias": jnp.zeros(2)})["kernel_q8"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,d_in,d_out", [((32, 768), 768, 768), ((2, 3, 5, 64), 64, 96),
                                              ((4, 9, 768), 768, 3072)])
def test_dense_q8_matches_jax(shape, d_in, d_out):
    """The int32 product exact; the output to 1e-6 in fp32 (bit-equal to
    JAX's op-by-op dense_q8 in practice)."""
    rng = np.random.default_rng(d_out)
    jp, tp = dense_leaf(rng, d_in, d_out)
    qp = tq.quantize_dense_params(tp)
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jq.dense_q8(jq.quantize_dense_params(jp), jnp.asarray(x)))
    got = tq.dense_q8(qp, torch.from_numpy(x))
    assert got.shape == shape[:-1] + (d_out,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the product alone, against an int64 numpy product
    xf = x.reshape(-1, d_in)
    amax = np.maximum(np.abs(xf).max(-1, keepdims=True), np.float32(1e-12))
    xq = np.round(xf * (np.float32(127.0) / amax)).astype(np.int8)
    y32 = tq.int8_matmul(torch.from_numpy(xq), qp.kernel_q8)
    assert y32.dtype == torch.int32
    np.testing.assert_array_equal(y32.numpy(), xq.astype(np.int64) @ qp.kernel_q8.numpy()
                                  .astype(np.int64))
    # dense() dispatches on the holder, and out_dtype sets the result type
    assert torch.equal(dense(qp, torch.from_numpy(x)), got)
    y16 = dense(qp, torch.from_numpy(x), torch.float32, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, got.to(torch.bfloat16))


def test_int8_matmul_plain_is_exact_at_the_extremes():
    """The largest sums of the encoder (K = 3072, all +-127) stay exact."""
    a = torch.full((3, 3072), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((3072, 8), 127, dtype=torch.int8)
    b[:, 1] = -127
    y = tq.int8_matmul(a, b)
    assert y[0, 0] == 3072 * 127 * 127 and y[1, 0] == -3072 * 127 * 127 \
        and y[0, 1] == -3072 * 127 * 127
    with pytest.raises(ValueError, match="int8"):
        tq.int8_matmul(a.float(), b)


def test_tree_rewrite_matches_jax():
    """The same leaves quantized as JAX's (the skip rule and the count),
    idempotent, the input left as it was, the rest shared."""
    jparams = jinit(jax.random.PRNGKey(0), JCFG)
    model = port_model(jparams)
    jvit = jq.quantize_params_int8(jparams["vit"])
    qvit = tq.quantize_params_int8(model.vit)
    assert tq.count_quantized_leaves(qvit) == jq.count_quantized_leaves(jvit) == N_QUANTIZED
    jflat, tflat = _flatten(jvit), params_to_jax(qvit)
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        if k.endswith("kernel_q8"):
            np.testing.assert_array_equal(tflat[k], np.asarray(v), err_msg=k)
    assert tq.count_quantized_leaves(model) == 0  # input not rewritten
    assert qvit.embeddings.pos_embeddings is model.vit.embeddings.pos_embeddings
    twice = tq.quantize_params_int8(qvit)
    assert tq.count_quantized_leaves(twice) == N_QUANTIZED
    assert twice.encoder.layers.layer_0.mlp.fc1 is qvit.encoder.layers.layer_0.mlp.fc1
    # a whole VTAMIQ tree: the head's narrow denses stay as they are, as in JAX
    jall = jq.quantize_params_int8(jparams)
    tall = tq.quantize_params_int8(model)
    assert tq.count_quantized_leaves(tall) == jq.count_quantized_leaves(jall)
    assert sorted(params_to_jax(tall)) == sorted(_flatten(jall))


def test_skip_rule_on_narrow_leaves():
    rng = np.random.default_rng(5)
    holder = torch.nn.ModuleDict({
        "big": dense_leaf(rng, tq.MIN_QUANT_DIM, tq.MIN_QUANT_DIM)[1],
        "narrow": dense_leaf(rng, 256, tq.MIN_QUANT_DIM - 1)[1],
        "nested": torch.nn.ModuleDict({"inner": dense_leaf(rng, 128, 128)[1]})})
    out = tq.quantize_params_int8(holder)
    assert tq.count_quantized_leaves(out) == 2
    assert isinstance(out["narrow"], Dense) and out["narrow"] is holder["narrow"]
    assert isinstance(out["big"], QuantDense) and isinstance(out["nested"]["inner"], QuantDense)
    assert tq.count_quantized_leaves(holder) == 0


class _Recorder:
    """Wraps a package's dense_q8 and records each call's int8 activations."""

    def __init__(self, module, name, to_numpy):
        self.module, self.name, self.to_numpy = module, name, to_numpy
        self.orig = getattr(module, name)
        self.xq = []

    def __call__(self, p, x, dtype=None):
        xf = self.to_numpy(x).astype(np.float32)
        amax = np.maximum(np.abs(xf).max(-1, keepdims=True), np.float32(1e-12))
        self.xq.append(np.round(xf * (np.float32(127.0) / amax)).astype(np.int32))
        return self.orig(p, x, dtype)


def _flips(monkeypatch, run_jax, run_port):
    """Run both forwards, recording the int8 activations of every dense
    call; return the two outputs and the number of activations that differ
    (each by one step)."""
    jrec = _Recorder(jq, "dense_q8", np.asarray)
    trec = _Recorder(tq, "dense_q8", lambda t: t.detach().numpy())
    monkeypatch.setattr(jq, "dense_q8", jrec)
    monkeypatch.setattr(tq, "dense_q8", trec)
    want, got = run_jax(), run_port()
    assert len(jrec.xq) == len(trec.xq) > 0
    # JAX pads the token axis to 128 (TPU lanes), the port does not: compare
    # the port's rows
    diffs = [np.abs(a[tuple(slice(0, n) for n in b.shape)] - b)
             for a, b in zip(jrec.xq, trec.xq)]
    assert max(d.max() for d in diffs) <= 1  # a flip is one quant step
    return want, got, sum(int(d.sum()) for d in diffs), sum(d.size for d in diffs)


def test_quantized_vit_forward_matches_jax(monkeypatch):
    """JAX's int8 encoder carried by ``params_from_jax`` against JAX's, fp32.
    On these draws 0 of 59,136 int8 activations flipped and the tokens agree
    to 7.2e-7; up to 4 flips and 1e-4 are allowed (one step of a row with
    amax ~1 moves an output by about |w| amax / 127)."""
    rng = np.random.default_rng(7)
    jparams = jinit(jax.random.PRNGKey(0), JCFG)
    jvit = jq.quantize_params_int8(jparams["vit"])
    tvit = params_from_jax(_flatten(jvit), port_model(jparams).vit)
    assert tq.count_quantized_leaves(tvit) == N_QUANTIZED
    patches = rng.normal(size=(2, 16, 16, 16, 3)).astype(np.float32)
    pos = rng.uniform(0, 1 - 1e-6, size=(2, 16, 2)).astype(np.float32)
    with torch.no_grad():
        want, got, flips, total = _flips(
            monkeypatch,
            lambda: np.asarray(jvit_forward(jvit, JCFG.vit, jnp.asarray(patches), jnp.asarray(pos),
                                            compute_dtype=jnp.float32)),
            lambda: vit_forward(tvit, CFG.vit, torch.from_numpy(patches), torch.from_numpy(pos),
                                compute_dtype=torch.float32).numpy())
    assert flips <= 4, (flips, total)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the quantized encoder still tracks the fp32 one (tests/test_quant.py's gate)
    with torch.no_grad():
        f = vit_forward(port_model(jparams).vit, CFG.vit, torch.from_numpy(patches),
                        torch.from_numpy(pos), compute_dtype=torch.float32).numpy()
    cos = float(np.sum(f * got) / (np.linalg.norm(f) * np.linalg.norm(got)))
    assert cos > 0.995, cos


def test_quantized_vtamiq_forward_matches_jax(monkeypatch):
    """The two-tower model with its encoder quantized, the port's own
    rewrite of the same weights against JAX's, fp32: q to 1e-5 of the
    score spread, up to 4 flips (0 of 236,544 int8 activations flipped on
    these draws, and q agreed to 2.4e-6)."""
    rng = np.random.default_rng(8)
    jparams = jinit(jax.random.PRNGKey(1), JCFG)
    jqp = jax_quantized_encoder(jparams)
    model = port_model(jparams)
    tqp = tq.with_child(model, "vit", tq.quantize_params_int8(model.vit))
    patches = rng.normal(size=(4, 2, 16, 16, 16, 3)).astype(np.float32)
    pos = rng.uniform(0, 1 - 1e-6, size=(4, 2, 16, 2)).astype(np.float32)
    with torch.no_grad():
        want, got, flips, total = _flips(
            monkeypatch,
            lambda: np.asarray(jforward(jqp, JCFG, jnp.asarray(patches), jnp.asarray(pos),
                                        compute_dtype=jnp.float32)),
            lambda: vtamiq_forward(tqp, CFG, torch.from_numpy(patches), torch.from_numpy(pos),
                                   compute_dtype=torch.float32).numpy())
    assert flips <= 4, (flips, total)
    spread = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * spread)
    assert tq.count_quantized_leaves(model) == 0


def test_quantized_flash_path_matches_quadratic():
    """The flash attention path (the scorer's choice at 5000 patches; its
    plain version on the CPU) takes the int8 denses too."""
    rng = np.random.default_rng(9)
    model = port_model(jinit(jax.random.PRNGKey(2), JCFG))
    qmodel = tq.with_child(model, "vit", tq.quantize_params_int8(model.vit))
    patches = torch.from_numpy(rng.normal(size=(2, 2, 40, 16, 16, 3)).astype(np.float32))
    pos = torch.from_numpy(rng.uniform(0, 1 - 1e-6, size=(2, 2, 40, 2)).astype(np.float32))
    flash = tattention.make_attention_fn(threshold=0)
    with torch.no_grad():
        quad = vtamiq_forward(qmodel, CFG, patches, pos, compute_dtype=torch.float32)
        got = vtamiq_forward(qmodel, CFG, patches, pos, compute_dtype=torch.float32,
                             attention_fn=flash)
    np.testing.assert_allclose(got.numpy(), quad.numpy(), rtol=0, atol=1e-4)


def _record_jax_patches(monkeypatch, queue):
    """JAX's scorer, recording the patches its jitted pipeline draws."""
    import vtamiq_tpu.inference as jinference
    orig = jinference.make_extract_fn

    def make_extract_fn(sampler, ecfg):
        extract = orig(sampler, ecfg)

        def recording(imgs_raw, key, img_hw=None):
            out = extract(imgs_raw, key, img_hw)
            jax.debug.callback(lambda *a: queue.append([np.array(x) for x in a]),
                               out[0], out[1], ordered=True)
            return out
        return recording

    monkeypatch.setattr(jinference, "make_extract_fn", make_extract_fn)


@pytest.mark.parametrize("ingest_uint8", [False, True])
def test_scorer_quantizes_lazily_and_matches_jax(monkeypatch, tmp_path, ingest_uint8):
    """``quantize_int8`` rewrites the encoder at the first score, after the
    checkpoint merged, and leaves the module it was given as it was; on
    JAX's patches the port's int8 scorer (bf16, as JAX's scorer computes)
    gives JAX's int8 scores to 3% of their spread (1.5% seen: bf16 rounds
    at other places in the two packages, and a bf16 ulp can move a quant
    step)."""
    rng = np.random.default_rng(10)
    imgs = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(8)]
    jparams = jinit(jax.random.PRNGKey(3), JCFG)
    save_checkpoint(str(tmp_path), "best.npz", {MODEL_STATE_DICT: jparams}, 1, 0.5)
    path = str(tmp_path / "best.npz")
    jscorer = JScorer.from_checkpoint(path, cfg=JCFG, patch_count=16, seed=3,
                                      quantize_int8=True, ingest_uint8=ingest_uint8)
    scorer = VTAMIQScorer.from_checkpoint(path, cfg=CFG, patch_count=16, seed=3, device="cpu",
                                          quantize_int8=True, ingest_uint8=ingest_uint8)
    given = scorer.params
    assert tq.count_quantized_leaves(scorer.params) == 0  # lazy
    queue = []
    _record_jax_patches(monkeypatch, queue)
    want = jscorer.score_batch(imgs[:4], imgs[4:])
    patches, pos = queue.pop()
    monkeypatch.setattr(scorer, "_extract", lambda x, g, hw=None: (
        torch.from_numpy(patches.astype(np.float32)).to(torch.bfloat16), torch.from_numpy(pos), None))
    got = scorer.score_batch(imgs[:4], imgs[4:])
    assert tq.count_quantized_leaves(scorer.params.vit) == \
        jq.count_quantized_leaves(jscorer.params["vit"]) == N_QUANTIZED
    assert tq.count_quantized_leaves(given) == 0 and scorer.params is not given
    # the merged weights are the ones quantized
    np.testing.assert_array_equal(
        scorer.params.vit.encoder.layers.layer_1.mlp.fc2.kernel_q8.numpy(),
        np.asarray(jscorer.params["vit"]["encoder"]["layers"]["layer_1"]["mlp"]["fc2"]
                   ["kernel_q8"]))
    spread = float(np.max(want) - np.min(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03 * spread)
    # a second score, on the port's own draws, does not quantize again
    monkeypatch.undo()
    qvit = scorer.params.vit
    assert np.isfinite(scorer.score_batch(imgs[:1], imgs[4:5])).all()
    assert scorer.params.vit is qvit


def test_jax_quantized_tree_loads_through_params_from_jax():
    jparams = jinit(jax.random.PRNGKey(4), JCFG)
    jqp = jax_quantized_encoder(jparams)
    flat = _flatten(jqp)
    sd = params_from_jax(flat)
    key = "vit.encoder.layers.layer_0.attn.query."
    assert sd[key + "kernel_q8"].dtype == torch.int8 \
        and sd[key + "kernel_scale"].dtype == torch.float32
    model = VTAMIQ(CFG)
    loaded = params_from_jax(flat, model)
    assert isinstance(loaded.vit.encoder.layers.layer_0.attn.query, QuantDense)
    assert tq.count_quantized_leaves(loaded) == jq.count_quantized_leaves(jqp)
    assert tq.count_quantized_leaves(model) == 0
    back = params_to_jax(loaded)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    # the same model quantized by the port holds the same int8 leaves
    ours = params_to_jax(tq.quantize_params_int8(port_model(jparams).vit))
    for k, v in flat.items():
        if k.startswith("vit|"):
            np.testing.assert_array_equal(ours[k[len("vit|"):]], np.asarray(v), err_msg=k)

