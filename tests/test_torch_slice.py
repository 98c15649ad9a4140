"""The port's whole scoring slice against the JAX package, and the scorer's
glue on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtamiq_tpu.models.checkpoint import MODEL_STATE_DICT, _flatten, save_checkpoint
from vtamiq_tpu.models.configs import VTAMIQConfig as JVTAMIQConfig
from vtamiq_tpu.models.configs import get_vit_config as jget_vit_config
from vtamiq_tpu.models.vtamiq import init_vtamiq_params as jinit, vtamiq_forward as jforward
from vtamiq_tpu.ops import attention as jattention
from vtamiq_tpu.ops import sampling as js
from vtamiq_tpu.train.steps import ExtractConfig as JExtractConfig
from vtamiq_tpu.train.steps import make_extract_fn as jmake_extract_fn
from vtamiq_tpu_torch.inference import VTAMIQScorer, preference_from_scores
from vtamiq_tpu_torch.models.checkpoint import params_from_jax
from vtamiq_tpu_torch.models.configs import VTAMIQConfig, get_vit_config
from vtamiq_tpu_torch.models.vtamiq import VTAMIQ, vtamiq_forward
from vtamiq_tpu_torch.ops import attention as tattention
from vtamiq_tpu_torch.ops import gather_kernel
from vtamiq_tpu_torch.ops.extraction import get_iqa_patches
from vtamiq_tpu_torch.ops.sampling import PatchSampler

VIT_KW = dict(num_keep_layers=2, num_extra_tokens=2, hidden_size=64, mlp_dim=128, num_heads=4)
HEAD_KW = dict(num_rgs=1, num_rcabs=2, ca_reduction=4)
CFG = VTAMIQConfig(vit=get_vit_config(**VIT_KW), **HEAD_KW)
JCFG = JVTAMIQConfig(vit=jget_vit_config(**VIT_KW), **HEAD_KW)
H, W, N = 64, 96, 24
NORM = (0.5, 0.5, 0.5)


def pair(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    dist = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    return ref, dist


def scorer(**kw):
    return VTAMIQScorer(cfg=CFG, patch_count=N, device="cpu",
                        compute_dtype=kw.pop("compute_dtype", torch.float32), **kw)


def jax_corners(key, num_scales):
    """Corners JAX's extraction draws for one item from ``key`` (aligned
    patches: shared by both towers), per sampled scale as (2, 2, N_s)."""
    budget = js.compute_num_patches_per_scale(N, js.compute_patch_num_scales(num_scales, H, W, 16))
    h, w, out, total = H, W, [], 0
    for scale in range(len(budget)):
        n_s = int(budget[-scale - 1])
        key, *sub = jax.random.split(key, 3)
        if n_s > 0:
            c = np.asarray(js.PatchSampler().sample(sub[0], h, w, 16, n_s))
            out.append(np.stack([c, c]))
            total += n_s
        if N <= total:
            break
        h, w = h // 2, w // 2
    return out


@pytest.mark.parametrize("num_scales", [1, 3])
def test_raw_images_to_q_matches_jax(num_scales):
    """Raw (B, 2, H, W, 3) images -> normalize-fused gather -> embed ->
    encoder -> head -> q, both packages, same corners, fp32."""
    b = 3
    raw = np.stack([np.stack(pair(s)) for s in range(b)])
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    tp = VTAMIQ(CFG)
    tp.load_state_dict(params_from_jax(_flatten(jp)), strict=True)

    key = jax.random.PRNGKey(42)
    jextract = jmake_extract_fn(js.PatchSampler(), JExtractConfig(
        patch_count=N, patch_num_scales=num_scales, gather_dtype="float32"))
    jpatches, jpos, jscales = jextract(jnp.asarray(raw), key)
    want = np.asarray(jforward(jp, JCFG, jpatches, jpos, jscales, compute_dtype=jnp.float32))

    item_keys = jax.random.split(key, b)
    per_item = [jax_corners(item_keys[i], num_scales) for i in range(b)]
    topleft = [torch.from_numpy(np.stack([c[s] for c in per_item])) for s in range(len(per_item[0]))]
    patches, pos, scales = get_iqa_patches(
        torch.from_numpy(raw), torch.Generator(), N, 16, PatchSampler(), num_scales,
        tile_norm=(NORM, NORM, torch.float32), topleft=topleft)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))
    with torch.no_grad():
        got = vtamiq_forward(tp, CFG, patches, pos, scales, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_groups_by_size_in_order():
    """Pairs group by scoring shape; groups draw from the generator in the
    order they first appear, so scoring [A1, B, A2] equals scoring [A1, A2]
    then [B] with the same seed."""
    a1, a2, bb = pair(0), pair(1), pair(2, 48, 80)
    s1, s2 = scorer(seed=4), scorer(seed=4)
    got = s1.score_batch([a1[0], bb[0], a2[0]], [a1[1], bb[1], a2[1]])
    qa = s2.score_batch([a1[0], a2[0]], [a1[1], a2[1]])
    qb = s2.score_batch([bb[0]], [bb[1]])
    np.testing.assert_array_equal(got, [qa[0], qb[0], qa[1]])


def test_exact_bucket_matches_exact_path():
    ref, dist = pair(5)
    q1 = scorer(seed=9).score_pair(ref, dist)
    q2 = scorer(seed=9, size_buckets=[(H, W), (128, 128)]).score_pair(ref, dist)
    assert q1 == q2


def test_buckets_pad_and_confine_to_true_size():
    s = scorer(seed=3, size_buckets=[(H, W)])
    assert s.executable_key(50, 70) == (H, W)
    assert s.executable_key(H + 1, W) == (H + 1, W)  # larger than every bucket
    refs, dists = zip(pair(0, 50, 70), pair(1, H, W), pair(2, 41, 96))
    qs = s.score_batch(list(refs), list(dists))
    assert qs.shape == (3,) and np.isfinite(qs).all()


def test_num_repeats_averages_draws():
    ref, dist = pair(6)
    q3 = scorer(seed=2, num_repeats=3).score_pair(ref, dist)
    one = scorer(seed=2)
    singles = [one.score_pair(ref, dist) for _ in range(3)]
    assert len(set(singles)) == 3
    assert q3 == pytest.approx(np.mean(singles), abs=1e-12)


def test_ingest_uint8_matches_fp32_on_8bit_images():
    rng = np.random.default_rng(5)
    ref8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    dist8 = np.clip(ref8.astype(np.int16) + rng.integers(-20, 21, ref8.shape), 0, 255
                    ).astype(np.uint8)
    q_f = scorer(seed=11).score_pair(ref8.astype(np.float32) / 255, dist8.astype(np.float32) / 255)
    q_u = scorer(seed=11, ingest_uint8=True).score_pair(ref8, dist8)
    q_u2 = scorer(seed=11, ingest_uint8=True).score_pair(ref8.astype(np.float32) / 255,
                                                         dist8.astype(np.float32) / 255)
    assert q_u == q_u2  # the same uint8 payload either way
    assert abs(q_f - q_u) <= 1e-5  # x / 255 on the host vs x * (1/255) on the device


def test_compare_is_sigmoid_of_score_difference():
    ref, dist = pair(0)
    p = scorer(seed=42).compare(ref, ref, dist)
    qs = scorer(seed=42).score_batch([ref, ref], [ref, dist])
    assert p == pytest.approx(1 / (1 + np.exp(-(qs[0] - qs[1]))), abs=1e-12)
    assert p == preference_from_scores(qs[0], qs[1])


def test_bf16_scorer_tracks_fp32():
    ref, dist = pair(7)
    q32 = scorer(seed=1).score_batch([ref, ref], [dist, ref])
    q16 = scorer(seed=1, compute_dtype=torch.bfloat16).score_batch([ref, ref], [dist, ref])
    assert q16[1] == 0.0 and q32[1] == 0.0  # identical towers cancel exactly
    assert abs(q16[0] - q32[0]) <= 5e-2 * max(1.0, abs(q32[0]))


def test_from_checkpoint(tmp_path):
    jp = jinit(jax.random.PRNGKey(1), JCFG)
    save_checkpoint(str(tmp_path), "best.npz", {MODEL_STATE_DICT: jp}, epoch=3, srocc=0.9)
    s = VTAMIQScorer.from_checkpoint(str(tmp_path / "best.npz"), cfg=CFG, patch_count=N,
                                     device="cpu")
    np.testing.assert_array_equal(s.params.q_predictor.fc1.kernel.detach().numpy(),
                                  np.asarray(jp["q_predictor"]["fc1"]["kernel"]))


def test_from_checkpoint_refuses_files_that_do_not_match(tmp_path):
    save_checkpoint(str(tmp_path), "empty.npz", {}, epoch=0, srocc=0.0)
    with pytest.raises(ValueError, match="no 'model_state_dict'"):
        VTAMIQScorer.from_checkpoint(str(tmp_path / "empty.npz"), cfg=CFG, device="cpu")
    bogus = {"vit": {"bogus": np.zeros((3, 3), np.float32)}}
    save_checkpoint(str(tmp_path), "bogus.npz", {MODEL_STATE_DICT: bogus}, epoch=0, srocc=0.0)
    with pytest.raises(ValueError, match="no checkpoint leaf matched"):
        VTAMIQScorer.from_checkpoint(str(tmp_path / "bogus.npz"), cfg=CFG, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VTAMIQScorer(cfg=CFG)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="quantize_int8"):
        VTAMIQScorer(cfg=CFG, device="cpu", quantize_int8=True)
    with pytest.raises(NotImplementedError, match="ViT npz"):
        VTAMIQScorer.from_vit_npz("missing.npz", cfg=CFG, device="cpu")


def test_cpu_scoring_launches_no_kernel():
    before = gather_kernel.launches
    scorer(seed=0).score_pair(*pair(0))
    assert gather_kernel.launches == before


@pytest.mark.parametrize("count,train,batch", [
    (500, False, 8), (500, True, None), (2047, False, None), (2048, False, None),
    (2048, True, 2), (5000, False, 2), (5000, False, 4), (5000, False, 64)])
def test_attention_policy_follows_jax(count, train, batch):
    """The port returns its flash attention function wherever the JAX
    package returns its own, and None (plain attention) wherever JAX does."""
    want = jattention.choose_attention_fn(count, train=train, batch_pairs=batch)
    got = tattention.choose_attention_fn(count, train=train, batch_pairs=batch)
    assert (got is None) == (want is None)
    assert got is None or callable(got)


def test_scorer_past_the_threshold_takes_flash_and_matches_jax(monkeypatch):
    """2048 patches: with the quadratic budget set to 0 the scorer's policy
    takes flash attention (the JAX package's choice for batches whose logits
    do not fit); q held against the JAX forward with JAX's flash attention
    function on the same patches, fp32, 1e-5."""
    n, seed = 2048, 3
    jp = jinit(jax.random.PRNGKey(2), JCFG)
    tp = VTAMIQ(CFG)
    tp.load_state_dict(params_from_jax(_flatten(jp)), strict=True)
    calls = []
    flash = tattention.flash_attention
    monkeypatch.setattr(tattention, "QUAD_INFER_LOGITS_BUDGET", 0)
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or flash(*a, **kw))
    s = VTAMIQScorer(cfg=CFG, params=tp, patch_count=n, device="cpu",
                     compute_dtype=torch.float32, seed=seed)
    refs, dists = zip(pair(0), pair(1))
    got = s.score_batch(list(refs), list(dists))
    assert calls == [(4, n + CFG.vit.num_tokens, 4, 16)]  # every layer but the last

    raw = torch.from_numpy(np.stack([np.stack(p) for p in zip(refs, dists)]))
    patches, pos, scales = s._extract(raw, torch.Generator().manual_seed(seed))
    want = jforward(jp, JCFG, jnp.asarray(patches.numpy()), jnp.asarray(pos.numpy()),
                    None if scales is None else jnp.asarray(scales.numpy()),
                    compute_dtype=jnp.float32, attention_fn=jattention.make_attention_fn())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
