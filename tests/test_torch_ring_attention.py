"""The port's ring attention (``vtamiq_tpu_torch/parallel/ring_attention.py``)
in worlds of 2 and 4 CPU processes over gloo, against the JAX package's
``make_ring_attention`` on a seq mesh of the conftest's virtual devices.

Each rank holds its rows and token chunk; the ranks' outputs and gradients
are put back together and held to JAX's at 1e-5 (output) and 1e-4
(gradients), relative to each tensor's largest magnitude: fp32 on both
sides, the port's chunks through the flash kernels' plain versions, JAX's
through its einsum chunk body, so sums run in other orders. Each world is
spawned once per file (``tests/torch_mesh_worker.py``) and runs every case.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_mesh_worker import spawn_world
from vtamiq_tpu.parallel.ring_attention import make_ring_attention, make_seq_mesh

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, H, D = 2, 2, 64

# name -> (world, data, seq, tokens, mask kind, fused backward); the split
# backward runs on the inputs of the case it shares its shapes with
RINGS = {
    "masked_n2": (2, 1, 2, 256, "tail", True),
    "plain_n2": (2, 1, 2, 192, None, True),
    "split_n2": (2, 1, 2, 256, "tail", False),
    "masked_n4": (4, 1, 4, 256, "tail", True),
    "data2_seq2": (4, 2, 2, 256, "rows", True),
    # the last rank's 64 tokens are padding alone: its chunk's lse is near
    # -1e30 and must merge without NaN
    "padding_rank_n4": (4, 1, 4, 256, "last_quarter", True),
}


SPLIT_INPUTS = {"split_n2": "masked_n2"}


def _mask(kind, tokens):
    if kind is None:
        return None
    m = np.ones((B, tokens), bool)
    if kind == "tail":
        m[:, tokens - 37:] = False
    elif kind == "rows":
        m[0, 150:] = False
        m[1, 90:] = False
    else:
        m[:, 3 * tokens // 4:] = False
    return m


def _inputs(name, tokens, mask_kind):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out = {f"{name}/{k}": rng.standard_normal((B, tokens, H, D)).astype(np.float32)
           for k in ("q", "k", "v", "g")}
    mask = _mask(mask_kind, tokens)
    if mask is not None:
        out[f"{name}/mask"] = mask
    return out


def _jax_ring(inputs, name, data, seq):
    """JAX's ring output and its (q, k, v) cotangents for the output
    cotangent g, in one jitted program."""
    attn = make_ring_attention(make_seq_mesh(seq=seq, data=data))
    mask = inputs.get(f"{name}/mask")

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: attn(q, k, v, mask), q, k, v)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(inputs[f"{name}/{x}"]) for x in "qkvg"))
    return {"out": np.asarray(out), **{f"d{x}": np.asarray(t) for x, t in zip("qkv", grads)}}


def _assemble(results, name, data, seq, key):
    """The ranks' (B/data, S/seq, H, D) pieces in place."""
    rows = []
    for d in range(data):
        rows.append(np.concatenate([results[d * seq + s][0][f"{name}/{key}"]
                                    for s in range(seq)], axis=1))
    return np.concatenate(rows, axis=0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, spawned once; JAX's references computed meanwhile."""
    root = tmp_path_factory.mktemp("ring")
    started, refs = {}, {}
    for world in (2, 4):
        cases, inputs = [], {}
        for name, (w, data, seq, tokens, mask_kind, fused) in RINGS.items():
            if w != world:
                continue
            if fused:
                inputs.update(_inputs(name, tokens, mask_kind))
            cases.append({"kind": "ring", "name": name, "data": data, "seq": seq,
                          "fused": fused, "inputs": SPLIT_INPUTS.get(name, name)})
        if world == 4:
            cases.append({"kind": "ring_indivisible", "name": "indivisible", "seq": 4,
                          "tokens": 250})
        started[world] = (spawn_world(world, cases, inputs, str(root / f"w{world}")), inputs)
    for name, (w, data, seq, tokens, mask_kind, fused) in RINGS.items():
        if fused:
            refs[name] = _jax_ring(started[w][1], name, data, seq)
    for name, source in SPLIT_INPUTS.items():
        refs[name] = refs[source]
    results = {world: proc.results() for world, (proc, _) in started.items()}
    return results, refs


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_matches_jax_ring(worlds, name):
    results, refs = worlds
    world, data, seq, *_ = RINGS[name]
    res = results[world]
    for r, (_, values) in enumerate(res):
        assert values[name]["coords"] == {"data": r // seq, "model": 0, "seq": r % seq}
        assert values[name]["finite"]
    for key in ("out", "dq", "dk", "dv"):
        got = _assemble(res, name, data, seq, key)
        want = refs[name][key]
        assert np.isfinite(got).all(), key
        tol = OUT_TOL if key == "out" else GRAD_TOL
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, (name, key, err)


def test_tokens_the_ring_does_not_divide_raise(worlds):
    results, _ = worlds
    for _, values in results[4]:
        assert "not divisible" in values["indivisible"]
