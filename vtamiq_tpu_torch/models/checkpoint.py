"""Checkpoints in the JAX package's npz format: save, load, merge, gates.

Port of ``vtamiq_tpu/models/checkpoint.py``. A checkpoint is one ``.npz`` of
flattened leaves, keyed by their tree path joined with ``|``, plus a
``__meta__`` JSON blob (epoch, SROCC, time and the engine's run state) and,
when the optimizer is saved, its leaves as ``__opt__|<i>`` in the order
``jax.tree_util`` flattens the optax state (``opt_state_leaves``).
The port's modules are named after the same tree paths, so a leaf
``vit|encoder|layers|layer_0|attn|query|kernel`` is the state-dict entry
``vit.encoder.layers.layer_0.attn.query.kernel``; a checkpoint written by
either package loads in the other.

Layouts are kept as JAX has them, so carrying weights across is a rename:
dense kernels stay ``(in, out)`` and the port computes ``x @ kernel``
(``models/vit.py::dense``); the patch kernel stays ``(P*P*3, H)`` over
patches flattened in (h, w, c) order, the port's channels-last patch layout.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

MODEL_STATE_DICT = "model_state_dict"
PREF_MODULE_STATE_DICT = "pref_module_state_dict"

_SEP = "|"  # path separator in the JAX package's flattened keys


OPT_LEAVES = "__opt_leaves__"


def save_checkpoint(output_dir: str, filename: str,
                    models: Mapping[str, Mapping[str, np.ndarray]],
                    epoch: int, srocc: float, opt_state: Optional[Mapping] = None,
                    extra_meta: Optional[Dict] = None) -> str:
    """Write a checkpoint. ``models`` maps a state-dict name
    (MODEL_STATE_DICT, PREF_MODULE_STATE_DICT) to a module's leaves as
    ``params_to_jax`` gives them; ``opt_state``:
    the port optimizer's state, stored as the JAX package's optax leaves
    (``opt_state_leaves``). Written under a temporary name and moved into
    place."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, filename)
    flat: Dict[str, np.ndarray] = {}
    for model_name, leaves in models.items():
        for k, v in leaves.items():
            flat[f"{model_name}{_SEP}{k}"] = v
    if opt_state is not None:
        for i, leaf in enumerate(opt_state_leaves(opt_state)):
            flat[f"__opt__{_SEP}{i}"] = np.asarray(leaf)
    meta = {"epoch": int(epoch), "SROCC": float(srocc), "time": time.time(),
            **(extra_meta or {})}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, object]:
    """Read a checkpoint -> ``{epoch, SROCC, meta, <model name>: flat,
    __opt_leaves__: [...]}``: each ``flat`` maps ``|``-joined leaf paths
    (below the model name) to numpy arrays; ``__opt_leaves__`` (present when
    the optimizer was saved) lists the optimizer's leaves in order."""
    with np.load(path, allow_pickle=False) as npz:
        flat = {k: npz[k] for k in npz.files}
    meta = json.loads(bytes(flat.pop("__meta__", np.frombuffer(b"{}", np.uint8))).decode())
    out: Dict[str, object] = {"epoch": meta.get("epoch", 0),
                              "SROCC": meta.get("SROCC", -1.0), "meta": meta}
    opt_leaves = {}
    for key, value in flat.items():
        name, rest = key.split(_SEP, 1)
        if name == "__opt__":
            opt_leaves[int(rest)] = value
        else:
            out.setdefault(name, {})[rest] = value
    if opt_leaves:
        out[OPT_LEAVES] = [opt_leaves[i] for i in sorted(opt_leaves)]
    return out


def tree_order(names) -> list:
    """Parameter names in the order ``jax.tree_util`` flattens the nested
    dict they name: keys sorted level by level (``layer_10`` before
    ``layer_2``)."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _moment_keys(state: Mapping) -> list:
    """The optimizer state's moment dicts in the optax state's order:
    Adam/AdamW (count, mu, nu, schedule count), SGD with momentum (trace,
    schedule count), SGD without (schedule count)."""
    return [k for k in ("mu", "nu", "trace") if k in state]


def opt_state_leaves(state: Mapping) -> list:
    """A port optimizer state (``train/optim.py::Optimizer.init``) as the
    leaves of the optax state that the JAX package's ``make_optimizer``
    keeps, in ``jax.tree_util`` order; counts are int32 scalars."""
    count = np.asarray(state["count"], np.int32)
    leaves = [count] if "mu" in state else []
    for key in _moment_keys(state):
        moments = state[key]
        leaves += [moments[n].detach().to("cpu", torch.float32).numpy().copy()
                   for n in tree_order(moments)]
    return leaves + [count]


def restore_opt_state(template: Dict, leaves) -> Dict:
    """Fill a freshly initialized port optimizer state (the structure
    template) from stored leaves in place and return it; raises on a
    structure mismatch."""
    leaves = list(leaves)
    moment_keys = _moment_keys(template)
    want = (1 if "mu" in template else 0) + 1 + sum(len(template[k]) for k in moment_keys)
    if len(leaves) != want:
        raise ValueError(f"Optimizer state structure mismatch on restore: "
                         f"{len(leaves)} leaves, the optimizer has {want}.")
    template["count"] = int(np.asarray(leaves[-1]))
    i = 1 if "mu" in template else 0
    with torch.no_grad():
        for key in moment_keys:
            moments = template[key]
            for n in tree_order(moments):
                leaf = torch.as_tensor(np.asarray(leaves[i]))
                if tuple(leaf.shape) != tuple(moments[n].shape):
                    raise ValueError(f"Optimizer state shape mismatch for {key}[{n}]: "
                                     f"{tuple(leaf.shape)} vs {tuple(moments[n].shape)}")
                moments[n].copy_(leaf)
                i += 1
    return template


def apply_pretraining_gates(model_state: Mapping[str, np.ndarray], allow_vit: bool = True,
                            allow_diffnet: bool = True, log=None) -> Dict[str, np.ndarray]:
    """Drop the ViT and/or the DiffNet + predictor leaves from a loaded flat
    state (the reference's pretraining gates)."""
    drop = []
    if not allow_vit:
        if log:
            log("Not loading transformer weights from checkpoint.")
        drop.append("vit")
    if not allow_diffnet:
        if log:
            log("Not loading diffnet weights from checkpoint.")
        drop += ["quality_decoder", "q_predictor", "diff_scale"]
    return {k: v for k, v in model_state.items() if k.split(_SEP, 1)[0] not in drop}


def params_from_jax(flat: Dict[str, np.ndarray], model: Optional[nn.Module] = None):
    """JAX parameter pytree leaves (``|``-joined paths -> numpy arrays, as
    ``load_checkpoint`` returns them or as ``jax.tree_util`` flattens a
    params dict) -> a state dict of the port's modules. No transposes: the
    port keeps the JAX layouts (see the module docstring). A tree that the
    JAX package's ``quantize_params_int8`` rewrote keeps its int8
    ``kernel_q8`` and fp32 ``kernel_scale`` leaves.

    With ``model``: returns the module with the leaves loaded strictly, each
    ``Dense`` holder whose leaves are int8 in ``flat`` replaced by a
    ``QuantDense`` holder built from them (``ops/quant.py::map_dense``: the
    module returned is a new one, sharing the rest with ``model``)."""
    state = {k.replace(_SEP, "."): torch.from_numpy(np.array(v, copy=True))
             for k, v in flat.items()}
    if model is None:
        return state
    from ..models.vit import QuantDense
    from ..ops.quant import map_dense

    def holder(d: nn.Module, name: str) -> nn.Module:
        if name + "kernel_q8" not in state:
            return d
        return QuantDense(state[name + "kernel_q8"], state[name + "kernel_scale"],
                          state[name + "bias"])
    model = map_dense(model, holder)
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(model) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: a module's parameters (or a
    {name: tensor} state, such as ``parallel.mesh.unshard_params`` gathers
    from a tensor-parallel model) as the JAX package's ``|``-joined leaf
    paths -> numpy arrays (fp32 copies on the host; int8 leaves of a
    quantized module stay int8)."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    return {k.replace(".", _SEP): v.detach().to(
                "cpu", v.dtype if v.dtype == torch.int8 else torch.float32).numpy().copy()
            for k, v in state.items()}


def merge_params(model: nn.Module, loaded: Dict[str, torch.Tensor],
                 strict: bool = False, log: Optional[Callable] = None,
                 stats: Optional[Dict[str, int]] = None) -> nn.Module:
    """Strict-then-relaxed merge of a state dict into ``model``, in place:
    entries present in ``loaded`` with matching shapes overwrite the
    model's; shape mismatches warn (or raise when ``strict``) and keep the
    initialized value; missing entries are kept (or raise when ``strict``).

    ``stats`` accumulates ``merged`` / ``kept`` counts so a caller can detect
    a merge that matched nothing (a wrong-config checkpoint)."""
    def count(name):
        if stats is not None:
            stats[name] = stats.get(name, 0) + 1

    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key not in loaded:
                if strict:
                    raise KeyError(f"Missing checkpoint key: {key}")
                count("kept")
                continue
            lv = torch.as_tensor(loaded[key])
            if tuple(lv.shape) != tuple(value.shape):
                msg = f"Shape mismatch for {key}: {tuple(lv.shape)} vs {tuple(value.shape)}"
                if strict:
                    raise ValueError(msg)
                if log:
                    log(f"[WARNING] {msg}; keeping initialized value.")
                count("kept")
            else:
                value.copy_(lv.to(value.dtype))
                count("merged")
    return model
