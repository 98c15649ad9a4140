"""The (data, model, seq) mesh of ranks and the tensor-parallel rules.

Port of ``vtamiq_tpu/parallel/mesh.py``. The JAX package lays one program
over a device mesh and GSPMD places the collectives; here every rank is a
process (``parallel/distributed.py``) and the mesh names the process groups
that the steps' collectives (``parallel/comm.py``) run over:

- **data**: the batch splits over it; each rank holds its rows.
- **model**: Megatron-style tensor parallelism (TP): the attention's
  query/key/value and the MLP's fc1 split their output features over it
  (column-parallel), out and fc2 their input features (row-parallel), so an
  encoder layer needs one all-reduce after each sublayer
  (``models/vit.py``). Everything else is replicated.
- **seq**: the token axis splits over it; attention runs the ring of
  ``parallel/ring_attention.py``.

Rank r sits at (d, m, s) in the row-major order of JAX's
``reshape(data, model, seq)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
# the gradients' mean runs over the ranks that share a model index
GRAD_AXES = "data*seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinates, its
    device, the ``DeviceMesh`` and one process group per axis (plus
    ``GRAD_AXES``, the data x seq ranks of its model index)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    device_mesh: object
    groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def batch_rows(self, local_rows: int) -> Tuple[int, int]:
        """(first global row, global rows) of this rank's ``local_rows``
        rows of a global batch split over "data"."""
        return self.index(DATA_AXIS) * local_rows, local_rows * self.size(DATA_AXIS)


def make_mesh(data: int = -1, model: int = 1, seq: int = 1,
              device=None) -> Mesh:
    """Create the ("data", "model", "seq") mesh over the initialized process
    group (``parallel.distributed.initialize``); every rank calls it.
    ``data=-1`` takes the ranks that model x seq leaves. ``device``: this
    rank's device (default: the one ``initialize`` gave it). ``seq`` > 1
    turns on sequence parallelism: the steps route attention through the
    ring (``parallel/ring_attention.py``) with the token axis sharded."""
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized process group: call "
                         "vtamiq_tpu_torch.parallel.distributed.initialize() in every rank "
                         "(or start the ranks with torchrun)")
    n = dist.get_world_size()
    if data == -1:
        if n % (model * seq) != 0:
            raise ValueError(f"{n} devices not divisible by model*seq={model * seq}.")
        data = n // (model * seq)
    if data * model * seq > n:
        raise ValueError(f"Mesh {data}x{model}x{seq} needs "
                         f"{data * model * seq} devices; have {n}.")
    if data * model * seq < n:
        raise ValueError(f"Mesh {data}x{model}x{seq} covers {data * model * seq} of the "
                         f"{n} ranks; every rank must be in the mesh.")
    if device is None:
        from .distributed import rank_device
        device = rank_device()
    device = torch.device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, (data, model, seq), mesh_dim_names=AXES)
    rank = dist.get_rank()
    coords = {DATA_AXIS: rank // (model * seq), MODEL_AXIS: (rank // seq) % model,
              SEQ_AXIS: rank % seq}
    groups = {axis: dm.get_group(axis) for axis in AXES}
    # the data x seq group of each model index; every rank creates every
    # group, in the same order
    for m in range(model):
        ranks = [r for r in range(n) if (r // seq) % model == m]
        group = dist.new_group(ranks)
        if m == coords[MODEL_AXIS]:
            groups[GRAD_AXES] = group
    return Mesh({DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq}, coords, device, dm,
                groups)


def seq_size(mesh: Optional[Mesh]) -> int:
    """Size of the sequence-parallel axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(SEQ_AXIS)


def model_size(mesh: Optional[Mesh]) -> int:
    """Size of the tensor-parallel axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(MODEL_AXIS)


# --------------------------------------------------------------------------
# tensor-parallel rules
# --------------------------------------------------------------------------

def _param_dim(module: nn.Module, leaf: str) -> Optional[int]:
    """The dimension of ``module``'s parameter ``leaf`` that splits over
    "model", by the module that holds it (the ``Attention`` / ``Mlp``
    child it is): column-parallel kernels split dim 1 and their biases dim
    0, row-parallel kernels dim 0 with the bias replicated."""
    from ..models.vit import Attention, Mlp
    if isinstance(module, Attention):
        if leaf.startswith("out."):
            return 0 if leaf == "out.kernel" else None
        return 1 if leaf.endswith(".kernel") else 0
    if isinstance(module, Mlp):
        if leaf.startswith("fc1."):
            return 1 if leaf == "fc1.kernel" else 0
        return 0 if leaf == "fc2.kernel" else None
    return None


def param_specs(params: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension that splits over "model", or None
    (replicated)}: the q, k, v and fc1 kernels by output features (1) with
    their biases (0); the out and fc2 kernels by input features (0), their
    biases replicated; everything else replicated. The JAX package's
    ``_param_spec`` keys the same layout on path substrings."""
    from ..models.vit import Attention, Mlp
    specs = {n: None for n, _ in params.named_parameters()}
    for prefix, module in params.named_modules():
        if not isinstance(module, (Attention, Mlp)):
            continue
        for leaf, _ in module.named_parameters():
            specs[f"{prefix}.{leaf}"] = _param_dim(module, leaf)
    return specs


def param_shardings(params: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """``param_specs`` on ``mesh``: every dimension None when "model" has
    one rank."""
    if model_size(mesh) == 1:
        return {n: None for n, _ in params.named_parameters()}
    return param_specs(params)


def _check_tp(params: nn.Module, mesh: Mesh):
    from ..models.vit import QuantDense, ViT
    m = model_size(mesh)
    for module in params.modules():
        if isinstance(module, QuantDense):
            raise ValueError("an int8 QuantDense model cannot be tensor-parallel")
        if isinstance(module, ViT):
            cfg = module.cfg
            if cfg.num_heads % m or cfg.mlp_dim % m:
                raise ValueError(f"num_heads {cfg.num_heads} and mlp_dim {cfg.mlp_dim} must "
                                 f"divide by model={m}")


def shard_tensors(tensors: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's TP slices of full tensors keyed like ``specs``
    (parameters, gradients or optimizer moments)."""
    m, i = model_size(mesh), mesh.index(MODEL_AXIS)
    out = {}
    for n, t in tensors.items():
        dim = specs[n]
        out[n] = t if dim is None or m == 1 else t.chunk(m, dim=dim)[i].contiguous()
    return out


@torch.no_grad()
def shard_params(params: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut a full model to this rank's TP shard, in place: each split
    parameter is replaced by its slice (its ``nn.Parameter`` object keeps
    its identity). Moves nothing when "model" has one rank."""
    if model_size(mesh) == 1:
        return params
    _check_tp(params, mesh)
    specs = param_specs(params)
    named = dict(params.named_parameters())
    for n, t in shard_tensors({n: p.data for n, p in named.items()}, specs, mesh).items():
        named[n].data = t
    return params


def unshard_tensors(tensors: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_tensors``: full tensors gathered over
    "model" (a collective: every rank of the model group calls it)."""
    if model_size(mesh) == 1:
        return dict(tensors)
    from .comm import all_gather
    group = mesh.group(MODEL_AXIS)
    return {n: t if specs[n] is None else all_gather(t.detach().contiguous(), group,
                                                     dim=specs[n])
            for n, t in tensors.items()}


def unshard_params(params: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """{name: full tensor} of a TP-sharded model (a collective over
    "model"); the shards stay in place."""
    named = {n: p.detach() for n, p in params.named_parameters()}
    return unshard_tensors(named, param_shardings(params, mesh), mesh)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of global batch arrays (a tuple; None passes), on
    the mesh's device: row block ``data index`` of ``data`` blocks."""
    d, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def rows(x):
        if x is None:
            return None
        t = torch.as_tensor(x)
        if t.shape[0] % d:
            raise ValueError(f"batch of {t.shape[0]} rows does not split over data={d}")
        return t.chunk(d, dim=0)[i].to(mesh.device)

    return tuple(rows(x) for x in batch)
