"""Multi-process execution: one process per rank, started by hand or by
torchrun.

Port of ``vtamiq_tpu/parallel/distributed.py``. The JAX package runs one
SPMD program over every process's devices; here every rank is a process of
its own and the collectives are written out (``parallel/comm.py``):

- :func:`initialize` wires ``torch.distributed`` (a rendezvous, this rank's
  device and the backend) before a mesh is built (``parallel/mesh.py``).
  The backend is the caller's choice, stated or defaulted once: ``nccl``
  for ranks on distinct CUDA devices, ``gloo`` for CPU ranks or when asked.
  Nothing falls back to another backend or device on an error.
- The input pipeline shards by data rank in lockstep: every rank's loader
  derives the same global batch schedule from (seed, epoch) and decodes only
  its contiguous slice of each global batch (``data/pipeline.py``,
  ``process_index`` / ``process_count`` = the data rank and size).
- :func:`global_batch` puts this rank's rows of the global batch on its
  device; no rank builds another rank's images.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# this process's rank device and backend, set by initialize()
_STATE = {"device": None, "backend": None}


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _rank_device(local_device, process_id: int) -> torch.device:
    """The rank's device: ``local_device`` when given, else
    ``cuda:<LOCAL_RANK>`` (torchrun's variable; the process id when it is
    unset)."""
    if local_device is not None:
        return torch.device(local_device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device=None,
               backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``; returns (rank, world size).

    ``coordinator_address``: "host:port" of rank 0's store (a
    ``tcp://``/``file://`` URL passes as it is); with no arguments the
    rendezvous reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK). ``local_device``: this rank's device (default
    ``cuda:<local rank>``; the tests pass "cpu"). ``backend``: "nccl"
    (default for CUDA ranks) or "gloo" (default for CPU ranks). NCCL cannot
    run two ranks on one device: that raises ``ValueError`` before any
    communicator forms, as does a CUDA device this host lacks."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    init_method = _init_method(coordinator_address)
    store, rank, world = next(dist.rendezvous(
        init_method, rank=-1 if process_id is None else int(process_id),
        world_size=-1 if num_processes is None else int(num_processes)))
    device = _rank_device(local_device, rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    # every rank publishes its (host, device) before any communicator forms,
    # so all ranks see the same conflict and raise together
    store.set(f"vtamiq_rank_device/{rank}", f"{socket.gethostname()}/{device}")
    placed = [store.get(f"vtamiq_rank_device/{r}").decode() for r in range(world)]
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs CUDA devices; rank {rank} is on {device}: "
                             f"pass backend='gloo'")
        if len(set(placed)) < world:
            raise ValueError(f"NCCL cannot run two ranks on one device ({placed}); pass "
                             f"backend='gloo' to share a device, or give each rank its own")
    if device.type == "cuda":
        if not torch.cuda.is_available() or device.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank}: device {device} requested but this host has "
                             f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    _STATE.update(device=device, backend=backend)
    return rank, world


def rank_device() -> torch.device:
    """The device :func:`initialize` gave this rank."""
    if _STATE["device"] is None:
        raise RuntimeError("parallel.distributed.initialize() has not run in this process")
    return _STATE["device"]


def shutdown():
    """Leave the process group (no-op when none is initialized)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(indices: np.ndarray, process_index: int,
                  process_count: int) -> np.ndarray:
    """Disjoint strided per-process slice of an index list.

    Building block for hand-rolled training loops over fixed-size data with
    ``len(indices)`` divisible by (batch x processes). The production loader
    does not use it: it builds a lockstep global batch schedule instead
    (``data/pipeline.py``), because a strided slice cannot keep per-process
    batch counts and shapes in agreement once bucketing or partial batches
    are involved."""
    if process_count <= 1:
        return indices
    return indices[process_index::process_count]


def global_batch(mesh, local_arrays: Sequence, global_batch_size: int):
    """This rank's rows of the global batch, on the mesh's device: each of
    ``local_arrays`` (host arrays or tensors, None passes) has the leading
    axis ``global_batch_size / data``, checked. Returns a tuple of tensors
    (pinned host tensors copy without blocking)."""
    rows = local_batch_size(global_batch_size, mesh)

    def move(x):
        if x is None:
            return None
        t = torch.as_tensor(x)
        if t.shape[0] != rows:
            raise ValueError(f"local batch has {t.shape[0]} rows; a global batch of "
                             f"{global_batch_size} over data={mesh.size('data')} gives {rows}")
        return t.to(mesh.device, non_blocking=True)

    return tuple(move(x) for x in local_arrays)


def local_batch_size(global_batch_size: int, mesh=None) -> int:
    """Per-data-rank share of a global batch (over the mesh's data axis, or
    over every process without a mesh); the global batch must divide."""
    n = mesh.size("data") if mesh is not None else process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by the data "
                         f"size {n}")
    return global_batch_size // n


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or the
    only process)."""
    return process_index() == 0
