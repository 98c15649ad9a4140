"""Data, tensor and sequence parallelism across processes: the mesh and its
TP rules (``mesh``), multi-process set-up (``distributed``), the hand-written
collectives (``comm``) and ring attention (``ring_attention``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, make_mesh, param_shardings, param_specs,
    shard_batch, shard_params, unshard_params,
)
from .ring_attention import (  # noqa: F401
    make_ring_attention, make_ring_attention_fn, make_seq_mesh,
)
