"""vtamiq_tpu_torch — the PyTorch/CUDA port of ``vtamiq_tpu`` for NVIDIA
Hopper GPUs (H100), beside the JAX package it is held against.

Layer map (module names follow the JAX package):

- ``models``  — configs, the sparse-patch ViT and the VTAMIQ head as
                ``nn.Module`` parameter holders plus functions on tensors,
                and the JAX checkpoint reader.
- ``ops``     — uniform patch sampling, patch extraction, the patch-gather
                and flash-attention CUDA kernels' wrappers, flash attention
                and the attention policy, the training losses.
- ``train``   — the optimizer chain and freeze masks (``optim``), the
                extraction stage and the train/eval steps (``steps``).
- ``inference`` / ``serving`` — ``VTAMIQScorer`` and the HTTP server.
- ``csrc`` + ``_build`` — CUDA sources, built with nvcc at first use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``. Importing the package never imports JAX or ``vtamiq_tpu``.
"""

__version__ = "0.1.0"

from .inference import VTAMIQScorer, score_pair  # noqa: E402,F401
from .models.configs import VTAMIQConfig, ViTConfig, get_vit_config  # noqa: E402,F401
