"""vtamiq_tpu_torch — the PyTorch/CUDA port of ``vtamiq_tpu`` for NVIDIA
Hopper GPUs (H100), beside the JAX package it is held against.

Layer map (module names follow the JAX package):

- ``models``  — configs, the sparse-patch ViT and the VTAMIQ head as
                ``nn.Module`` parameter holders plus functions on tensors,
                checkpoints in the JAX package's npz format (read and
                write, optimizer state included), parameter tables.
- ``ops``     — patch sampling (uniform, and weighted CAPS with diff maps
                and the center prior), patch extraction, the patch-gather
                and flash-attention CUDA kernels' wrappers, flash attention
                and the attention policy, the training losses, the IQA
                metrics (``correlations``, ``fitting``, ``values``), the int8
                W8A8 serving path (``quant``).
- ``data``    — the dataset parsers, the batch loader, the host image
                decoder's bindings, size buckets, and synthetic pairs and
                datasets (``synth``).
- ``train``   — the optimizer chain and freeze masks (``optim``), the
                extraction stage and the train/eval steps (``steps``), the
                run configs (``config``), the training engine
                (``engine.train()``) and the run scripts (``run_custom``,
                ``run_multi``, ``multihost_train``).
- ``parallel`` — data, tensor and sequence parallelism across processes:
                the (data, model, seq) mesh and its tensor-parallel rules,
                multi-process set-up (torchrun or by hand), the
                hand-written collectives and ring attention over the flash
                kernels.
- ``utils``   — logging, the scalar writer, accumulators, timers, retries,
                profiling, the measurement harness, image tools.
- ``inference`` / ``serving`` — ``VTAMIQScorer`` and the HTTP server.
- ``csrc`` + ``_build`` — CUDA sources built with nvcc, and the host image
                decoder built with g++, at first use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``. Importing the package never imports JAX or ``vtamiq_tpu``.
"""

__version__ = "0.1.0"

from .inference import VTAMIQScorer, score_pair  # noqa: E402,F401
from .models.configs import VTAMIQConfig, ViTConfig, get_vit_config  # noqa: E402,F401
