"""ISWM on PyTorch and CUDA: the port of ``iswm_tpu`` to an NVIDIA H100.

The JAX package ``iswm_tpu`` stays the reference; this package mirrors its
layout and names so that each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and nothing of ``iswm_tpu``: it keeps
its own copy of the modules there that it needs (``config``, ``metrics``,
``compat.torch_import``, the train CLI's flags).

Layout:
    iswm_tpu_torch.models  — ResNet backbones + DeepLabV3+ head (nn.Module, NCHW)
    iswm_tpu_torch.ops     — bilinear resize, losses; ``ops.kernels``: hand-written
                             CUDA kernels (``csrc/``) with their plain versions
    iswm_tpu_torch.compat  — weights and SGD momentum from the JAX package /
                             reference .pth
    iswm_tpu_torch.infer   — tile engine, products, serving variants and their
                             comparison, Predictor
    iswm_tpu_torch.metrics — host metrics engine (StreamMetrics) and the
                             reductions on tensors for quick evaluation
    iswm_tpu_torch.data    — datasets, synthetic scenes, device augmentation,
                             class weights, prefetch loader
    iswm_tpu_torch.train   — optimizer + schedule, train/eval steps, .pth
                             checkpoints, logging, Trainer
    iswm_tpu_torch.utils   — panel visualizer
    iswm_tpu_torch.cli     — ``python -m iswm_tpu_torch.cli.{predict,train,
                             evaluate_quantization}``
"""

__version__ = "0.1.0"
