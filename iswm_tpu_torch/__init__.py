"""ISWM on PyTorch and CUDA: the port of ``iswm_tpu`` to an NVIDIA H100.

The JAX package ``iswm_tpu`` stays the reference; this package mirrors its
layout and names so that each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax``; from ``iswm_tpu`` it takes only the
framework-free ``config``, ``metrics`` and ``compat.torch_import``.

Layout:
    iswm_tpu_torch.models  — ResNet backbones + DeepLabV3+ head (nn.Module, NCHW)
    iswm_tpu_torch.ops     — bilinear resize, losses; ``ops.kernels``: hand-written
                             CUDA kernels (``csrc/``) with their plain versions
    iswm_tpu_torch.compat  — weights and SGD momentum from the JAX package /
                             reference .pth
    iswm_tpu_torch.infer   — tile engine, products, int8 serving, Predictor
    iswm_tpu_torch.data    — datasets, synthetic scenes, device augmentation,
                             class weights, prefetch loader
    iswm_tpu_torch.train   — optimizer + schedule, train/eval steps, .pth
                             checkpoints, logging, Trainer
    iswm_tpu_torch.cli     — ``python -m iswm_tpu_torch.cli.{predict,train}``
"""

__version__ = "0.1.0"
