"""Model factory, the counterpart of ``iswm_tpu/models/__init__.py``.

This slice builds the ResNet family with the DeepLabV3+ head.  The other
backbones and the plain V3 head raise ``NotImplementedError`` until their
ROADMAP item lands.  ``ModelConfig.fused_stem`` and ``ModelConfig.fused_blocks``
(``never`` | ``auto`` | ``always`` | ``interpret``) choose the fused stem and
the fused bottleneck blocks of the ResNet backbone.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import ModelConfig, aspp_dilations
from ..parallel.distributed import world_size

from .deeplab import ASPP, DeepLabHeadV3Plus, DeepLabV3Model
from .layers import BatchNorm2d, init_weights
from .resnet import ARCHS, ResNet, resnet_feature_channels

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_ZOO_ITEM = "ROADMAP.md Queue 1, 'Remaining zoo and feature maps'"
SHARDED_FUSED_ITEM = "ROADMAP.md Queue 1, 'Sharded fused stem and blocks'"


def _resolve_fused_mode(value: str, setting: str) -> str:
    """Check a ModelConfig fused-kernel setting (the one place that does).

    ``"never"``: the unfused modules.  ``"always"``: the fused functions (the
    kernel on a CUDA tensor, its plain version on a CPU tensor).
    ``"interpret"``: accepted as in the JAX package, where it runs the Pallas
    kernels on the CPU; a CPU tensor takes the plain versions here under
    ``"always"`` already, so it means the same.  ``"auto"`` stays
    ``"auto"``: the model decides per input, fused on a CUDA tensor and
    unfused on a CPU tensor (the port trains and serves on one device).

    In a process group of more than one rank ``"auto"`` is ``"never"``, as
    the JAX package turns it off on more than one device, and ``"always"``
    and ``"interpret"`` are refused: the fused kernels would take each rank's
    own BatchNorm statistics where the JAX package takes the global batch's."""
    if value not in ("never", "auto", "always", "interpret"):
        raise ValueError(f"unknown {setting} setting {value!r}")
    if world_size() > 1:
        if value in ("always", "interpret"):
            raise NotImplementedError(
                f"{setting}={value!r} on {world_size()} ranks is not ported yet "
                f"({SHARDED_FUSED_ITEM}); the fused kernels take one rank's statistics")
        return "never"
    return value


def build_model(cfg: ModelConfig, seed: int = 0) -> DeepLabV3Model:
    """Build an eval-mode model from config, with seeded random weights.

    OS=8 dilates ResNet layers 3 and 4 with ASPP rates (12, 24, 36); OS=16
    dilates layer 4 only, with (6, 12, 18)."""
    if cfg.name != "deeplabv3plus":
        raise NotImplementedError(f"head {cfg.name!r} is not ported yet ({_ZOO_ITEM})")
    if cfg.backbone not in ARCHS:
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} is not ported yet ({_ZOO_ITEM})"
        )
    if cfg.separable_conv:
        raise NotImplementedError(f"separable_conv is not ported yet ({_ZOO_ITEM})")
    if cfg.int8_training:
        raise NotImplementedError(
            "int8_training (QAT) is not ported yet (ROADMAP.md Queue 1, "
            "'int8_exec_xla and QAT')"
        )
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the port keeps float32 parameters")
    if cfg.output_stride not in (8, 16):
        raise ValueError("output_stride must be 8 or 16")
    rswd = (False, True, True) if cfg.output_stride == 8 else (False, False, True)
    low_ch, out_ch = resnet_feature_channels(cfg.backbone)
    model = DeepLabV3Model(
        ResNet(cfg.backbone, rswd, in_channels=cfg.in_channels,
               fused_stem=_resolve_fused_mode(cfg.fused_stem, "fused_stem"),
               fused_blocks=_resolve_fused_mode(cfg.fused_blocks, "fused_blocks")),
        DeepLabHeadV3Plus(out_ch, low_ch, cfg.num_classes,
                          aspp_dilations(cfg.output_stride)),
        compute_dtype=DTYPES[cfg.compute_dtype],
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    for m in model.modules():
        if isinstance(m, BatchNorm2d):  # flax momentum 0.9 is torch's 0.1
            m.momentum = 1.0 - cfg.bn_momentum
            m.eps = cfg.bn_epsilon
    return model.eval()


def build_model_by_name(
    factory_name: str, num_classes: int = 2, output_stride: int = 16,
    **overrides: Any,
) -> DeepLabV3Model:
    """Reference-style factory: e.g. ``deeplabv3plus_resnet50``."""
    head, _, backbone = factory_name.partition("_")
    cfg = ModelConfig(name=head, backbone=backbone, num_classes=num_classes,
                      output_stride=output_stride)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return build_model(cfg)


__all__ = [
    "ASPP",
    "DTYPES",
    "DeepLabHeadV3Plus",
    "DeepLabV3Model",
    "ResNet",
    "build_model",
    "build_model_by_name",
    "resnet_feature_channels",
]
