"""Model factory, the counterpart of ``iswm_tpu/models/__init__.py``.

Every backbone of ``BACKBONES`` under either head of ``HEADS``, with
``separable_conv`` for the head's 3x3 convs.  ``ModelConfig.fused_stem`` and
``ModelConfig.fused_blocks`` (``never`` | ``auto`` | ``always`` |
``interpret``) choose the fused stem and the fused bottleneck blocks of a
ResNet backbone; the other backbones have neither.  ``ModelConfig.int8_training``
and its settings build a QAT model (``quant_spec``, ``models/layers.py``).
``ModelConfig.param_dtype`` (``float32``, ``bfloat16`` or ``float16``) is the
dtype of the parameters; the BatchNorm statistics and QAT's running amaxes
stay float32, as flax keeps its ``batch_stats``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import ModelConfig, aspp_dilations
from ..parallel.distributed import world_size

from .deeplab import ASPP, DeepLabHead, DeepLabHeadV3Plus, DeepLabV3Model
from .layers import BatchNorm2d, QuantSpec, init_weights
from .mobilenetv2 import MobileNetV2
from .resnet import ARCHS, ResNet, resnet_feature_channels
from .xception import Xception

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
BACKBONES = tuple(ARCHS) + ("mobilenetv2", "xception")
HEADS = ("deeplabv3plus", "deeplabv3")
SHARDED_FUSED_ITEM = "ROADMAP.md Queue 1, 'Sharded fused stem and blocks'"
# the auto grouped_blockdiag gate of each grouped backbone, as the JAX package
# sets it (iswm_tpu/models/__init__.py)
_GROUPED_BACKBONES = {"resnext50_32x4d": 256, "resnext101_32x8d": 512}


def grouped_blockdiag_max(cfg: ModelConfig) -> int:
    """The input-channel gate of the grouped convs that the JAX package runs
    block-diagonal: ``grouped_blockdiag`` -1 (auto) is the backbone's own
    (0 for a backbone without grouped convs), True 256, 0 off."""
    gb = cfg.grouped_blockdiag
    if gb is True:
        return 256
    if gb in (-1, None):
        return _GROUPED_BACKBONES.get(cfg.backbone, 0)
    return int(gb or 0)


def quant_spec(cfg: ModelConfig) -> QuantSpec:
    """The model's ``QuantSpec`` from a ModelConfig, as the JAX package
    derives it: ``int8_training`` True is a gate of 64 channels."""
    int8 = cfg.int8_training
    if int8 is True:
        int8 = 64
    return QuantSpec(
        int8_min_channels=int(int8 or 0),
        int8_scale_mode=cfg.int8_scale_mode,
        int8_bwd=bool(cfg.int8_training_bwd),
        int8_route=cfg.int8_route,
        int8_cost_bytes=float(cfg.int8_cost_bytes),
        grouped_blockdiag_max=grouped_blockdiag_max(cfg),
    )


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


def cast_parameters(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store every parameter of ``model`` in ``dtype``, in place (a
    ``Parameter`` stays the same object); buffers keep theirs, where
    ``Module.to(dtype)`` would cast the float ones too."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(dtype)


def build_model(cfg: ModelConfig, seed: int = 0) -> DeepLabV3Model:
    """Build an eval-mode model from config, with seeded random weights.

    OS=8 dilates ResNet layers 3 and 4 (Xception's block3, middle flow and
    block12) with ASPP rates (12, 24, 36); OS=16 dilates layer 4 (block12)
    only, with (6, 12, 18).  MobileNetV2 trades strides for dilation once it
    reaches the output stride.  The weights are drawn in float32 and rounded
    to ``param_dtype``."""
    if cfg.name not in HEADS:
        raise ValueError(f"unknown model name {cfg.name!r}; expected one of {HEADS}")
    if cfg.backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {cfg.backbone!r}; expected one of {BACKBONES}")
    if cfg.param_dtype not in DTYPES:
        raise ValueError(f"unknown param_dtype {cfg.param_dtype!r}; expected one of "
                         f"{tuple(DTYPES)}")
    if cfg.output_stride not in (8, 16):
        raise ValueError("output_stride must be 8 or 16")
    os8 = cfg.output_stride == 8
    quant = quant_spec(cfg)
    if cfg.backbone in ARCHS:
        backbone = ResNet(
            cfg.backbone, (False, True, True) if os8 else (False, False, True),
            in_channels=cfg.in_channels,
            fused_stem=_resolve_fused_mode(cfg.fused_stem, "fused_stem"),
            fused_blocks=_resolve_fused_mode(cfg.fused_blocks, "fused_blocks"), quant=quant)
    elif cfg.backbone == "mobilenetv2":
        backbone = MobileNetV2(cfg.output_stride, in_channels=cfg.in_channels, quant=quant)
    else:  # over (block1, block2, block3 + the middle flow, block12)
        backbone = Xception((False, False, True, True) if os8 else (False, False, False, True),
                            in_channels=cfg.in_channels, quant=quant)
    low_ch, out_ch = backbone.feature_channels
    rates = aspp_dilations(cfg.output_stride)
    head = (DeepLabHeadV3Plus(out_ch, low_ch, cfg.num_classes, rates, cfg.separable_conv, quant)
            if cfg.name == "deeplabv3plus"
            else DeepLabHead(out_ch, cfg.num_classes, rates, cfg.separable_conv, quant))
    model = DeepLabV3Model(backbone, head, compute_dtype=DTYPES[cfg.compute_dtype],
                           grouped_blockdiag_max=quant.grouped_blockdiag_max, quant=quant)
    init_weights(model, torch.Generator().manual_seed(seed))
    cast_parameters(model, DTYPES[cfg.param_dtype])
    for m in model.modules():
        if isinstance(m, BatchNorm2d):  # flax momentum 0.9 is torch's 0.1
            m.momentum = 1.0 - cfg.bn_momentum
            m.eps = cfg.bn_epsilon
    return model.eval()


def build_model_by_name(
    factory_name: str, num_classes: int = 2, output_stride: int = 16,
    **overrides: Any,
) -> DeepLabV3Model:
    """Reference-style factory: e.g. ``deeplabv3plus_resnet50``,
    ``deeplabv3_xception``; ``mobilenet`` names ``mobilenetv2``."""
    head, _, backbone = factory_name.partition("_")
    if backbone == "mobilenet":
        backbone = "mobilenetv2"
    cfg = ModelConfig(name=head, backbone=backbone, num_classes=num_classes,
                      output_stride=output_stride)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return build_model(cfg)


__all__ = [
    "ASPP",
    "BACKBONES",
    "DTYPES",
    "DeepLabHead",
    "DeepLabHeadV3Plus",
    "DeepLabV3Model",
    "HEADS",
    "MobileNetV2",
    "ResNet",
    "Xception",
    "build_model",
    "build_model_by_name",
    "cast_parameters",
    "quant_spec",
    "resnet_feature_channels",
]
