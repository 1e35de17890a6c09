"""ResNet backbones with output-stride control, the counterpart of
``iswm_tpu/models/resnet.py``.

torchvision's layout and key names (``conv1``/``bn1``, ``layerL.B.convN``/
``bnN``/``downsample.{0,1}``), so reference checkpoints load with
``strict=True``.  ``replace_stride_with_dilation`` follows torchvision: when
a stage trades its stride for dilation, its first block keeps the previous
dilation for the 3x3 conv and later blocks use the doubled one.

``forward`` returns ``{'low_level': layer1 out (stride 4), 'out': layer4 out}``.

Each ReLU that the JAX package keeps inside a ``ConvBN`` is a module of its
own here (``relu1``, ``relu2``; the stem's ``relu``), so that the output of
that ``ConvBN`` can be observed and fake-quantized by a forward hook
(``infer/quantization.py``).  The ReLU after the residual add is ``relu``.
ReLUs hold no parameters, so the key layout is unchanged.

``fused_stem`` other than ``"never"`` sends the stem (``conv1``, ``bn1``, ReLU,
max-pool) through ``FusedStemPool``, which uses those same two modules: the
keys are the same in every mode.

``fused_blocks`` other than ``"never"`` sends every eligible ``Bottleneck`` in
training mode through ``models/fused_block.py`` ``fused_bottleneck_apply``
(convs that emit their BatchNorm statistics and apply the previous BatchNorm +
ReLU on the way in, ``ops/kernels/fused_block.py``): stride 1, dilation 1,
groups 1, base width 64 and an eligible shape; every other block, and every
block in eval mode, runs its unfused modules.  The fused path uses the block's
own modules, so the keys are the same there too.

Under ``parallel/spatial.py``'s ``spatially_split`` the fused stem and blocks
are chosen on the global shape of the map (``spatial.global_shape``), so
that every rank of a model group takes the same path, and run on the
group's whole map, each rank keeping its own rows of the output
(``spatial.on_whole_map``: the stem gathers the image, a block its input),
as GSPMD gathers the activations of the JAX package's opaque kernels; their
BatchNorm sums go over the split's data group.

Under ``models/remat.py``'s ``rematerialized`` each of the stem (fused or
not) and the residual blocks is a recomputed segment.

``quant`` (a ``QuantSpec``) routes the blocks' convs for QAT as the JAX
package's ``ConvBN`` does; the stem never routes.  Under QAT the fused blocks
stay off (``Bottleneck.qat``), as in the JAX package, until
``switch_off_int8`` ends QAT.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..parallel import spatial
from .layers import (
    QUANT_OFF,
    BatchNorm2d,
    FusedStemPool,
    MaxPool2d,
    QuantSpec,
    conv,
    fused_stem_eligible,
)
from .remat import segment


class BasicBlock(nn.Module):
    """Two 3x3 convs; expansion 1."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, strides: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock supports only groups=1, base_width=64")
        self.conv1 = conv(in_ch, planes, 3, strides, dilation, quant=quant)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, 1, dilation, quant=quant)
        self.bn2 = BatchNorm2d(planes)
        self.relu1 = nn.ReLU(inplace=True)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(conv(in_ch, planes, 1, strides, quant=quant), BatchNorm2d(planes))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride/dilation, ``groups``) -> 1x1 (x4); the inner
    width is ``int(planes * base_width / 64) * groups`` (torchvision)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, strides: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64, fused_mode: str = "never",
                 quant: QuantSpec = QUANT_OFF):
        super().__init__()
        # what the fused path's gate reads
        self.strides, self.dilation = strides, dilation
        self.groups, self.base_width, self.fused_mode = groups, base_width, fused_mode
        self.qat = quant.int8
        width = int(planes * base_width / 64) * groups
        out_ch = planes * self.expansion
        self.conv1 = conv(in_ch, width, 1, quant=quant)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = conv(width, width, 3, strides, dilation, groups, quant=quant)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = conv(width, out_ch, 1, quant=quant)
        self.bn3 = BatchNorm2d(out_ch)
        self.relu1 = nn.ReLU(inplace=True)
        self.relu2 = nn.ReLU(inplace=True)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(conv(in_ch, out_ch, 1, strides, quant=quant), BatchNorm2d(out_ch))
            if downsample else None
        )

    def fuses_on(self, device: torch.device) -> bool:
        """Whether an eligible input on ``device`` takes the fused path in
        training mode: ``"auto"`` fuses on a CUDA device only; never under
        QAT."""
        if self.qat or (self.strides, self.dilation, self.groups,
                        self.base_width) != (1, 1, 1, 64):
            return False
        if self.fused_mode == "auto":
            return device.type == "cuda"
        return self.fused_mode != "never"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.fuses_on(x.device):
            from .fused_block import fused_block_eligible, fused_bottleneck_apply

            if fused_block_eligible(spatial.global_shape(x, self)):
                return spatial.on_whole_map(lambda t: fused_bottleneck_apply(self, t), x, self)
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


ARCHS = {
    # name: (block, layers, groups, base_width)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


def resnet_feature_channels(arch: str) -> tuple[int, int]:
    """(low_level, out) channel counts."""
    block = ARCHS[arch][0]
    return 64 * block.expansion, 512 * block.expansion


class ResNet(nn.Module):
    """Dilated ResNet backbone.  OS=8 uses replace_stride_with_dilation
    (False, True, True), OS=16 (False, False, True)."""

    def __init__(self, arch: str = "resnet50",
                 replace_stride_with_dilation: Sequence[bool] = (False, False, True),
                 in_channels: int = 3, fused_stem: str = "never",
                 fused_blocks: str = "never", quant: QuantSpec = QUANT_OFF):
        super().__init__()
        block, layer_sizes, groups, base_width = ARCHS[arch]
        self.feature_channels = resnet_feature_channels(arch)  # (low_level, out)
        # BasicBlock never fuses and takes no mode
        fused_kw = {"fused_mode": fused_blocks} if block is Bottleneck else {}
        self.fused_stem = fused_stem
        self.fused_stem_pool = FusedStemPool()
        self.conv1 = conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(3, 2, 1)
        in_ch, dilation = 64, 1
        for stage_idx, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), layer_sizes)
        ):
            stride = 1 if stage_idx == 0 else 2
            previous_dilation = dilation
            if stage_idx > 0 and replace_stride_with_dilation[stage_idx - 1]:
                dilation *= stride
                stride = 1
            layers = []
            for block_idx in range(blocks):
                first = block_idx == 0
                layers.append(block(
                    in_ch, planes,
                    strides=stride if first else 1,
                    dilation=previous_dilation if first else dilation,
                    downsample=first and (
                        stride != 1 or in_ch != planes * block.expansion
                    ),
                    groups=groups, base_width=base_width, quant=quant, **fused_kw,
                ))
                in_ch = planes * block.expansion
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*layers))

    def fuses_stem_on(self, device: torch.device) -> bool:
        """Whether an eligible input on ``device`` takes the fused stem:
        ``"auto"`` fuses on a CUDA device only."""
        if self.fused_stem == "auto":
            return device.type == "cuda"
        return self.fused_stem != "never"

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 + bn1 + ReLU + max-pool, fused where ``fuses_stem_on``."""
        pool = self.fused_stem_pool
        if self.fuses_stem_on(x.device) and fused_stem_eligible(spatial.global_shape(x, pool)):
            return spatial.on_whole_map(lambda t: pool(t, self.conv1, self.bn1), x, pool)
        return self.maxpool(self.relu(self.bn1(self.conv1(x))))

    def forward(self, x: torch.Tensor) -> dict:
        x = segment(self.stem, x)
        for block in self.layer1:
            x = segment(block, x)
        low = x
        for block in (*self.layer2, *self.layer3, *self.layer4):
            x = segment(block, x)
        return {"low_level": low, "out": x}
