"""MobileNetV2 backbone with output-stride control, the counterpart of
``iswm_tpu/models/mobilenetv2.py``.

torchvision's module names (``features.0.{0,1}`` the stem, ``features.{i}``
an inverted residual whose ``conv`` holds ``0.{0,1}`` the expansion,
``1.{0,1}`` the depthwise conv, ``2`` and ``3`` the projection conv and its
BatchNorm; a block without expansion starts at the depthwise conv), so
torchvision ImageNet files and the JAX package's export load with
``strict=True``.  ``features.18`` (the 1280-channel ImageNet head) is not
built: the DeepLab variant taps the 320-channel output.

ReLU6 follows the BatchNorm as the third child of a ``ConvBNReLU6``, outside
what the JAX package builds as one ``ConvBN``: the activation site of such a
group is its BatchNorm's output (``infer/quantization.py``).  Once the
running stride reaches the output stride, a stride turns into dilation, and
the block that turns uses the new dilation already.

``forward`` returns ``{'low_level': the 24-channel stage (stride 4), 'out':
the 320-channel output}``.

``quant`` routes the stem, expansion and projection convs for QAT as the JAX
package's ``ConvBN`` does (a depthwise conv never routes).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import QUANT_OFF, BatchNorm2d, QuantSpec, conv

# (expansion t, channels c, repeats n, stride s): MobileNetV2 paper table 2
INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),  # the low-level tap follows this stage
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class ConvBNReLU6(nn.Sequential):
    """conv + BatchNorm + ReLU6 as children ``0``, ``1``, ``2``: torchvision's
    ``ConvBNReLU``, the JAX package's ``ConvBN(use_relu=False)`` + relu6."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, quant: QuantSpec = QUANT_OFF):
        super().__init__(conv(in_ch, out_ch, kernel_size, stride, dilation, groups,
                              quant=quant),
                         BatchNorm2d(out_ch), nn.ReLU6(inplace=True))


class InvertedResidual(nn.Module):
    """[1x1 expansion +] 3x3 depthwise (stride, dilation) + 1x1 projection,
    with the input added where the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int,
                 dilation: int = 1, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = [ConvBNReLU6(in_ch, hidden, 1, quant=quant)] if expand_ratio != 1 else []
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, dilation, groups=hidden),
                   conv(hidden, out_ch, 1, quant=quant), BatchNorm2d(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    feature_channels = (24, 320)  # (low_level, out)

    def __init__(self, output_stride: int = 16, in_channels: int = 3,
                 quant: QuantSpec = QUANT_OFF):
        super().__init__()
        layers = [ConvBNReLU6(in_channels, 32, 3, 2, quant=quant)]
        in_ch, current_stride, dilation = 32, 2, 1
        for stage_idx, (t, c, n, s) in enumerate(INVERTED_RESIDUAL_SETTINGS):
            for block_idx in range(n):
                stride = s if block_idx == 0 else 1
                if stride > 1 and current_stride >= output_stride:
                    dilation *= stride
                    stride = 1
                layers.append(InvertedResidual(in_ch, c, stride, t, dilation, quant))
                in_ch, current_stride = c, current_stride * stride
            if stage_idx == 1:
                self.low_level_index = len(layers)
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> dict:
        low = self.features[:self.low_level_index](x)
        return {"low_level": low, "out": self.features[self.low_level_index:](low)}
