"""Dilated Xception backbone (entry, middle and exit flow), the counterpart
of ``iswm_tpu/models/xception.py``.

The reference's module names, which the JAX package's
``import_/export_xception_backbone`` map: ``conv1``/``bn1`` and
``conv2``/``bn2`` the two VALID 3x3 stems, ``blockN.rep`` a block's
``nn.Sequential`` of ReLU, ``SeparableConv2d`` (``conv1`` depthwise,
``pointwise``) and BatchNorm (the i-th separable conv at ``3i + o`` and its
BatchNorm at ``3i + o + 1``, ``o`` = 1 where the block starts with a ReLU),
``blockN.skip``/``skipbn`` the strided 1x1 shortcut, ``conv3``/``bn3`` and
``conv4``/``bn4`` the exit flow's separable convs.

As in the JAX package, the exit flow keeps its size when dilated (padding =
dilation, where the reference pads 1), and ``replace_stride_with_dilation``
is a 4-tuple over (block1, block2, block3 and the middle flow, block12).
A block's leading ReLU is not in place: the shortcut reads the block's input.

``forward`` returns ``{'low_level': block1's output (128 channels, stride
4), 'out': the 2048-channel output}``.

Under ``models/remat.py``'s ``rematerialized`` the two stems, each block and
the exit flow's two separable convs are recomputed segments.

``quant`` routes the stems, the shortcuts and every separable conv's
pointwise half for QAT, as the JAX package does (``SepConvBN``'s pointwise
route takes dynamic scales only).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import QUANT_OFF, BatchNorm2d, QuantSpec, conv
from .remat import segment

# (reps, start_with_relu) of each block (reference xception.py:139-153)
XCEPTION_BLOCKS = {1: (2, False), 2: (2, True), 3: (2, True),
                   **{i: (3, True) for i in range(4, 12)}, 12: (2, True)}


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (padding = dilation) + pointwise 1x1, as ``conv1`` and
    ``pointwise``: the reference's ``SeparableConv2d``.  With the BatchNorm
    that follows it, the JAX package's ``SepConvBN`` (no activation)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 quant: QuantSpec = QUANT_OFF):
        super().__init__()
        self.conv1 = conv(in_ch, in_ch, 3, 1, dilation, groups=in_ch)
        self.pointwise = conv(in_ch, out_ch, 1, quant=quant, pointwise=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.conv1(x))


class Block(nn.Module):
    """``reps`` separable convs (ReLU before each but a leading one the block
    does not start with), a 3x3 / stride max-pool where strided, plus the
    input or its 1x1 projection."""

    def __init__(self, in_ch: int, out_ch: int, reps: int, strides: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True,
                 dilation: int = 1, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        widths = [out_ch] if grow_first else []
        widths += [out_ch if grow_first else in_ch] * (reps - 1)
        if not grow_first:
            widths.append(out_ch)
        rep, width = [], in_ch
        for i, w in enumerate(widths):
            if i > 0 or start_with_relu:
                rep.append(nn.ReLU(inplace=i > 0))
            rep += [SeparableConv2d(width, w, dilation, quant), BatchNorm2d(w)]
            width = w
        self.rep = nn.Sequential(*rep)
        self.strides = strides
        if out_ch != in_ch or strides != 1:
            self.skip = conv(in_ch, out_ch, 1, strides, quant=quant)
            self.skipbn = BatchNorm2d(out_ch)
        else:
            self.skip = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.rep(x)
        if self.strides != 1:
            y = F.max_pool2d(y, 3, self.strides, 1)
        return y + (x if self.skip is None else self.skipbn(self.skip(x)))


class Xception(nn.Module):
    feature_channels = (128, 2048)  # (low_level, out)

    def __init__(self, replace_stride_with_dilation: Sequence[bool] = (False, False, False, True),
                 in_channels: int = 3, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        self.conv1 = conv(in_channels, 32, 3, 2, padding=0, quant=quant)
        self.bn1 = BatchNorm2d(32)
        self.relu1 = nn.ReLU(inplace=True)
        self.conv2 = conv(32, 64, 3, padding=0, quant=quant)
        self.bn2 = BatchNorm2d(64)
        self.relu2 = nn.ReLU(inplace=True)
        dilation = 1

        def stage(flag: bool) -> tuple:
            nonlocal dilation
            if flag:
                dilation *= 2
                return 1, dilation
            return 2, dilation

        flags = dict(zip((1, 2, 3, 12), replace_stride_with_dilation))
        widths = {1: (64, 128), 2: (128, 256), 3: (256, 728), 12: (728, 1024),
                  **{i: (728, 728) for i in range(4, 12)}}
        for n, (reps, start_with_relu) in XCEPTION_BLOCKS.items():
            # the middle flow keeps block3's stride 1 and dilation
            s, d = stage(flags[n]) if n in flags else (1, dilation)
            self.add_module(f"block{n}", Block(
                *widths[n], reps, s, start_with_relu, grow_first=n != 12, dilation=d,
                quant=quant))
        self.conv3 = SeparableConv2d(1024, 1536, dilation, quant)
        self.bn3 = BatchNorm2d(1536)
        self.relu3 = nn.ReLU(inplace=True)
        self.conv4 = SeparableConv2d(1536, 2048, dilation, quant)
        self.bn4 = BatchNorm2d(2048)
        self.relu4 = nn.ReLU(inplace=True)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu1(self.bn1(self.conv1(x)))
        return self.relu2(self.bn2(self.conv2(x)))

    def exit_flow(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu3(self.bn3(self.conv3(x)))
        return self.relu4(self.bn4(self.conv4(x)))

    def forward(self, x: torch.Tensor) -> dict:
        low = segment(self.block1, segment(self.stem, x))
        x = low
        for n in range(2, 13):
            x = segment(getattr(self, f"block{n}"), x)
        return {"low_level": low, "out": segment(self.exit_flow, x)}
