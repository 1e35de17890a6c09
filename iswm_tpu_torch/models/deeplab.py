"""DeepLabV3+ and DeepLabV3 heads and the full segmentation model, the
counterpart of ``iswm_tpu/models/deeplab.py``.

Attribute names reproduce the reference key layout that
``iswm_tpu.compat.torch_import.export_torch_state_dict`` writes (V3+:
``classifier.project``, ``classifier.aspp.convs.{0..4}``,
``classifier.aspp.project``, ``classifier.classifier.{0,1,3,4,6}``; V3:
``classifier.classifier.0`` the ASPP, ``.1``/``.2`` the 3x3 conv and its
BatchNorm, ``.4`` the output conv), so a JAX-initialised or reference-trained
model loads with ``strict=True``.  The ASPP runs in its inference form:
broadcast pool + concat + one 1x1 projection.

``separable`` makes every 3x3 conv of the head (the ASPP's atrous branches,
the classifier's 3x3s) a ``SeparableConvBN``: its depthwise and pointwise
convs sit at ``<conv>.body.0`` and ``<conv>.body.1``, where the plain conv's
weight was.

Under ``models/remat.py``'s ``rematerialized`` the head is two recomputed
segments: the ASPP, then the rest (the V3+ decoder, or the V3 head's convs).

``quant`` routes the head's convs for QAT as the JAX package's heads do.  Two
of them are the JAX package's ``ConcatConvBN`` there: the V3+ decoder's
first (non-separable) 3x3, one conv a part of its concatenated input (the 48
low-level and the 256 ASPP channels) in both modes, and the ASPP's projection
in TRAIN mode, one conv a branch, the pooled branch at 1 x 1 and broadcast in
the sum; each part with its own amax.  The output conv never routes.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from .layers import QUANT_OFF, BatchNorm2d, ConvBN, QuantSpec, SeparableConvBN, conv
from .remat import segment


def _conv3x3(separable: bool, quant: QuantSpec):
    return functools.partial(SeparableConvBN if separable else functools.partial(
        ConvBN, kernel_size=3), quant=quant)


class ASPPPooling(nn.Sequential):
    """Image-level branch: global average pool, 1x1 ConvBN (children
    ``1``, ``2``); its [B, C, 1, 1] output is broadcast by the ASPP."""

    def __init__(self, in_ch: int, out_ch: int, quant: QuantSpec = QUANT_OFF):
        super().__init__(nn.AdaptiveAvgPool2d(1), conv(in_ch, out_ch, 1, quant=quant),
                         BatchNorm2d(out_ch), nn.ReLU(inplace=True))


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling: 1x1 + three 3x3 atrous branches +
    pooling branch, concat to 5*256 channels, 1x1 projection (+ dropout)."""

    def __init__(self, in_ch: int, atrous_rates: Sequence[int],
                 out_channels: int = 256, dropout_rate: float = 0.1,
                 separable: bool = False, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        conv3 = _conv3x3(separable, quant)
        branches = [ConvBN(in_ch, out_channels, 1, quant=quant)]
        branches += [conv3(in_ch, out_channels, dilation=r) for r in atrous_rates]
        branches.append(ASPPPooling(in_ch, out_channels, quant))
        self.convs = nn.ModuleList(branches)
        n = len(branches)
        self.project = nn.Sequential(
            *ConvBN(n * out_channels, out_channels, 1, quant=quant,
                    parts=(out_channels,) * n, parts_in_eval=False),
            nn.Dropout(dropout_rate)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = [branch(x) for branch in self.convs[:-1]]
        pooled = self.convs[-1](x)
        conv1x1 = self.project[0]
        if getattr(conv1x1, "runs_parts", lambda training: False)(self.training):
            # QAT's train forward: one conv a branch, the pooled one at 1 x 1
            return self.project[1:](conv1x1.forward_parts(res + [pooled]))
        res.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(res, dim=1))


class DeepLabHeadV3Plus(nn.Module):
    """V3+ decoder: 48-ch low-level projection, ASPP on the deep feature,
    bilinear upsample, concat (304 ch), 3x3 / 3x3 / 1x1 classifier."""

    def __init__(self, in_ch: int, low_level_ch: int, num_classes: int,
                 atrous_rates: Sequence[int], separable: bool = False,
                 quant: QuantSpec = QUANT_OFF):
        super().__init__()
        conv3 = _conv3x3(separable, quant)
        self.project = ConvBN(low_level_ch, 48, 1, quant=quant)
        self.aspp = ASPP(in_ch, atrous_rates, separable=separable, quant=quant)
        cls0 = conv3(48 + 256, 256) if separable else conv3(48 + 256, 256, parts=(48, 256))
        self.classifier = nn.Sequential(
            *cls0, *conv3(256, 256),
            conv(256, num_classes, 1, bias=True),
        )

    def forward(self, features: dict) -> torch.Tensor:
        return segment(self.decode, features["low_level"], segment(self.aspp, features["out"]))

    def decode(self, low_level: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The decoder on the ASPP's output ``out``."""
        low = self.project(low_level)
        out = resize_bilinear(out, (low.shape[2], low.shape[3]))
        return self.classifier(torch.cat([low, out.to(low.dtype)], dim=1))


class DeepLabHead(nn.Module):
    """Plain V3 head: ASPP on the deep feature, 3x3 conv, 1x1 classifier,
    all in ``classifier.classifier``."""

    def __init__(self, in_ch: int, num_classes: int, atrous_rates: Sequence[int],
                 separable: bool = False, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        self.classifier = nn.Sequential(
            ASPP(in_ch, atrous_rates, separable=separable, quant=quant),
            *_conv3x3(separable, quant)(256, 256),
            conv(256, num_classes, 1, bias=True),
        )

    def forward(self, features: dict) -> torch.Tensor:
        return segment(self.convs, segment(self.classifier[0], features["out"]))

    def convs(self, x: torch.Tensor) -> torch.Tensor:
        """The convs after the ASPP."""
        for m in self.classifier[1:]:
            x = m(x)
        return x


class DeepLabV3Model(nn.Module):
    """backbone -> head -> bilinear upsample to the input size.

    NCHW in, NCHW logits out, in ``compute_dtype`` (the input is cast to
    it; float32 parameters are cast per conv).  ``grouped_blockdiag_max``
    is the gate below which the JAX package runs a grouped conv as one dense
    conv on a block-diagonal kernel: the same numbers, so here it only
    decides which grouped convs ``int8_exec_xla`` routes without
    ``int8_grouped``.  ``quant`` is the ``QuantSpec`` the model was built
    with (``switch_off_int8`` turns its int8 gate off)."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 grouped_blockdiag_max: int = 0, quant: QuantSpec = QUANT_OFF):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier
        self.compute_dtype = compute_dtype
        self.grouped_blockdiag_max = grouped_blockdiag_max
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        input_hw = (x.shape[2], x.shape[3])
        features = self.backbone(x.to(self.compute_dtype))
        return resize_bilinear(self.classifier(features), input_hw)
