"""Reference-format state dicts <-> the JAX package's variable trees.

The port's own copy of ``iswm_tpu/compat/torch_import.py`` (numpy trees,
the block tables of the port's model modules; held equal to it by
``tests/test_torch_shared.py``).
``import_torch_state_dict`` turns a reference-format torch state dict
(DeepLabV3+/DeepLabV3 with a ResNet, Xception or MobileNetV2 backbone;
reference train.py:567-582 checkpoint payload, network/modeling.py:12-56
architecture) into flax-layout ``params`` / ``batch_stats`` trees of numpy
arrays, and ``export_torch_state_dict`` is its inverse: it is how weights
and optimizer traces of the JAX package cross into the port, whose modules
use the reference key layout.

Key mapping (torch -> flax):
  backbone.conv1 / bn1                -> backbone.stem.{conv,bn}
  backbone.layerL.B.convN / bnN       -> backbone.layerL_{B}.convN.{conv,bn}
  backbone.layerL.B.downsample.{0,1}  -> backbone.layerL_{B}.downsample
  classifier.project.{0,1}            -> head.project
  classifier.aspp.convs.{0..3}.{0,1}  -> head.aspp.{b0..b3}
  classifier.aspp.convs.4.{1,2}       -> head.aspp.pool
  classifier.aspp.project.{0,1}       -> head.aspp.project
  classifier.classifier.{0,1|3,4|6}   -> head.{cls0,cls1,cls_out}
Conv weights transpose OIHW -> HWIO; torch int8 Quant/DeQuant stubs and
FloatFunctional buffers are dropped.  ``module.`` prefixes are stripped
(reference predict.py:82-84).

Beyond the JAX package's export: a head ``SeparableConvBN`` (the
``separable_conv`` variant; flax ``depthwise`` / ``pointwise`` / ``bn``)
exports to the layout of the reference's ``AtrousSeparableConvolution``,
``<conv>.body.0`` and ``<conv>.body.1`` where a plain conv's weight would be,
which the port's ``SeparableConvBN`` reproduces.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS
from ..models.xception import XCEPTION_BLOCKS


def _conv(w) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        (k[len("module.") :] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _import_convbn(
    params: dict,
    stats: dict,
    sd: Mapping[str, np.ndarray],
    torch_conv: str,
    torch_bn: str,
    flax_path: Tuple[str, ...],
) -> None:
    _set(params, flax_path + ("conv", "kernel"), _conv(sd[f"{torch_conv}.weight"]))
    _set(params, flax_path + ("bn", "scale"), np.asarray(sd[f"{torch_bn}.weight"]))
    _set(params, flax_path + ("bn", "bias"), np.asarray(sd[f"{torch_bn}.bias"]))
    _set(stats, flax_path + ("bn", "mean"), np.asarray(sd[f"{torch_bn}.running_mean"]))
    _set(stats, flax_path + ("bn", "var"), np.asarray(sd[f"{torch_bn}.running_var"]))


_RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    # grouped / wide variants: identical layer naming, only conv widths
    # differ, so the name-based mapping imports them unchanged (reference
    # network/backbone/resnet.py:287-346)
    "resnext50_32x4d": (3, 4, 6, 3),
    "resnext101_32x8d": (3, 4, 23, 3),
    "wide_resnet50_2": (3, 4, 6, 3),
    "wide_resnet101_2": (3, 4, 23, 3),
}
_BASIC = ("resnet18", "resnet34")


def import_resnet_backbone(
    params: dict,
    stats: dict,
    sd: Mapping[str, Any],
    backbone: str,
    prefix: str = "",
) -> None:
    """Import a torchvision-layout ResNet into the ``backbone`` subtree.

    ``prefix`` is "backbone." for reference checkpoints (whole-model state
    dicts, reference network/modeling.py:58-62 wraps the torchvision
    resnet under that attribute) and "" for raw torchvision ImageNet
    files (reference network/backbone/resnet.py:218-226 downloads these).
    Classifier keys (fc.*) and num_batches_tracked buffers are ignored.
    """
    bb = ("backbone",)
    _import_convbn(params, stats, sd, f"{prefix}conv1", f"{prefix}bn1", bb + ("stem",))
    n_convs = 2 if backbone in _BASIC else 3
    for stage_idx, blocks in enumerate(_RESNET_LAYERS[backbone]):
        for b in range(blocks):
            t = f"{prefix}layer{stage_idx + 1}.{b}"
            f = bb + (f"layer{stage_idx + 1}_{b}",)
            for c in range(1, n_convs + 1):
                _import_convbn(params, stats, sd, f"{t}.conv{c}", f"{t}.bn{c}", f + (f"conv{c}",))
            if f"{t}.downsample.0.weight" in sd:
                _import_convbn(
                    params, stats, sd,
                    f"{t}.downsample.0", f"{t}.downsample.1", f + ("downsample",),
                )


def _import_sepconv(
    params: dict,
    stats: dict,
    sd: Mapping[str, Any],
    torch_sep: str,
    torch_bn: str,
    flax_path: Tuple[str, ...],
) -> None:
    """SeparableConv2d(conv1=depthwise, pointwise) + BN -> SepConvBN."""
    _set(params, flax_path + ("depthwise", "kernel"), _conv(sd[f"{torch_sep}.conv1.weight"]))
    _set(params, flax_path + ("pointwise", "kernel"), _conv(sd[f"{torch_sep}.pointwise.weight"]))
    _set(params, flax_path + ("bn", "scale"), np.asarray(sd[f"{torch_bn}.weight"]))
    _set(params, flax_path + ("bn", "bias"), np.asarray(sd[f"{torch_bn}.bias"]))
    _set(stats, flax_path + ("bn", "mean"), np.asarray(sd[f"{torch_bn}.running_mean"]))
    _set(stats, flax_path + ("bn", "var"), np.asarray(sd[f"{torch_bn}.running_var"]))


# the JAX package's key order: the exit flow's block12 before the middle flow
_XCEPTION_ORDER = (1, 2, 3, 12, *range(4, 12))


def import_xception_backbone(
    params: dict,
    stats: dict,
    sd: Mapping[str, Any],
    prefix: str = "",
) -> None:
    """Reference-layout Xception -> backbone subtree.

    Key map (reference network/backbone/xception.py:108-162):
      conv1/bn1, conv2/bn2            -> stem1, stem2
      blockN.rep.{3i+o}.{conv1,pointwise} + rep.{3i+o+1} (BN)
                                      -> blockN.sep{i}   (o = 1 if the
                                         block starts with ReLU else 0)
      blockN.skip / skipbn            -> blockN.skip
      conv3/bn3, conv4/bn4            -> conv3, conv4
    fc/last_linear (ImageNet head) are ignored.
    """
    bb = ("backbone",)
    _import_convbn(params, stats, sd, f"{prefix}conv1", f"{prefix}bn1", bb + ("stem1",))
    _import_convbn(params, stats, sd, f"{prefix}conv2", f"{prefix}bn2", bb + ("stem2",))
    for n in _XCEPTION_ORDER:
        reps, start_with_relu = XCEPTION_BLOCKS[n]
        t = f"{prefix}block{n}"
        f = bb + (f"block{n}",)
        off = 1 if start_with_relu else 0
        for i in range(reps):
            idx = 3 * i + off
            _import_sepconv(params, stats, sd, f"{t}.rep.{idx}",
                            f"{t}.rep.{idx + 1}", f + (f"sep{i}",))
        if f"{t}.skip.weight" in sd:
            _import_convbn(params, stats, sd, f"{t}.skip", f"{t}.skipbn",
                           f + ("skip",))
    _import_sepconv(params, stats, sd, f"{prefix}conv3", f"{prefix}bn3", bb + ("conv3",))
    _import_sepconv(params, stats, sd, f"{prefix}conv4", f"{prefix}bn4", bb + ("conv4",))


def import_mobilenetv2_backbone(
    params: dict,
    stats: dict,
    sd: Mapping[str, Any],
    prefix: str = "",
) -> None:
    """torchvision-layout MobileNetV2 -> backbone subtree.

    torchvision naming: ``features.0`` stem ConvBNReLU; ``features.i``
    (i=1..17) InvertedResidual with ``conv.0``=expand ConvBNReLU (absent
    when expand_ratio==1), then depthwise ConvBNReLU, then project
    conv+bn as the last two flat entries.  ``features.18`` (the 1280ch
    ImageNet head conv) and ``classifier`` are ignored — the deeplab
    variant taps the 320ch block output (models/mobilenetv2.py).
    """
    bb = ("backbone",)
    _import_convbn(params, stats, sd, f"{prefix}features.0.0",
                   f"{prefix}features.0.1", bb + ("stem",))
    fi = 1
    for stage_idx, (_, _, n, _) in enumerate(INVERTED_RESIDUAL_SETTINGS):
        for block_idx in range(n):
            t = f"{prefix}features.{fi}"
            f = bb + (f"stage{stage_idx}_{block_idx}",)
            expand = stage_idx > 0
            if expand:
                _import_convbn(params, stats, sd, f"{t}.conv.0.0",
                               f"{t}.conv.0.1", f + ("expand_conv",))
                dw, proj = f"{t}.conv.1", f"{t}.conv.2"
                proj_bn = f"{t}.conv.3"
            else:
                dw, proj = f"{t}.conv.0", f"{t}.conv.1"
                proj_bn = f"{t}.conv.2"
            _import_convbn(params, stats, sd, f"{dw}.0", f"{dw}.1",
                           f + ("depthwise",))
            _import_convbn(params, stats, sd, proj, proj_bn, f + ("project",))
            fi += 1


def import_torch_state_dict(
    state_dict: Mapping[str, Any],
    *,
    backbone: str = "resnet50",
    head: str = "deeplabv3plus",
) -> Tuple[dict, dict]:
    """torch state dict -> (params, batch_stats) numpy trees."""
    sd = {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in strip_module_prefix(state_dict).items()
    }
    params: dict = {}
    stats: dict = {}

    # ---------------------------------------------------------- backbone
    if backbone in _RESNET_LAYERS:
        import_resnet_backbone(params, stats, sd, backbone, prefix="backbone.")
    elif backbone == "xception":
        import_xception_backbone(params, stats, sd, prefix="backbone.")
    elif backbone in ("mobilenetv2", "mobilenet"):
        import_mobilenetv2_backbone(params, stats, sd, prefix="backbone.")
    else:
        raise ValueError(f"unknown backbone for torch import: {backbone!r}")

    # -------------------------------------------------------------- head
    h = ("head",)
    if head == "deeplabv3plus":
        _import_convbn(
            params, stats, sd,
            "classifier.project.0", "classifier.project.1", h + ("project",),
        )
        aspp_prefix = "classifier.aspp"
        cls_prefix = "classifier.classifier"
    else:  # deeplabv3: classifier.classifier = [ASPP, conv, bn, relu, conv]
        aspp_prefix = "classifier.classifier.0"
        cls_prefix = None

    aspp = h + ("aspp",)
    _import_convbn(
        params, stats, sd,
        f"{aspp_prefix}.convs.0.0", f"{aspp_prefix}.convs.0.1", aspp + ("b0",),
    )
    for i in (1, 2, 3):
        _import_convbn(
            params, stats, sd,
            f"{aspp_prefix}.convs.{i}.0", f"{aspp_prefix}.convs.{i}.1",
            aspp + (f"b{i}",),
        )
    # pooling branch: AdaptiveAvgPool2d is index 0, conv 1, bn 2
    _import_convbn(
        params, stats, sd,
        f"{aspp_prefix}.convs.4.1", f"{aspp_prefix}.convs.4.2", aspp + ("pool",),
    )
    _import_convbn(
        params, stats, sd,
        f"{aspp_prefix}.project.0", f"{aspp_prefix}.project.1", aspp + ("project",),
    )

    if head == "deeplabv3plus":
        _import_convbn(params, stats, sd, f"{cls_prefix}.0", f"{cls_prefix}.1", h + ("cls0",))
        _import_convbn(params, stats, sd, f"{cls_prefix}.3", f"{cls_prefix}.4", h + ("cls1",))
        _set(params, h + ("cls_out", "kernel"), _conv(sd[f"{cls_prefix}.6.weight"]))
        _set(params, h + ("cls_out", "bias"), np.asarray(sd[f"{cls_prefix}.6.bias"]))
    else:
        _import_convbn(
            params, stats, sd,
            "classifier.classifier.1", "classifier.classifier.2", h + ("cls0",),
        )
        _set(
            params, h + ("cls_out", "kernel"), _conv(sd["classifier.classifier.4.weight"])
        )
        _set(
            params, h + ("cls_out", "bias"),
            np.asarray(sd["classifier.classifier.4.bias"]),
        )
    return params, stats


def load_reference_checkpoint(
    path: str, *, backbone: str = "resnet50", head: str = "deeplabv3plus"
) -> Tuple[dict, dict, dict]:
    """Load a reference .pth file -> (params, batch_stats, meta).

    Accepts both a bare state dict and the reference's checkpoint dict with
    'model_state' (reference train.py:567-582).
    """
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "model_state" in payload:
        sd = payload["model_state"]
        meta = {k: v for k, v in payload.items() if k != "model_state"}
    else:
        sd, meta = payload, {}
    params, stats = import_torch_state_dict(sd, backbone=backbone, head=head)
    return params, stats, meta


# ------------------------------------------------------------------ export
def _conv_back(w) -> np.ndarray:
    """HWIO -> OIHW (exact inverse of _conv's (2, 3, 1, 0))."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _get(tree, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _export_convbn(
    sd: dict,
    params: Any,
    stats: Any,
    flax_path: Tuple[str, ...],
    torch_conv: str,
    torch_bn: str,
) -> None:
    p = _get(params, flax_path)
    s = _get(stats, flax_path)
    if "depthwise" in p:  # a head SeparableConvBN (AtrousSeparableConvolution keys)
        sd[f"{torch_conv}.body.0.weight"] = _conv_back(p["depthwise"]["kernel"])
        sd[f"{torch_conv}.body.1.weight"] = _conv_back(p["pointwise"]["kernel"])
    else:
        sd[f"{torch_conv}.weight"] = _conv_back(p["conv"]["kernel"])
    sd[f"{torch_bn}.weight"] = np.asarray(p["bn"]["scale"], np.float32)
    sd[f"{torch_bn}.bias"] = np.asarray(p["bn"]["bias"], np.float32)
    sd[f"{torch_bn}.running_mean"] = np.asarray(s["bn"]["mean"], np.float32)
    sd[f"{torch_bn}.running_var"] = np.asarray(s["bn"]["var"], np.float32)
    sd[f"{torch_bn}.num_batches_tracked"] = np.asarray(0, np.int64)


def _export_sepconv(
    sd: dict,
    params: Any,
    stats: Any,
    flax_path: Tuple[str, ...],
    torch_sep: str,
    torch_bn: str,
) -> None:
    """Inverse of :func:`_import_sepconv` (SeparableConv2d + BN)."""
    p = _get(params, flax_path)
    s = _get(stats, flax_path)
    sd[f"{torch_sep}.conv1.weight"] = _conv_back(p["depthwise"]["kernel"])
    sd[f"{torch_sep}.pointwise.weight"] = _conv_back(p["pointwise"]["kernel"])
    sd[f"{torch_bn}.weight"] = np.asarray(p["bn"]["scale"], np.float32)
    sd[f"{torch_bn}.bias"] = np.asarray(p["bn"]["bias"], np.float32)
    sd[f"{torch_bn}.running_mean"] = np.asarray(s["bn"]["mean"], np.float32)
    sd[f"{torch_bn}.running_var"] = np.asarray(s["bn"]["var"], np.float32)
    sd[f"{torch_bn}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_xception_backbone(
    sd: dict, params: Any, stats: Any, prefix: str = "backbone."
) -> None:
    """backbone subtree -> reference-layout Xception keys (inverse of
    :func:`import_xception_backbone`; reference network/backbone/
    xception.py:108-162 naming)."""
    bb = ("backbone",)
    _export_convbn(sd, params, stats, bb + ("stem1",), f"{prefix}conv1",
                   f"{prefix}bn1")
    _export_convbn(sd, params, stats, bb + ("stem2",), f"{prefix}conv2",
                   f"{prefix}bn2")
    for n in _XCEPTION_ORDER:
        reps, start_with_relu = XCEPTION_BLOCKS[n]
        t = f"{prefix}block{n}"
        f = bb + (f"block{n}",)
        off = 1 if start_with_relu else 0
        for i in range(reps):
            idx = 3 * i + off
            _export_sepconv(sd, params, stats, f + (f"sep{i}",),
                            f"{t}.rep.{idx}", f"{t}.rep.{idx + 1}")
        if "skip" in _get(params, f):
            _export_convbn(sd, params, stats, f + ("skip",), f"{t}.skip",
                           f"{t}.skipbn")
    _export_sepconv(sd, params, stats, bb + ("conv3",), f"{prefix}conv3",
                    f"{prefix}bn3")
    _export_sepconv(sd, params, stats, bb + ("conv4",), f"{prefix}conv4",
                    f"{prefix}bn4")


def export_mobilenetv2_backbone(
    sd: dict, params: Any, stats: Any, prefix: str = "backbone."
) -> None:
    """backbone subtree -> torchvision-layout MobileNetV2 keys (inverse of
    :func:`import_mobilenetv2_backbone`)."""
    bb = ("backbone",)
    _export_convbn(sd, params, stats, bb + ("stem",),
                   f"{prefix}features.0.0", f"{prefix}features.0.1")
    fi = 1
    for stage_idx, (_, _, n, _) in enumerate(INVERTED_RESIDUAL_SETTINGS):
        for block_idx in range(n):
            t = f"{prefix}features.{fi}"
            f = bb + (f"stage{stage_idx}_{block_idx}",)
            if stage_idx > 0:
                _export_convbn(sd, params, stats, f + ("expand_conv",),
                               f"{t}.conv.0.0", f"{t}.conv.0.1")
                dw, proj, proj_bn = f"{t}.conv.1", f"{t}.conv.2", f"{t}.conv.3"
            else:
                dw, proj, proj_bn = f"{t}.conv.0", f"{t}.conv.1", f"{t}.conv.2"
            _export_convbn(sd, params, stats, f + ("depthwise",),
                           f"{dw}.0", f"{dw}.1")
            _export_convbn(sd, params, stats, f + ("project",), proj, proj_bn)
            fi += 1


def export_torch_state_dict(
    params: Any,
    batch_stats: Any,
    *,
    backbone: str = "resnet50",
    head: str = "deeplabv3plus",
) -> Dict[str, np.ndarray]:
    """flax trees -> reference-format torch state dict (numpy values).
    The inverse of :func:`import_torch_state_dict`, so models round-trip
    into the reference's own loader (reference predict.py:78-86,
    train.py:1001-1011) and into the port's modules.
    """
    sd: Dict[str, np.ndarray] = {}
    bb = ("backbone",)
    if backbone in _RESNET_LAYERS:
        _export_convbn(sd, params, batch_stats, bb + ("stem",),
                       "backbone.conv1", "backbone.bn1")
        n_convs = 2 if backbone in _BASIC else 3
        for stage_idx, blocks in enumerate(_RESNET_LAYERS[backbone]):
            for b in range(blocks):
                t = f"backbone.layer{stage_idx + 1}.{b}"
                f = bb + (f"layer{stage_idx + 1}_{b}",)
                for c in range(1, n_convs + 1):
                    _export_convbn(sd, params, batch_stats, f + (f"conv{c}",),
                                   f"{t}.conv{c}", f"{t}.bn{c}")
                if "downsample" in _get(params, f):
                    _export_convbn(sd, params, batch_stats, f + ("downsample",),
                                   f"{t}.downsample.0", f"{t}.downsample.1")
    elif backbone == "xception":
        export_xception_backbone(sd, params, batch_stats)
    elif backbone in ("mobilenetv2", "mobilenet"):
        export_mobilenetv2_backbone(sd, params, batch_stats)
    else:
        raise ValueError(f"unknown backbone for torch export: {backbone!r}")

    h = ("head",)
    if head == "deeplabv3plus":
        _export_convbn(sd, params, batch_stats, h + ("project",),
                       "classifier.project.0", "classifier.project.1")
        aspp_prefix = "classifier.aspp"
        cls_prefix = "classifier.classifier"
    else:
        aspp_prefix = "classifier.classifier.0"
        cls_prefix = None

    aspp = h + ("aspp",)
    for i, branch in enumerate(("b0", "b1", "b2", "b3")):
        _export_convbn(sd, params, batch_stats, aspp + (branch,),
                       f"{aspp_prefix}.convs.{i}.0", f"{aspp_prefix}.convs.{i}.1")
    _export_convbn(sd, params, batch_stats, aspp + ("pool",),
                   f"{aspp_prefix}.convs.4.1", f"{aspp_prefix}.convs.4.2")
    _export_convbn(sd, params, batch_stats, aspp + ("project",),
                   f"{aspp_prefix}.project.0", f"{aspp_prefix}.project.1")

    if head == "deeplabv3plus":
        _export_convbn(sd, params, batch_stats, h + ("cls0",),
                       f"{cls_prefix}.0", f"{cls_prefix}.1")
        _export_convbn(sd, params, batch_stats, h + ("cls1",),
                       f"{cls_prefix}.3", f"{cls_prefix}.4")
        out_key = f"{cls_prefix}.6"
    else:
        _export_convbn(sd, params, batch_stats, h + ("cls0",),
                       "classifier.classifier.1", "classifier.classifier.2")
        out_key = "classifier.classifier.4"
    cls_out = _get(params, h + ("cls_out",))
    sd[f"{out_key}.weight"] = _conv_back(cls_out["kernel"])
    sd[f"{out_key}.bias"] = np.asarray(cls_out["bias"], np.float32)
    return sd
