"""ImageNet-pretrained backbones from local weight caches, the counterpart
of ``iswm_tpu/compat/pretrained.py``.

``pretrained_backbone=True`` is the reference's factory default (reference
network/modeling.py:75), which pulls torchvision ImageNet weights through
torch-hub (reference network/backbone/resnet.py:218-226).  Here resolution is
cache-only, and nothing is ever fetched.  The search goes, in order, through

  1. ``$ISWM_PRETRAINED_DIR``
  2. ``~/.cache/iswm_tpu/pretrained``
  3. ``~/.cache/torch/hub/checkpoints``  (torch-hub's own cache)

for ``<backbone>.pth`` or torchvision's ``<backbone>-<hash>.pth``
(``mobilenet_v2`` also names MobileNetV2).  Without a file the model keeps
its random initialization with a warning, unless ``ISWM_REQUIRE_PRETRAINED``
is set.

The port's backbones use the files' own key names (torchvision's for the
ResNets and MobileNetV2, the reference module's for Xception), so a file's
tensors overlay ``model.backbone``'s state dict key for key, shapes checked;
the ImageNet heads (``fc``, ``features.18``, ``classifier``,
``last_linear``) and the BatchNorm counters are not read, and the head keeps
its weights.  A stem for ``in_channels != 3`` is adapted as the reference
does (network/modeling.py:25-43).
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Dict, Optional

import torch
import torch.nn as nn

from .torch_import import strip_module_prefix

_CACHE_DIRS = (
    lambda: os.environ.get("ISWM_PRETRAINED_DIR"),
    lambda: os.path.expanduser("~/.cache/iswm_tpu/pretrained"),
    lambda: os.path.expanduser("~/.cache/torch/hub/checkpoints"),
)
_FILE_ALIASES = {"mobilenetv2": ("mobilenetv2", "mobilenet_v2")}
# the stem conv's key in each backbone family's file
_STEM_KEYS = {"mobilenetv2": "features.0.0.weight"}


def find_pretrained_file(backbone: str) -> Optional[str]:
    """Locate a cached ImageNet state dict for ``backbone``."""
    names = _FILE_ALIASES.get(backbone, (backbone,))
    for get_dir in _CACHE_DIRS:
        d = get_dir()
        if not d or not os.path.isdir(d):
            continue
        for name in names:
            exact = os.path.join(d, f"{name}.pth")
            if os.path.isfile(exact):
                return exact
            matches = sorted(glob.glob(os.path.join(d, f"{name}-*.pth")))
            if matches:
                return matches[0]
    return None


def adapt_stem_in_channels(weight: torch.Tensor, in_channels: int) -> torch.Tensor:
    """A 3-channel stem weight (OIHW) for ``in_channels`` inputs: the first
    ``in_channels`` of fewer, else the 3 followed by copies of their mean."""
    if in_channels <= 3:
        return weight[:, :in_channels]
    extra = weight.mean(dim=1, keepdim=True).expand(-1, in_channels - 3, -1, -1)
    return torch.cat([weight, extra], dim=1)


def backbone_state_from_file(path: str, backbone: nn.Module, backbone_name: str,
                             in_channels: int = 3) -> Dict[str, torch.Tensor]:
    """An ImageNet ``.pth`` -> ``backbone``'s state dict with the file's
    tensors (float32, on the CPU), the BatchNorm counters left as they are."""
    sd = strip_module_prefix(torch.load(path, map_location="cpu", weights_only=True))
    stem = _STEM_KEYS.get(backbone_name, "conv1.weight")
    sd[stem] = adapt_stem_in_channels(sd[stem].float(), in_channels)
    out = {}
    for key, current in backbone.state_dict().items():
        if key.endswith("num_batches_tracked"):
            out[key] = current
            continue
        value = sd[key]
        if value.shape != current.shape:
            raise ValueError(f"pretrained {key}: shape {tuple(value.shape)} != the model's "
                             f"{tuple(current.shape)}")
        out[key] = value.to(current.dtype)
    return out


def apply_pretrained_backbone(model: nn.Module, backbone_name: str, in_channels: int = 3,
                              path: Optional[str] = None) -> Optional[str]:
    """Overlay ImageNet weights on ``model.backbone`` in place; the head
    keeps its weights (the reference trains it from scratch,
    network/modeling.py:44-56).  Returns the file used, or None when no
    cached file was found (warned, or raised under ``ISWM_REQUIRE_PRETRAINED``)."""
    path = path or find_pretrained_file(backbone_name)
    if path is None:
        msg = (f"pretrained_backbone=True but no cached ImageNet weights found for "
               f"{backbone_name!r} (searched $ISWM_PRETRAINED_DIR, ~/.cache/iswm_tpu/pretrained, "
               f"~/.cache/torch/hub/checkpoints); continuing with random initialization")
        if os.environ.get("ISWM_REQUIRE_PRETRAINED"):
            raise FileNotFoundError(msg)
        warnings.warn(msg, stacklevel=2)
        return None
    model.backbone.load_state_dict(
        backbone_state_from_file(path, model.backbone, backbone_name, in_channels))
    return path
