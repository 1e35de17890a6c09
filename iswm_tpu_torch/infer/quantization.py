"""Quantized serving: the f32 / bf16 / int8 weight-only / fake-quantized
int8 / executed int8 variants and the harness that compares them, the
counterpart of ``iswm_tpu/infer/quantization.py``.

bf16 is the serving dtype; ``int8`` is weight-only per-output-channel
symmetric quantization (4x smaller at rest, dequantized to bf16 once at
build); ``int8_act`` adds fake-quantized activations at the calibrated
``ConvBN`` outputs (the numerics of an int8 engine, compute in bf16);
``int8_exec`` executes the eligible 1x1 convs in int8.  The harness
(``compare_variants``, ``format_report``) reports the reference's table:
avg latency ms / model size MB / MIoU / FIoU / FF1 and their deltas, with
a tiered mask-agreement verdict against the first variant.

``int8_exec`` keeps the JAX package's semantics (its Pallas backend):

- every conv weight, routed or not, is rounded to int8 per output channel
  and dequantized to bf16; the convs that are not routed run on those
  dequantized weights;
- a conv is routed when it is a plain 1x1 conv with stride 1 and groups 1,
  Cin % 128 == 0, Cout % 128 == 0 and its site is in ``conv_scales``; it
  runs as ``quantized_conv1x1`` (the hand-written CUDA kernel on the card),
  and its float32 output is cast back to the activation dtype before the
  BatchNorm.

Site keys are module names (``backbone.layer2.0.conv1``);
:func:`port_site_key` maps the JAX package's flax paths onto them.  An
activation site (``int8_act``) is the output of what the JAX package builds
as one ``ConvBN``: conv, BatchNorm and, where that module has one, its ReLU.
It is keyed by the name of its conv (:func:`port_act_site_key`) and read or
rewritten by a forward hook on the last module of that group
(:func:`activation_sites`).
"""

from __future__ import annotations

import copy
import re
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.transforms import val_transform_batch
from ..metrics import StreamMetrics
from ..models.deeplab import ASPP, ASPPPooling, DeepLabHead, DeepLabHeadV3Plus
from ..models.layers import AtrousSeparableConv, ConvBN, SeparableConvBN
from ..models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS, ConvBNReLU6, InvertedResidual
from ..models.resnet import BasicBlock, Bottleneck, ResNet
from ..models.xception import XCEPTION_BLOCKS, Block, SeparableConv2d, Xception
from ..ops.kernels.int8_matmul import quantized_conv1x1

_INT8_XLA_ITEM = "ROADMAP.md Queue 1, 'int8_exec_xla and QAT'"

# Tiers applied at the decision level: the fraction of output pixels whose
# argmax class agrees with the reference variant.
AGREEMENT_TIERS = (
    (0.999, "excellent: masks effectively identical"),
    (0.99, "good: sub-percent mask disagreement"),
    (0.95, "warning: noticeable mask divergence — inspect calibration"),
    (0.0, "broken: masks disagree materially"),
)


def logit_diff_verdict(a: np.ndarray, b: np.ndarray) -> Tuple[float, str]:
    """(mask agreement fraction, tiered verdict) between two logit maps."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    for bound, verdict in AGREEMENT_TIERS:
        if agree >= bound:
            return agree, verdict
    return agree, AGREEMENT_TIERS[-1][1]


# ----------------------------------------------------------- int8 weights
def quantize_params_int8(
    params: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
    """Per-output-channel symmetric int8 for every 4-D conv weight (OIHW,
    one scale per O).  Returns (tensors with int8 conv weights, scales;
    None for the tensors left as they are)."""
    q: Dict[str, torch.Tensor] = {}
    s: Dict[str, Optional[torch.Tensor]] = {}
    for name, leaf in params.items():
        if leaf.ndim == 4 and name.endswith("weight"):
            w = leaf.detach().float()
            amax = w.abs().amax(dim=(1, 2, 3), keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            q[name] = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            s[name] = scale
        else:
            q[name], s[name] = leaf, None
    return q, s


def dequantize_params(q, scales, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """int8 weights * scales -> ``dtype``; other tensors pass through."""
    return {
        k: v if scales[k] is None else (v.float() * scales[k]).to(dtype)
        for k, v in q.items()
    }


def param_bytes(params: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() * t.element_size() for t in params.values()))


def cast_params(params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast float tensors to ``dtype`` (the f32 and bf16 variants)."""
    return {k: v.detach().to(dtype) if v.is_floating_point() else v.detach()
            for k, v in params.items()}


def _load_params(model: nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Replace the model's parameters by ``values`` (dtype may change)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = values[name].to(p.device)


# --------------------------------------------------- activation calibration
def activation_sites(model: nn.Module) -> Dict[str, nn.Module]:
    """{site key: the module whose output is the site's tensor}.

    The sites are the outputs of the JAX package's ``ConvBN`` /
    ``PackedStemConvBN`` / ``SeparableConvBN`` / ``SepConvBN`` modules
    (post-BN, post-ReLU where the ReLU is inside that module), each keyed by
    the name of its conv here (a separable conv's module for the last two):

    - the ResNet stem: ``backbone.conv1`` -> the stem's ReLU, unless the model
      runs the fused stem where its weights lie (``FusedStemPool`` is none of
      the observed module types in the JAX package either: one site fewer);
    - a residual block: ``conv1`` (and a bottleneck's ``conv2``) -> their
      ReLUs, the last conv -> its BatchNorm (the ReLU after the residual
      add is outside), ``downsample.0`` -> ``downsample.1``;
    - MobileNetV2: each ``ConvBNReLU6`` -> its BatchNorm (ReLU6 is outside
      the JAX ``ConvBN``), a block's projection conv -> its BatchNorm;
    - Xception: the stems -> their ReLUs, each separable conv -> the
      BatchNorm after it (``SepConvBN`` has no activation), ``skip`` ->
      ``skipbn``;
    - the head's ``ConvBN``s and ``SeparableConvBN``s (low-level projection,
      ASPP branches) -> their ReLU; the pooling branch, the ASPP projection,
      the V3 head's 3x3 conv and the V3+ head's second classifier conv
      likewise.

    The V3+ head's first classifier conv is a site only when separable: the
    JAX package builds the plain one as a ``ConcatConvBN``, which its
    calibration does not observe."""
    sites: Dict[str, nn.Module] = {}
    for name, m in model.named_modules():
        if isinstance(m, ResNet):
            if not m.fuses_stem_on(m.conv1.weight.device):
                sites[f"{name}.conv1"] = m.relu
        elif isinstance(m, (Bottleneck, BasicBlock)):
            sites[f"{name}.conv1"] = m.relu1
            if isinstance(m, Bottleneck):
                sites[f"{name}.conv2"] = m.relu2
                sites[f"{name}.conv3"] = m.bn3
            else:
                sites[f"{name}.conv2"] = m.bn2
            if m.downsample is not None:
                sites[f"{name}.downsample.0"] = m.downsample[1]
        elif isinstance(m, ConvBNReLU6):
            sites[f"{name}.0"] = m[1]
        elif isinstance(m, InvertedResidual):
            sites[f"{name}.conv.{len(m.conv) - 2}"] = m.conv[-1]
        elif isinstance(m, Xception):
            sites.update({f"{name}.conv1": m.relu1, f"{name}.conv2": m.relu2,
                          f"{name}.conv3": m.bn3, f"{name}.conv4": m.bn4})
        elif isinstance(m, Block):
            for i, layer in enumerate(m.rep):
                if isinstance(layer, SeparableConv2d):
                    sites[f"{name}.rep.{i}"] = m.rep[i + 1]
            if m.skip is not None:
                sites[f"{name}.skip"] = m.skipbn
        elif isinstance(m, ASPPPooling):
            sites[f"{name}.1"] = m[3]
        elif isinstance(m, (ConvBN, SeparableConvBN)):
            sites[f"{name}.0"] = m[-1]
        elif isinstance(m, ASPP):
            sites[f"{name}.project.0"] = m.project[2]
        elif isinstance(m, DeepLabHeadV3Plus):
            sites[f"{name}.classifier.3"] = m.classifier[5]
            if isinstance(m.classifier[0], AtrousSeparableConv):
                sites[f"{name}.classifier.0"] = m.classifier[2]
        elif isinstance(m, DeepLabHead):
            sites[f"{name}.classifier.1"] = m.classifier[3]
    return sites


def calibrate_activations(
    model: nn.Module, batches: Iterable[torch.Tensor], max_batches: int = 25
) -> Dict[str, float]:
    """Per-site symmetric activation scales from <= ``max_batches``
    calibration batches (NCHW): {site key: absmax / 127}, 1.0 for a site
    whose absmax is 0 (the reference's PTQ calibration pass,
    evaluate_quantization.py:130-141)."""
    absmax: Dict[str, torch.Tensor] = {}

    def observer(key):
        def hook(module, args, out):
            v = out.detach().float().abs().amax()
            absmax[key] = v if key not in absmax else torch.maximum(absmax[key], v)

        return hook

    handles = [m.register_forward_hook(observer(key))
               for key, m in activation_sites(model).items()]
    try:
        with torch.inference_mode():
            for i, images in enumerate(batches):
                if i >= max_batches:
                    break
                model(images)
    finally:
        for h in handles:
            h.remove()
    return _scales_from_absmax(absmax)


def _scales_from_absmax(absmax: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = {}
    for k, v in absmax.items():
        v = float(v)
        out[k] = v / 127.0 if v > 0 else 1.0
    return out


def fake_quantize(out: torch.Tensor, scale: float) -> torch.Tensor:
    """``clip(round(out / scale), -127, 127) * scale``, computed in float32
    (rounding half to even), back in ``out``'s dtype."""
    codes = torch.clamp(torch.round(out.float() / scale), -127, 127)
    return (codes * scale).to(out.dtype)


def make_act_quant_fn(model: nn.Module, scales: Dict[str, float]) -> "ServingFn":
    """Full PTQ simulation: int8 weights + fake-quantized activations at the
    calibrated sites (the numerics of an int8 engine; the compute stays in
    the model's dtype).  The weights are rounded to int8 and dequantized to
    bf16 once, here; each site's output becomes
    ``clip(round(out_f32 / s), -127, 127) * s`` in the activation's dtype."""
    model = _serving_copy(model)
    q, s = quantize_params_int8(dict(model.named_parameters()))
    _load_params(model, dequantize_params(q, s, torch.bfloat16))

    def quantizer(scale):
        return lambda module, args, out: fake_quantize(out, scale)

    sites = activation_sites(model)
    for key, scale in scales.items():
        if key in sites:
            sites[key].register_forward_hook(quantizer(float(scale)))
    return ServingFn(model, q)


# ------------------------------------------------------- executed int8
def _int8_exec_eligible(module: nn.Module, wide: bool = False) -> bool:
    """int8-executable conv sites.  Default: 1x1 stride-1 dense convs whose
    input channels tile by 128 (what ``quantized_conv1x1`` executes).
    ``wide`` (calibration only): every dense conv with >= 64 input
    channels, the JAX package's superset for its XLA backend."""
    if not isinstance(module, nn.Conv2d) or module.groups != 1:
        return False
    if wide:
        return module.in_channels >= 64
    return (
        module.kernel_size == (1, 1)
        and module.stride == (1, 1)
        and module.in_channels % 128 == 0
    )


def calibrate_conv_inputs(
    model: nn.Module, batches: Iterable[torch.Tensor], wide: bool = False
) -> Dict[str, float]:
    """Per-conv input absmax/127 scales at the int8-executable sites, from
    forward pre-hooks over the model's run on ``batches`` (NCHW)."""
    absmax: Dict[str, torch.Tensor] = {}

    def observer(name):
        def hook(module, args):
            v = args[0].detach().float().abs().amax()
            absmax[name] = v if name not in absmax else torch.maximum(absmax[name], v)

        return hook

    handles = [
        m.register_forward_pre_hook(observer(name))
        for name, m in model.named_modules()
        if _int8_exec_eligible(m, wide)
    ]
    try:
        with torch.inference_mode():
            for images in batches:
                model(images)
    finally:
        for h in handles:
            h.remove()
    return _scales_from_absmax(absmax)


def _mobilenetv2_site(m: re.Match) -> str:
    stage, block = int(m[1]), int(m[2])
    index = 1 + sum(n for _, _, n, _ in INVERTED_RESIDUAL_SETTINGS[:stage]) + block
    parts = ("expand_conv", "depthwise", "project")[stage == 0:]  # stage 0 has no expansion
    i = parts.index(m[3])
    return f"backbone.features.{index}.conv.{i}" + ("" if m[3] == "project" else ".0")


def _xception_site(m: re.Match) -> str:
    n, i = int(m[1]), int(m[2])
    return f"backbone.block{n}.rep.{3 * i + int(XCEPTION_BLOCKS[n][1])}"


_BACKBONE_SITES = {
    "resnet": (
        (r"backbone/stem", "backbone.conv1"),
        (r"backbone/layer(\d+)_(\d+)/downsample", r"backbone.layer\1.\2.downsample.0"),
        (r"backbone/layer(\d+)_(\d+)/conv(\d+)", r"backbone.layer\1.\2.conv\3"),
    ),
    "mobilenetv2": (
        (r"backbone/stem", "backbone.features.0.0"),
        (r"backbone/stage(\d+)_(\d+)/(expand_conv|depthwise|project)", _mobilenetv2_site),
    ),
    "xception": (
        (r"backbone/stem(\d)", r"backbone.conv\1"),
        (r"backbone/block(\d+)/sep(\d+)", _xception_site),
        (r"backbone/block(\d+)/skip", r"backbone.block\1.skip"),
        (r"backbone/conv([34])", r"backbone.conv\1"),
    ),
}
# a separable conv's two convs: Xception's SeparableConv2d, the head's
# AtrousSeparableConv
_SEPARABLE_PARTS = {"backbone": {"depthwise": ".conv1", "pointwise": ".pointwise"},
                    "head": {"depthwise": ".body.0", "pointwise": ".body.1"}}


def _head_sites(head: str) -> tuple:
    if head == "deeplabv3plus":
        aspp, cls = "classifier.aspp", {"cls0": 0, "cls1": 3, "cls_out": 6}
        project = ((r"head/project", "classifier.project.0"),)
    else:
        aspp, cls, project = "classifier.classifier.0", {"cls0": 1, "cls_out": 4}, ()
    return project + (
        (r"head/aspp/b(\d+)", rf"{aspp}.convs.\1.0"),
        (r"head/aspp/pool", f"{aspp}.convs.4.1"),
        (r"head/aspp/project", f"{aspp}.project.0"),
        *((rf"head/{k}", f"classifier.classifier.{i}") for k, i in cls.items()),
    )


def port_site_key(jax_key: str, backbone: str = "resnet50", head: str = "deeplabv3plus") -> str:
    """A JAX conv site key of a ``backbone`` / ``head`` model (flax path such
    as ``backbone/layer2_0/conv1/conv``; ``head/cls0#p1`` for a part of a
    concat conv; ``backbone/block2/sep0/pointwise`` for a separable conv's
    half) -> the port's module name (``backbone.layer2.0.conv1``;
    ``classifier.classifier.0``; ``backbone.block2.rep.1.pointwise``)."""
    path = re.sub(r"#p\d+$", "", jax_key)
    path = re.sub(r"/conv$", "", path)
    family = ("mobilenetv2" if backbone in ("mobilenetv2", "mobilenet")
              else "xception" if backbone == "xception" else "resnet")
    part = ""  # (MobileNetV2's ConvBN named ``depthwise`` is a whole site)
    if path.endswith(("/depthwise", "/pointwise")) and (
            family == "xception" or path.startswith("head/")):
        path, _, part = path.rpartition("/")
    for pattern, name in _BACKBONE_SITES[family] + _head_sites(head):
        if re.fullmatch(pattern, path):
            key = re.sub(pattern, name, path)
            return key + (_SEPARABLE_PARTS[path.split("/")[0]][part] if part else "")
    raise KeyError(f"no port site for JAX site {jax_key!r} of {head}_{backbone}")


def port_act_site_key(jax_key: str, backbone: str = "resnet50",
                      head: str = "deeplabv3plus") -> str:
    """A JAX activation site key (the flax path of a ``ConvBN`` or a
    separable one, such as ``backbone/layer2_0/conv1``, ``head/aspp/pool``
    or ``backbone/block2/sep0``) -> the port's site key, the name of that
    module's conv (``backbone.layer2.0.conv1``; ``classifier.aspp.convs.4.1``;
    ``backbone.block2.rep.1``), as :func:`activation_sites` keys it."""
    return port_site_key(jax_key, backbone, head)


class Int8Conv1x1(nn.Module):
    """A routed 1x1 conv: int8 weights [Cout, Cin, 1, 1] with per-O scales
    and a calibrated input scale, run through ``conv_fn`` on NHWC pixels.
    NCHW in, NCHW out in the input's dtype."""

    conv_fn = staticmethod(quantized_conv1x1)

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale.reshape(-1))
        self.register_buffer("bias", None if bias is None else bias.detach().float())
        self.x_scale = float(x_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv_fn(x.permute(0, 2, 3, 1), self.w_q, self.w_scale, self.x_scale)
        if self.bias is not None:
            out = out + self.bias
        return out.permute(0, 3, 1, 2).to(x.dtype)


class ServingFn:
    """A variant's model as the tile engine calls it: normalized NHWC float
    images -> NHWC float32 logits.  The NHWC input, permuted, is a
    channels-last NCHW tensor, and the model runs channels last."""

    def __init__(self, model: nn.Module, stored_params: Dict[str, torch.Tensor],
                 routed_sites: Tuple[str, ...] = ()):
        self.model = model.eval()
        self.stored_params = stored_params
        self.routed_sites = routed_sites

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)


def _serving_copy(model: nn.Module) -> nn.Module:
    return copy.deepcopy(model).eval().to(memory_format=torch.channels_last)


def make_int8_exec_fn(model: nn.Module, conv_scales: Dict[str, float]) -> ServingFn:
    """EXECUTED int8: eligible 1x1 convs run as int8 x int8 -> int32
    matmuls with calibrated input scales; every other conv runs on its
    int8-rounded weights dequantized to bf16."""
    model = _serving_copy(model)
    params = dict(model.named_parameters())
    q, s = quantize_params_int8(params)
    _load_params(model, dequantize_params(q, s, torch.bfloat16))
    routed = []
    for name, m in list(model.named_modules()):
        if (_int8_exec_eligible(m) and name in conv_scales
                and m.out_channels % 128 == 0):
            parent, _, child = name.rpartition(".")
            model.get_submodule(parent).add_module(child, Int8Conv1x1(
                q[f"{name}.weight"], s[f"{name}.weight"], conv_scales[name], m.bias,
            ))
            routed.append(name)
    return ServingFn(model, q, tuple(routed))


def make_variant_fn(
    model: nn.Module, name: str,
    act_scales: Optional[Dict[str, float]] = None,
    conv_scales: Optional[Dict[str, float]] = None,
) -> ServingFn:
    """Build a serving fn for ``name`` in {'f32', 'bf16', 'int8', 'int8_act',
    'int8_exec'}.  'int8' stores int8 conv weights and serves them
    dequantized to bf16 (weight-only); 'int8_act' additionally
    fake-quantizes activations at the calibrated sites and needs
    ``act_scales`` from :func:`calibrate_activations`; 'int8_exec' executes
    the eligible 1x1 convs in int8 and needs ``conv_scales`` from
    :func:`calibrate_conv_inputs`."""
    if name == "int8_exec_xla":
        raise NotImplementedError(f"int8_exec_xla is not ported yet ({_INT8_XLA_ITEM})")
    if name == "int8_act":
        if act_scales is None:
            raise ValueError("int8_act requires act_scales (run calibration)")
        return make_act_quant_fn(model, act_scales)
    if name == "int8_exec":
        if conv_scales is None:
            raise ValueError("int8_exec requires conv_scales (run calibration)")
        return make_int8_exec_fn(model, conv_scales)
    model = _serving_copy(model)
    params = dict(model.named_parameters())
    if name in ("f32", "bf16"):
        stored = cast_params(params, torch.float32 if name == "f32" else torch.bfloat16)
        _load_params(model, stored)
        return ServingFn(model, stored)
    if name == "int8":
        q, s = quantize_params_int8(params)
        _load_params(model, dequantize_params(q, s, torch.bfloat16))
        return ServingFn(model, q)
    raise ValueError(f"unknown variant {name!r}")


# ---------------------------------------------------------------- harness
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model_input(image: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 [H, W, 3] image -> normalized float32 [1, H, W, 3] on ``device``."""
    return val_transform_batch(torch.from_numpy(np.asarray(image))[None].to(device))


def evaluate_variant(
    fn: Callable[[torch.Tensor], torch.Tensor],
    dataset,
    *,
    sequence_length: int = 7,
    max_images: Optional[int] = None,
) -> Dict[str, float]:
    """Per-image latency (first excluded, reference
    evaluate_quantization.py:261-263) + StreamMetrics over the set.

    The latency is host-clock time of one forward with the device
    synchronized on both sides of it.  Samples are sorted by file name and
    scored in windows of ``sequence_length`` frames; fewer samples than a
    window are scored one by one."""
    device = fn.device
    metrics = StreamMetrics(2, sequence_length=sequence_length)
    latencies = []
    samples = []
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for i in range(n):
        image, label = dataset[i][:2]
        x = _model_input(image, device)
        _sync(device)
        t0 = time.perf_counter()
        logits = fn(x)
        _sync(device)
        dt = time.perf_counter() - t0
        if i > 0:  # first-iteration warm-up excluded
            latencies.append(dt)
        pred = np.argmax(logits[0].cpu().numpy(), axis=-1)
        samples.append((dataset.images[i], pred, np.asarray(label)))

    samples.sort(key=lambda s: s[0])
    if len(samples) >= sequence_length:
        for i in range(len(samples) - sequence_length + 1):
            window = samples[i:i + sequence_length]
            metrics.update(
                np.stack([s[2] for s in window]),
                np.stack([s[1] for s in window]),
                sequence_data=True,
            )
    else:
        for _, p, g in samples:
            metrics.update(g, p, sequence_data=False)

    results = metrics.get_results()
    return {
        "avg_latency_ms": float(np.mean(latencies) * 1e3) if latencies else 0.0,
        "miou": results["MIoU"],
        "fiou": results["Foreground IoU"],
        "ff1": results["Foreground F1"],
        "weighted": results["Best Score"],
    }


def save_comparison_images(
    out_dir: str, image, gt, preds_by_variant: Dict[str, Any], name: str,
) -> str:
    """Side-by-side (image | gt | the first two variants' preds) comparison
    panel (reference evaluate_quantization.py:156-184)."""
    from ..utils.visualizer import Visualizer

    first_two = list(preds_by_variant.items())[:2]
    return Visualizer(out_dir).vis_segmentation_panel(
        name,
        np.asarray(image),
        gt=np.asarray(gt) * 255,
        pred=np.asarray(first_two[0][1]) * 255 if first_two else None,
        confidence=np.asarray(first_two[1][1]) * 255 if len(first_two) > 1 else None,
    )


def compare_variants(
    model: nn.Module,
    dataset,
    variants: Sequence[str] = ("f32", "int8"),
    *,
    sequence_length: int = 7,
    max_images: Optional[int] = None,
    comparison_dir: Optional[str] = None,
    calibration_batches: int = 25,
) -> Dict[str, Dict[str, float]]:
    """The FP32-vs-quantized comparison report (reference
    evaluate_quantization.py:301-354 table: latency / size / metric deltas)
    of ``model`` (eval mode, on its device) over ``dataset``.  With
    ``comparison_dir``, a comparison panel of the first image is written.
    The 'int8_act' and 'int8_exec' variants calibrate on the first
    <= ``calibration_batches`` images (reference :130-141).  The first
    variant is the reference the others are compared with."""
    if "int8_exec_xla" in variants:
        raise NotImplementedError(f"int8_exec_xla is not ported yet ({_INT8_XLA_ITEM})")
    device = next(model.parameters()).device
    report: Dict[str, Dict[str, float]] = {}
    probe = None
    first_preds: Dict[str, Any] = {}

    def calib_iter():
        for i in range(min(calibration_batches, len(dataset))):
            yield _model_input(dataset[i][0], device).permute(0, 3, 1, 2)

    act_scales = conv_scales = None
    if "int8_act" in variants:
        act_scales = calibrate_activations(model, calib_iter(), calibration_batches)
    if "int8_exec" in variants:
        conv_scales = calibrate_conv_inputs(model, calib_iter())

    for name in variants:
        fn = make_variant_fn(model, name, act_scales=act_scales, conv_scales=conv_scales)
        stats = evaluate_variant(
            fn, dataset, sequence_length=sequence_length, max_images=max_images
        )
        stats["size_mb"] = param_bytes(fn.stored_params) / 1e6
        # tiered logit agreement vs the first (reference) variant
        logits = fn(_model_input(dataset[0][0], device)).cpu().numpy()
        first_preds[name] = np.argmax(logits[0], axis=-1)
        if probe is None:
            probe = logits
            stats["mask_agreement"], stats["verdict"] = 1.0, "reference variant"
        else:
            stats["mask_agreement"], stats["verdict"] = logit_diff_verdict(probe, logits)
        report[name] = stats

    if comparison_dir is not None:
        img0, gt0 = dataset[0][:2]
        save_comparison_images(comparison_dir, img0, gt0, first_preds,
                               "variant_comparison")

    base = report[variants[0]]
    for name in variants[1:]:
        r = report[name]
        r["speedup"] = (
            base["avg_latency_ms"] / r["avg_latency_ms"] if r["avg_latency_ms"] else 0.0
        )
        r["size_reduction"] = base["size_mb"] / r["size_mb"] if r["size_mb"] else 0.0
        r["miou_delta"] = r["miou"] - base["miou"]
        r["fiou_delta"] = r["fiou"] - base["fiou"]
        r["ff1_delta"] = r["ff1"] - base["ff1"]
    return report


def format_report(report: Dict[str, Dict[str, float]]) -> str:
    lines = [
        f"{'variant':<9}{'lat ms':>9}{'size MB':>10}{'MIoU':>8}{'FIoU':>8}"
        f"{'FF1':>8}{'dMIoU':>8}{'speedup':>9}{'agree':>8}  verdict"
    ]
    for name, r in report.items():
        lines.append(
            f"{name:<9}{r['avg_latency_ms']:>9.2f}{r['size_mb']:>10.2f}"
            f"{r['miou']:>8.4f}{r['fiou']:>8.4f}{r['ff1']:>8.4f}"
            f"{r.get('miou_delta', 0.0):>8.4f}{r.get('speedup', 1.0):>9.2f}"
            f"{r.get('mask_agreement', 1.0):>8.4f}  {r.get('verdict', '')}"
        )
    if "int8" in report:
        lines.append(
            "note: 'int8' is weight-only (size play; compute stays bf16 by "
            "construction — its speedup column measures dequant overhead, "
            "not an int8 claim). 'int8_exec' runs eligible 1x1 convs as "
            "real int8 tensor-core matmuls through the hand-written CUDA "
            "kernel; see PERF.md for its times on the card."
        )
    return "\n".join(lines)
