"""Shared building blocks, the counterpart of ``iswm_tpu/models/layers.py``.

NCHW activations and OIHW weights, as PyTorch keeps them.  Parameters are in
``param_dtype`` (float32 unless ``build_model`` casts them), BatchNorm
statistics and QAT's running amaxes float32; the compute dtype is the dtype
of the activations, and every conv casts its weight to it, as the JAX
modules cast their kernels to ``dtype``.
The TPU lowering rewrites of the JAX package (``PackedStrided2Conv``,
``ShiftedDilatedConv``, ``ConcatConvBN``, ``BlockDiagConv``) compute the
same math as a plain conv, so here each of them is one ``Conv2d``.
``max_pool_torch`` is ``MaxPool2d(3, 2, 1)`` and ``global_avg_pool`` is
``GlobalAvgPool2d``: the library modules, with a path for a rank's image rows
under ``parallel/spatial.py``'s ``spatially_split``, as ``Conv2d`` has.
``FusedStemPool`` runs the stem's conv, BatchNorm, ReLU and max-pool through
the fused stem kernels (``ops/kernels/fused_stem``).  In a process group,
train-mode ``BatchNorm2d`` takes its statistics over every rank's rows
(``CrossReplicaBatchNorm``), as the JAX package's does under a jit sharded
over the data axis.

Quantization-aware training (``QuantSpec``, the JAX package's, threaded from
``ModelConfig`` by ``build_model``): a conv site that the spec routes is a
``QatConv2d`` (``Conv2d``'s parameters and state-dict keys) whose forward runs
``ops/int8_train.py``, by the JAX modules' rules: ``ConvBN``'s (groups 1 and
dilation < 6 through ``int8_conv_st`` / ``int8_conv_static_amax``, or with an
int8 backward ``int8_conv_fullq`` / ``int8_conv_fullq_static``; a 3x3 of
dilation >= 6 through ``int8_dilated_conv3x3``), the separable convs'
pointwise halves (``qat_pointwise_conv``: dynamic scales only) and a concat
conv's parts (``ConcatConvBN``: each part its own conv, amax and backward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from ..parallel.distributed import is_initialized, statistics_sum
from .remat import first_read, recomputing


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-model quantized-execution routing (the JAX package's
    ``QuantSpec``), captured by every module at construction.

    int8_min_channels -- minimum INPUT channel count of an int8-forward
        (QAT) conv; 0 = off.
    int8_scale_mode -- "dynamic": each step's absmax; "delayed": the running
        amax a module carries (train forwards only; an eval forward is
        dynamic).
    int8_bwd -- an int8 backward too at a routed site (where "cost" routes
        it): the cotangent quantized per tensor, the data and the weight
        gradient int8 convs (``int8_conv_fullq*``).
    int8_route -- "gate": every eligible conv at or above the channel gate;
        "cost": the per-site roofline model (``int8_cost_route``) above it.
    int8_cost_bytes -- bytes a value that model charges a dynamic quantize.
    grouped_blockdiag_max -- the gate of the grouped convs the JAX package
        runs block-diagonal (see ``DeepLabV3Model``)."""

    int8_min_channels: int = 0
    int8_scale_mode: str = "dynamic"
    int8_bwd: bool = False
    int8_route: str = "gate"
    int8_cost_bytes: float = 3.0
    grouped_blockdiag_max: int = 0

    def __post_init__(self):
        if self.int8_scale_mode not in ("dynamic", "delayed"):
            raise ValueError(f"int8_scale_mode {self.int8_scale_mode!r}")
        if self.int8_route not in ("gate", "cost"):
            raise ValueError(f"int8_route {self.int8_route!r}")

    @property
    def int8(self) -> bool:
        return self.int8_min_channels > 0

    def conv_routing(self, cin: int, cout: int, k: int, stride: int) -> Tuple[bool, bool]:
        """(int8_fwd, int8_bwd) of one conv site: "gate" routes every site
        with ``cin >= int8_min_channels``; "cost" applies the roofline model
        above that floor."""
        if not self.int8 or cin < self.int8_min_channels:
            return False, False
        if self.int8_route == "gate":
            return True, self.int8_bwd
        from ..ops.int8_train import int8_cost_route

        return int8_cost_route(cin, cout, k, stride,
                               delayed=self.int8_scale_mode == "delayed",
                               want_bwd=self.int8_bwd, quant_bytes=self.int8_cost_bytes)


QUANT_OFF = QuantSpec()


def torch_conv_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric per-side padding torch uses: (k//2)*d for odd k."""
    return (kernel_size // 2) * dilation


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the dtype of its input: the weight (and
    bias) are cast to it, which is a no-op once they are stored in it.

    Under ``parallel/spatial.py``'s ``spatially_split`` ``x`` is this rank's
    rows of the image: the conv fetches the rows its output rows read (its H
    padding as zero rows) and runs with H padding 0 (:meth:`rows`).  Grouped
    and depthwise convs take the same path."""

    def rows(self, x: torch.Tensor) -> tuple:
        """(the input rows this rank's output rows read, the padding to run
        the conv with): ``x`` and the conv's own padding outside
        ``spatially_split``."""
        if spatial.current() is None:
            return x, self.padding
        x = spatial.window_rows(x, self.kernel_size[0], self.stride[0], self.padding[0],
                                self.dilation[0], owner=self)
        return x, (0, self.padding[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x, padding = self.rows(x)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        padding, self.dilation, self.groups)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d``; under ``spatially_split`` it fetches its rows as the
    conv does, its padding rows -inf."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.current() is None:
            return super().forward(x)
        k, s, p, d = (v if isinstance(v, int) else v[0] for v in (
            self.kernel_size, self.stride, self.padding, self.dilation))
        x = spatial.window_rows(x, k, s, p, d, fill=float("-inf"), owner=self)
        return F.max_pool2d(x, self.kernel_size, self.stride, (0, p), self.dilation,
                            self.ceil_mode)


class GlobalAvgPool2d(nn.AdaptiveAvgPool2d):
    """``nn.AdaptiveAvgPool2d(1)``; under ``spatially_split`` the float32 sum
    of this rank's rows, summed over the model group (whose backward is a
    group sum too) and divided by the global H * W."""

    def __init__(self):
        super().__init__(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.current() is None:
            return super().forward(x)
        (rows,) = spatial.extents(self, x.device, x.shape[2])
        total = spatial.group_sum(x.float().sum(dim=(2, 3), keepdim=True))
        return (total / (rows * x.shape[3])).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in float32 on an activation of any dtype, with the
    output in the activation's dtype: flax ``nn.BatchNorm`` with
    ``dtype=bf16`` and float32 statistics.

    In train mode it normalizes with the batch statistics over (N, H, W)
    and updates the running ones as flax does, ``r = (1 - m) * r + m * batch``
    with the BIASED batch variance (``nn.BatchNorm2d`` would take the
    unbiased one).  ``momentum`` is torch's (``1 -`` flax's) and is set,
    with ``eps``, from ``ModelConfig`` by ``build_model``.  One value per
    channel (the ASPP pooling branch at batch 1) gives variance 0 and the
    output ``bias``, as in flax, where ``nn.BatchNorm2d`` raises.

    In a process group (of any size) train mode goes through
    ``CrossReplicaBatchNorm``: the statistics of the global batch.  A
    rematerialized segment's recomputation leaves the running statistics
    alone (``models/remat.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias,
                                False, 0.0, self.eps)
        if is_initialized():
            out, mean, var = CrossReplicaBatchNorm.apply(x, weight, bias, self.eps)
            self._update_running(mean, var)
            return out
        n = x.numel() // x.shape[1]
        if n == 1:
            xf = x.float()  # x - mean is exactly 0: output = bias, zero grads
            mean, var = xf.detach().reshape(-1), torch.zeros_like(self.running_var)
            out = (xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * (
                weight * self.eps ** -0.5
            ).reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
            out = out.to(x.dtype)
        else:
            # the batch mean and (unbiased) variance land in these with
            # momentum 1; the output uses the biased one, as flax's does
            mean = torch.zeros_like(self.running_mean)
            var = torch.zeros_like(self.running_var)
            out = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
            var = var * ((n - 1) / n)
        self._update_running(mean, var)
        return out

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if recomputing():
            return
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)


class CrossReplicaBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank of the default group,
    flax's arithmetic on the global batch: one float32 all-reduce of
    ``(sum x, sum x^2, n)`` per channel, ``mean = sum x / n``, the fast
    variance ``max(sum x^2 / n - mean^2, 0)`` (biased, into the running
    statistics too), ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``.
    One value per channel in the whole group gives variance 0 and ``y = bias``.

    The backward all-reduces ``(sum dy, sum dy * xhat)`` and forms ``dx`` from
    the global sums; the gradients of ``weight`` and ``bias`` are this rank's
    share, which the gradient reduction (a sum over ranks) completes.  Returns
    (y in x's dtype, mean, var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        dims = (0, 2, 3)
        local_n = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32,
                             device=x.device)
        sums = statistics_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), local_n]))
        c = x.shape[1]
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
        sigma_inv = torch.rsqrt(var + eps)
        per_channel = (1, c, 1, 1)
        out = ((xf - mean.reshape(per_channel)) * (sigma_inv * weight).reshape(per_channel)
               + bias.reshape(per_channel))
        ctx.save_for_backward(x, weight, mean, sigma_inv, n)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, sigma_inv, n = ctx.saved_tensors
        dims, per_channel = (0, 2, 3), (1, x.shape[1], 1, 1)
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(per_channel)) * sigma_inv.reshape(per_channel)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dweight = local.chunk(2)
        total = statistics_sum(local)
        sum_dy, sum_dy_xhat = (t.reshape(per_channel) / n for t in total.chunk(2))
        dx = ((weight * sigma_inv).reshape(per_channel)
              * (dyf - sum_dy - xhat * sum_dy_xhat))
        return dx.to(x.dtype), dweight, dbias, None


class QatConv2d(Conv2d):
    """A conv site that QAT routes (see the module docstring): ``Conv2d``'s
    parameters and keys, an int8 forward through ``ops/int8_train.py``.

    ``route`` is ``"st"`` (``int8_conv_st``, or ``int8_conv_static_amax`` in a
    delayed-mode train forward; with ``int8_bwd`` their ``fullq`` forms),
    ``"dilated"`` (``int8_dilated_conv3x3``) or None, for the whole conv.  A
    concat conv has ``parts`` (the input-channel widths of its concatenated
    input): in train mode, and in eval mode too where ``parts_in_eval``, it is
    the JAX package's ``ConcatConvBN``, a sum of per-part convs (the weight
    split by input slice), each routed where ``part_routes`` says and with an
    int8 backward where ``part_bwd`` says (none routed: the plain conv, the
    same sum).  A
    delayed-mode site keeps its running amax in a non-persistent buffer
    (``x_amax``, a part's ``x_amax_p{i}``, 0 at first), out of the state dict;
    a rematerialized segment's recomputation quantizes with the amax its first
    forward read and does not update it (``models/remat.py``).  ``qat`` False
    (``switch_off_int8``) makes it a plain ``Conv2d``.  Under
    ``spatially_split`` the int8 conv, and a concat conv's parts, run on the
    rows with their halo at H padding 0 (:meth:`Conv2d.rows`): a halo row is
    another rank's real row and a fill row 0, so the amax over the ranks is
    the image's, and the int8 backward's data gradient of the halo goes back
    to its owner."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *, route: Optional[str],
                 delayed: bool = False, int8_bwd: bool = False,
                 parts: Optional[Sequence[int]] = None, part_routes: Sequence[bool] = (),
                 part_bwd: Sequence[bool] = (), parts_in_eval: bool = True, **kw):
        super().__init__(in_ch, out_ch, kernel_size, **kw)
        self.qat, self.route, self.int8_bwd = True, route, int8_bwd
        self.parts = None if parts is None else tuple(parts)
        self.part_routes, self.parts_in_eval = tuple(part_routes), parts_in_eval
        self.part_bwd = tuple(part_bwd)
        self._amax_read = {}  # what a segment's first forward read (remat.first_read)
        if delayed and route == "st" and parts is None:
            self.register_buffer("x_amax", torch.zeros(()), persistent=False)
        for i, routed in enumerate(self.part_routes):
            if delayed and routed:
                self.register_buffer(f"x_amax_p{i}", torch.zeros(()), persistent=False)

    def amax_buffers(self) -> dict:
        """{buffer name: the running amax} of a delayed-mode site."""
        return {k: v for k, v in self._buffers.items() if k.startswith("x_amax")}

    def _parts_mode(self, training: bool) -> bool:
        return self.qat and self.parts is not None and (training or self.parts_in_eval)

    def runs_parts(self, training: bool) -> bool:
        """Whether a forward in this mode sums per-part convs, some routed."""
        return self._parts_mode(training) and any(self.part_routes)

    def routed_sites(self, name: str, training: bool) -> list:
        """The site keys this conv routes in a forward of this mode: ``name``,
        or ``name#p{i}`` for each routed part."""
        if self._parts_mode(training):
            return [f"{name}#p{i}" for i, r in enumerate(self.part_routes) if r]
        return [name] if self.qat and self.route else []

    def switch_off(self) -> None:
        self.qat = False
        for k in list(self.amax_buffers()):
            del self._buffers[k]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.runs_parts(self.training):
            x, padding = self.rows(x)
            return self.forward_parts(torch.split(x, self.parts, dim=1), padding)
        if not self.qat or self.route is None or self._parts_mode(self.training):
            return super().forward(x)
        x, padding = self.rows(x)
        out = self._int8(x, self.weight.to(x.dtype), "x_amax", self.route, self.int8_bwd,
                         padding)
        return out if self.bias is None else out + self.bias.to(x.dtype).reshape(1, -1, 1, 1)

    def forward_parts(self, parts: Sequence[torch.Tensor], padding=None) -> torch.Tensor:
        """The conv of the channel concatenation of ``parts`` as a sum of per-part
        convs, in part order (a part may have a smaller spatial extent, which
        broadcasts: the ASPP's pooled branch, 1 x 1), at ``padding`` (the
        conv's own by default; under ``spatially_split`` the parts of the rows
        that :meth:`rows` gives, or those of a 1 x 1 conv)."""
        padding = self.padding if padding is None else padding
        w = self.weight.to(parts[0].dtype)
        acc, off = None, 0
        for i, (p, routed) in enumerate(zip(parts, self.part_routes)):
            wp = w[:, off:off + p.shape[1]]
            t = (self._int8(p, wp, f"x_amax_p{i}", "st", self.part_bwd[i], padding) if routed
                 else F.conv2d(p, wp, None, self.stride, padding, self.dilation))
            acc = t if acc is None else acc + t
            off += p.shape[1]
        return acc if self.bias is None else acc + self.bias.to(acc.dtype).reshape(1, -1, 1, 1)

    def _int8(self, x: torch.Tensor, w: torch.Tensor, amax_name: str, route: str, bwd: bool,
              padding):
        from ..ops import int8_train as ops

        if route == "dilated":
            return ops.int8_dilated_conv3x3(x, w, self.dilation[0], bwd,
                                            across_ranks=self.training, padding=padding)
        geometry = (self.stride, padding, self.dilation)
        amax = self._buffers.get(amax_name)
        if self.training and amax is not None:
            fn = ops.int8_conv_fullq_static if bwd else ops.int8_conv_static_amax
            read = first_read(self._amax_read, amax_name, amax)
            out, new_amax = fn(x, w, read, *geometry, across_ranks=True)
            if not recomputing():
                with torch.no_grad():
                    amax.copy_(new_amax)
            return out
        fn = ops.int8_conv_fullq if bwd else ops.int8_conv_st
        return fn(x, w, *geometry, across_ranks=self.training)


def qat_route(quant: QuantSpec, in_ch: int, out_ch: int, kernel_size: int, stride: int,
              dilation: int, groups: int, default_padding: bool,
              pointwise: bool = False) -> Tuple[Optional[str], bool]:
    """(route, int8 backward) of a conv site by the JAX modules' rules: a
    separable conv's pointwise half as a 1x1; else ``ConvBN``'s: groups 1 and
    dilation < 6 as the conv itself (``"st"``), a 3x3 of dilation >= 6,
    stride 1, groups 1 and torch padding as ``ShiftedDilatedConv``
    (``"dilated"``); any other conv never routes."""
    if not quant.int8:
        return None, False
    if pointwise:
        fwd, bwd = quant.conv_routing(in_ch, out_ch, 1, 1)
        return ("st" if fwd else None), bwd
    if groups == 1 and dilation < 6:
        fwd, bwd = quant.conv_routing(in_ch, out_ch, kernel_size, stride)
        return ("st" if fwd else None), bwd
    if kernel_size == 3 and stride == 1 and groups == 1 and default_padding:
        fwd, bwd = quant.conv_routing(in_ch, out_ch, 3, 1)
        return ("dilated" if fwd else None), bwd
    return None, False


def conv(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
         dilation: int = 1, groups: int = 1, bias: bool = False,
         padding: int | None = None, quant: QuantSpec = QUANT_OFF, pointwise: bool = False,
         parts: Optional[Sequence[int]] = None, parts_in_eval: bool = True) -> Conv2d:
    """Conv2d with torch geometry (padding (k//2)*d) unless ``padding``
    (per side) is given, as Xception's VALID stems give 0; a ``QatConv2d``
    where ``quant`` routes the site (``qat_route``; ``pointwise`` for a
    separable conv's 1x1; ``parts`` for a concat conv, each part routed as a
    1-stride conv of its own width)."""
    kw = dict(stride=stride, dilation=dilation, groups=groups, bias=bias,
              padding=torch_conv_padding(kernel_size, dilation) if padding is None else padding)
    route, bwd = qat_route(quant, in_ch, out_ch, kernel_size, stride, dilation, groups,
                           padding is None, pointwise)
    part_routes = part_bwd = ()
    if parts is not None and quant.int8:
        routing = [quant.conv_routing(c, out_ch, kernel_size, 1) for c in parts]
        part_routes = tuple(fwd for fwd, _ in routing)
        part_bwd = tuple(b for _, b in routing)
    if route is None and not any(part_routes):
        return Conv2d(in_ch, out_ch, kernel_size, **kw)
    delayed = quant.int8_scale_mode == "delayed" and not pointwise
    return QatConv2d(in_ch, out_ch, kernel_size, route=route, delayed=delayed, int8_bwd=bwd,
                     parts=parts, part_routes=part_routes, part_bwd=part_bwd,
                     parts_in_eval=parts_in_eval, **kw)


def switch_off_int8(model: nn.Module) -> None:
    """End QAT on ``model`` in place (``int8_switch_iter``): every routed conv
    runs as a plain ``Conv2d`` and drops its running amaxes, and every module
    that QAT kept off a fused path (``qat``) takes it again.  The parameters,
    and so an optimizer's references and state, are untouched."""
    for m in model.modules():
        if isinstance(m, QatConv2d):
            m.switch_off()
        elif getattr(m, "qat", False):
            m.qat = False


def quant_state(model: nn.Module) -> dict:
    """{``<conv>.x_amax[_p{i}]``: the running amax} of every delayed-mode
    site of ``model`` (empty without one)."""
    return {f"{name}.{k}": v for name, m in model.named_modules()
            if isinstance(m, QatConv2d) for k, v in m.amax_buffers().items()}


def routed_sites(model: nn.Module, training: bool) -> list:
    """The keys of the sites a forward of ``model`` in this mode routes
    (``QatConv2d.routed_sites``), in module order."""
    return [k for name, m in model.named_modules() if isinstance(m, QatConv2d)
            for k in m.routed_sites(name, training)]


class ConvBN(nn.Sequential):
    """Conv2d(bias=False) + BatchNorm + optional ReLU, as children ``0``,
    ``1`` (and ``2``) — the reference's ``nn.Sequential`` key layout."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, groups: int = 1,
                 use_relu: bool = True, bn_epsilon: float = 1e-5,
                 quant: QuantSpec = QUANT_OFF, **conv_kw):
        layers = [conv(in_ch, features, kernel_size, strides, dilation, groups, quant=quant,
                       **conv_kw),
                  BatchNorm2d(features, eps=bn_epsilon)]
        if use_relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


class AtrousSeparableConv(nn.Module):
    """Depthwise 3x3 conv (``dilation``, torch padding) then a 1x1 pointwise
    conv, as ``body.0`` and ``body.1``: the key layout of the reference's
    ``AtrousSeparableConvolution``."""

    def __init__(self, in_ch: int, features: int, dilation: int = 1,
                 quant: QuantSpec = QUANT_OFF):
        super().__init__()
        self.body = nn.Sequential(
            conv(in_ch, in_ch, 3, dilation=dilation, groups=in_ch),
            conv(in_ch, features, 1, quant=quant, pointwise=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class SeparableConvBN(nn.Sequential):
    """The head's atrous separable 3x3 conv + BatchNorm + ReLU, as children
    ``0`` (``AtrousSeparableConv``), ``1``, ``2``: the JAX package's
    ``SeparableConvBN`` in ``ConvBN``'s key layout.  Depthwise convs run
    through cuDNN (``groups=``)."""

    def __init__(self, in_ch: int, features: int, dilation: int = 1,
                 quant: QuantSpec = QUANT_OFF):
        super().__init__(AtrousSeparableConv(in_ch, features, dilation, quant),
                         BatchNorm2d(features), nn.ReLU(inplace=True))


class FusedStemPool(nn.Module):
    """The stem's conv + BatchNorm + ReLU + ``MaxPool2d(3, 2, 1)`` with the
    chain after the conv fused (``ops/kernels/fused_stem.py``): statistics and
    normalize + ReLU + pool forward, and a backward that recomputes the pool's
    argmax and contracts dz straight into the conv's weight gradient.

    It owns no parameter: ``forward`` takes the stem's own ``Conv2d`` and
    ``BatchNorm2d``, so the state-dict keys are those of the unfused stem and
    checkpoints interchange.  Pool-gradient ties are EQUAL-SPLIT and the image
    gets no gradient (see the kernel module's docstring); the eval-mode forward
    cannot be differentiated at all (its backward raises).  In train mode the
    statistics are summed over ``spatial.statistics_group()`` (the split's
    data group, where ``ResNet.stem`` runs it on a model group's whole
    image)."""

    def forward(self, x: torch.Tensor, conv1: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
        from ..ops.kernels.fused_stem import stem_fused_eval, stem_fused_train

        if (conv1.kernel_size, conv1.stride, conv1.padding) != ((7, 7), (2, 2), (3, 3)):
            raise ValueError("FusedStemPool is specialized to the 7x7 / stride 2 / pad 3 stem")
        if bn.training:
            p, mean, var = stem_fused_train(x, conv1.weight, bn.weight, bn.bias, bn.eps,
                                            spatial.statistics_group())
            if recomputing():  # a rematerialized segment updates them once
                return p
            with torch.no_grad():  # flax's update: the biased batch variance
                bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
                bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
                bn.num_batches_tracked.add_(1)
            return p
        sigma_inv = torch.rsqrt(bn.running_var.float() + bn.eps)
        scale = bn.weight.float() * sigma_inv
        bias = bn.bias.float() - bn.running_mean.float() * scale
        return stem_fused_eval(x, conv1.weight, scale, bias)


def fused_stem_eligible(x_shape, kernel_size: int = 7) -> bool:
    """The fused stem is specialized to the 7x7 / stride 2 stem and needs a
    square NCHW input whose side is divisible by 4 (a conv output that the pool
    halves) and at least 8."""
    h, w = x_shape[2], x_shape[3]
    return kernel_size == 7 and h % 4 == 0 and w % 4 == 0 and h == w and h >= 8


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init as the JAX package's: kaiming-normal (fan-in, gain 2)
    conv weights, zero conv biases, BatchNorm at identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
