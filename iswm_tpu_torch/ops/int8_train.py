"""Quantization-aware training convs (QAT: an int8 forward with
straight-through gradients), the counterpart of the forward half of
``iswm_tpu/ops/int8_train.py``.

  fwd:  out = dequant(conv_int8(quant(x), quant(W))): a per-tensor symmetric
        activation scale from an amax (dynamic: this tensor's; delayed: a
        running amax carried by the module), per-output-channel weight scales,
        an int32 sum, ``(float(acc) * x_scale) * w_scale`` in float32, cast to
        the compute dtype
  bwd:  straight-through: the cotangents of the DENSE conv at the unquantized
        (x, W), in the compute dtype (``aten.convolution_backward``)

On the card the forward is two hand-written kernels of ``csrc/int8_conv.cu``
(``ops/kernels/int8_conv.py``): ``quantize_s8`` and the dense
``conv_s8_igemm``, both given the amax as a 0-d device tensor, from which they
form the scale ``amax > 0 ? amax / 127 : 1``.  The amax (``max |x|``) and the
per-channel weight quantize are ATen passes on the device.  Nothing on this
path reads a value back to the host.  On a CPU tensor the kernels' plain
versions run.

Layouts are the port's: x NCHW (channels last on the card, whose NHWC view the
kernels read), w OIHW.  The JAX package's ``int8_dilated_conv3x3`` sums the
valid taps of an atrous 3x3; here it is the same dense conv (a padding tap
adds 0).  The int8 backward (``int8_bwd``, the JAX package's
``int8_conv_fullq*`` and ``_dil_bwd``) is not ported and is refused.

In a process group a TRAINING forward takes the amax over every rank's rows
(an all-reduce with MAX), as the JAX package's does over the global batch
under a sharded jit; the new running amax of the delayed mode is then the
same on every rank.  An eval forward runs on one rank with the whole batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.distributed import is_initialized
from .kernels.int8_conv import conv_s8_igemm, ieee_div, quantize_s8

INT8_BWD_ITEM = "ROADMAP.md Queue 1, 'Quantization-aware training, int8 backward'"
AMAX_DECAY = 0.999

# all-reduces of an amax across the ranks of a process group
amax_all_reduces = 0


def _refuse_int8_bwd(int8_bwd: bool) -> None:
    if int8_bwd:
        raise NotImplementedError(f"the int8 backward of QAT is not ported yet ({INT8_BWD_ITEM})")


def activation_amax(x: torch.Tensor, across_ranks: bool = False) -> torch.Tensor:
    """``max |x|`` as a 0-d float32 tensor on x's device, carrying no
    gradient; with ``across_ranks``, in a process group, the max over every
    rank's (an all-reduce with MAX)."""
    amax = torch.linalg.vector_norm(x.detach(), float("inf")).to(torch.float32)
    if across_ranks and is_initialized():
        global amax_all_reduces
        amax_all_reduces += 1
        torch.distributed.all_reduce(amax, op=torch.distributed.ReduceOp.MAX)
    return amax


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW kernel (``_dyn_quant_w``):
    (codes [O, kh, kw, I] OHWI contiguous, as the dense conv reads them;
    scales [O] float32), ``scale = amax > 0 ? amax / 127 : 1`` over each
    output channel, codes ``clip(round(w / scale), -127, 127)`` in float32."""
    wf = w.detach().permute(0, 2, 3, 1).float()
    amax = torch.linalg.vector_norm(wf, float("inf"), dim=(1, 2, 3))
    scale = torch.where(amax > 0, ieee_div(amax, 127.0), torch.ones_like(amax))
    codes = torch.clamp(torch.round(wf / scale.reshape(-1, 1, 1, 1)), -127, 127)
    return codes.to(torch.int8).contiguous(), scale


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of NCHW x, copied on the card only where its rows of
    channels do not collapse to one stride (a channels-last tensor or a
    channel slice of one gives the view as it is)."""
    v = x.permute(0, 2, 3, 1)
    if v.device.type != "cuda":
        return v
    b, h, w, c = v.shape
    ok = v.stride(3) == 1 or c == 1
    ok = ok and (w == 1 or h * w == 1 or v.stride(1) == v.stride(2) * w)
    ok = ok and (b == 1 or v.stride(0) == v.stride(1) * h)
    return v if ok else v.contiguous()


def int8_conv_forward(x: torch.Tensor, w: torch.Tensor, x_amax: torch.Tensor, stride=1,
                      padding=0, dilation=1) -> torch.Tensor:
    """The int8 forward: x [B, C, H, W] in the compute dtype, w [N, C, kh,
    kw] in the compute dtype, the activation amax (0-d float32 on x's device)
    -> [B, N, Ho, Wo] in x's dtype.  The conv writes float32 or (for bf16 x)
    the bf16 rounding of the float32 value from its epilogue."""
    w_q, w_s = quantize_weight(w)
    x_q = quantize_s8(_rows_view(x), x_amax)
    out_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) else torch.float32
    out = conv_s8_igemm(x_q, w_q, w_s, x_amax, None, stride, padding, dilation,
                        out_dtype=out_dtype)
    return out.permute(0, 3, 1, 2).to(x.dtype)


def _pair(v) -> list:
    return [v, v] if isinstance(v, int) else [int(v[0]), int(v[1])]


class Int8ConvST(torch.autograd.Function):
    """conv(x, w) with :func:`int8_conv_forward` as its forward and the dense
    conv's VJP at (x, w) as its backward; the amax gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, x_amax, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.geometry = (_pair(stride), _pair(padding), _pair(dilation))
        return int8_conv_forward(x, w, x_amax, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.geometry
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, stride, padding, dilation, False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None


def int8_conv_st(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, dilation=1,
                 int8_bwd: bool = False, across_ranks: bool = False) -> torch.Tensor:
    """Dense conv whose forward runs int8 with a DYNAMIC activation scale
    (this tensor's amax) and whose gradients are the dense conv's."""
    _refuse_int8_bwd(int8_bwd)
    return Int8ConvST.apply(x, w, activation_amax(x, across_ranks), stride, padding, dilation)


def int8_conv_static_amax(x: torch.Tensor, w: torch.Tensor, x_amax: torch.Tensor, stride=1,
                          padding=0, dilation=1, amax_decay: float = AMAX_DECAY,
                          int8_bwd: bool = False, across_ranks: bool = False,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-forward conv with a DELAYED activation scale: quantizes with the
    running ``x_amax`` (0-d float32, stale) and returns ``(out, new_amax)``,
    ``new_amax = max(max |x|, decay * x_amax)``, the caller's next running
    amax.  Gradients as :func:`int8_conv_st`."""
    _refuse_int8_bwd(int8_bwd)
    cur = activation_amax(x, across_ranks)
    out = Int8ConvST.apply(x, w, x_amax, stride, padding, dilation)
    return out, torch.maximum(cur, x_amax.to(torch.float32) * amax_decay)


def int8_dilated_conv3x3(x: torch.Tensor, w: torch.Tensor, d: int, int8_bwd: bool = False,
                         across_ranks: bool = False) -> torch.Tensor:
    """QAT atrous 3x3 (dilation and padding ``d``, stride 1) with a dynamic
    scale: the math of ``Conv2d(3, 3, dilation=d, padding=d)`` under the
    symmetric contract; the dense backward (straight-through)."""
    return int8_conv_st(x, w, 1, d, d, int8_bwd, across_ranks)


# ------------------------------------------------ per-site routing cost model
# The JAX package's roofline model, kept with its v5e constants: it decides
# which sites route, and the routed sites are a contract held against it.
V5E_BF16_TFLOPS = 197.0
V5E_INT8_TOPS = 394.0
V5E_HBM_GBPS = 819.0


def int8_cost_route(cin: int, cout: int, k: int, stride: int, *, delayed: bool = False,
                    want_bwd: bool = False, quant_bytes: float = 3.0) -> Tuple[bool, bool]:
    """(route_fwd, route_bwd) for one conv site, from static geometry: the
    MXU time an int8 forward saves per input value (``2 k^2 cout / stride^2``
    MACs at the bf16 and int8 peaks) against the HBM time of its quantize
    (``quant_bytes`` a value, a third of it in the delayed mode); the
    backward follows the forward and weighs the cotangent's quantize."""
    mxu_sec_saved = (
        2.0 * k * k * cout / (stride * stride)
        * (1.0 / (V5E_BF16_TFLOPS * 1e12) - 1.0 / (V5E_INT8_TOPS * 1e12))
    )
    q_sec = quant_bytes / (V5E_HBM_GBPS * 1e9)
    if delayed:
        q_sec /= 3.0
    fwd = mxu_sec_saved > q_sec
    if not (fwd and want_bwd):
        return fwd, False
    g_values_per_input = cout / (cin * stride * stride)
    bwd_cost = (quant_bytes / (V5E_HBM_GBPS * 1e9)) * g_values_per_input
    return True, 2.0 * mxu_sec_saved > bwd_cost
