"""Quantization-aware training convs (QAT: an int8 forward, and with
``int8_bwd`` an int8 backward too), the counterpart of
``iswm_tpu/ops/int8_train.py``.

  fwd:  out = dequant(conv_int8(quant(x), quant(W))): a per-tensor symmetric
        activation scale from an amax (dynamic: this tensor's; delayed: a
        running amax carried by the module), per-output-channel weight scales,
        an int32 sum, ``(float(acc) * x_scale) * w_scale`` in float32, cast to
        the compute dtype
  bwd:  straight-through (``int8_conv_st``, ``int8_conv_static_amax``): the
        cotangents of the DENSE conv at the unquantized (x, W), in the compute
        dtype (``aten.convolution_backward``); or int8 (``int8_conv_fullq``,
        ``int8_conv_fullq_static``, ``int8_dilated_conv3x3(..., int8_bwd=True)``):
        the cotangent g quantized per tensor with its dynamic amax, the data
        gradient an int8 conv of g_q with the rotated, I/O-swapped kernel
        re-quantized per tensor, ``float(acc) * (g_s * w_s)`` in x's dtype,
        and the weight gradient the product over pixels of the forward's own
        int8 codes x_q with g_q, ``float(acc) * (x_s * g_s)`` in w's dtype
        (the forward keeps x_q and its amax, not x)

On the card these are hand-written kernels of ``csrc/int8_conv.cu``
(``ops/kernels/int8_conv.py``): the quantize, the dense ``conv_s8_igemm``
forward, ``conv_s8_dgrad`` and ``conv_s8_wgrad`` backward, all given their
amaxes as 0-d device tensors, from which they form the scales ``amax > 0 ?
amax / 127 : 1``.  An activation or cotangent is quantized by
:func:`quantize_activation` in one launch that also reduces its amax
(``quantize_s8_reduce``: ``dynamic`` forms ``max |x|`` and the codes with
its scale; ``delayed`` the codes of the running amax beside ``max |x|``).
In a process group the all-reduce of the amax must sit between the max and
the codes: the kernel's ``amax`` mode gives the local max (one launch), the
all-reduce follows, then ``quantize_s8`` with the global amax.  The data
gradient's rotated per-tensor weight codes come from
``rotated_weight_codes`` (one launch); the forward's per-channel weight
quantize is ATen work on the device.  Nothing on this path reads a value
back to the host.  On a CPU tensor the kernels' plain versions run.

Layouts are the port's: x NCHW (channels last on the card, whose NHWC view the
kernels read), w OIHW.  The JAX package's ``int8_dilated_conv3x3`` sums the
valid taps of an atrous 3x3; here it is the same dense conv (a padding tap
adds 0), forward and backward.

In a process group a TRAINING forward takes the amax over every rank's rows
(an all-reduce with MAX), as the JAX package's does over the global batch
under a sharded jit, and so does its int8 backward for g's amax; the new
running amax of the delayed mode is then the same on every rank.  An eval
forward runs on one rank with the whole batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.distributed import is_initialized
from .kernels.int8_conv import (conv_s8_dgrad, conv_s8_igemm, conv_s8_wgrad, ieee_div,
                                quantize_s8, quantize_s8_reduce, rotated_weight_codes)

AMAX_DECAY = 0.999

# all-reduces of an amax across the ranks of a process group
amax_all_reduces = 0


def _all_reduce_max(amax: torch.Tensor) -> torch.Tensor:
    global amax_all_reduces
    amax_all_reduces += 1
    torch.distributed.all_reduce(amax, op=torch.distributed.ReduceOp.MAX)
    return amax


def activation_amax(x: torch.Tensor, across_ranks: bool = False) -> torch.Tensor:
    """``max |x|`` as a 0-d float32 tensor on x's device, carrying no
    gradient; with ``across_ranks``, in a process group, the max over every
    rank's (an all-reduce with MAX).  The plain version of the amax that
    :func:`quantize_activation` reduces in its quantize."""
    amax = torch.linalg.vector_norm(x.detach(), float("inf")).to(torch.float32)
    if across_ranks and is_initialized():
        _all_reduce_max(amax)
    return amax


def quantize_activation(x: torch.Tensor, across_ranks: bool = False,
                        running: torch.Tensor | None = None) -> Tuple[torch.Tensor, ...]:
    """x's int8 codes (the NHWC rows of NCHW x, [B, H, W, C]), the amax they
    were made with and ``max |x|`` (``across_ranks`` in a process group: over
    every rank's rows, an all-reduce with MAX).  Dynamic (``running`` None):
    the amax is ``max |x|``, one launch, or in a group the max alone, the
    all-reduce, then the codes; delayed: the running amax (0-d float32), its
    codes and ``max |x|`` in one launch, the all-reduce after."""
    rows = _rows_view(x.detach())
    group = across_ranks and is_initialized()
    if running is not None:
        x_q, cur = quantize_s8_reduce(rows, "delayed", running)
        return x_q, running, _all_reduce_max(cur) if group else cur
    if group:
        amax = _all_reduce_max(quantize_s8_reduce(rows, "amax")[1])
        return quantize_s8(rows, amax), amax, amax
    x_q, amax = quantize_s8_reduce(rows, "dynamic")
    return x_q, amax, amax


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


def quantize_weight_rotated(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 of an OIHW kernel, as the data gradient takes
    it (``_int8_dgrad``): (codes of the rotated, I/O-swapped kernel [I, kh,
    kw, O] contiguous, ``w_rot[i, a, b, o] = w[o, i, kh - 1 - a, kw - 1 - b]``;
    the amax, 0-d float32), codes ``clip(round(w / scale), -127, 127)``.  The
    plain version the tests hold ``rotated_weight_codes`` against (the
    backward's weights, made on the card as the dense body's rows)."""
    wf = w.detach().flip(2, 3).permute(1, 2, 3, 0).float()
    amax = torch.linalg.vector_norm(wf, float("inf"))
    scale = torch.where(amax > 0, ieee_div(amax, 127.0), torch.ones_like(amax))
    codes = torch.clamp(torch.round(wf / scale), -127, 127)
    return codes.to(torch.int8).contiguous(), amax


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


def _kernel_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a kernel writes for a tensor of ``dtype``: its own where the
    kernels write it (float32, bf16), else float32, cast after."""
    return dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32


def int8_conv_forward(x_q: torch.Tensor, w: torch.Tensor, x_amax: torch.Tensor, stride=1,
                      padding=0, dilation=1, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 forward: x's codes [B, H, W, C] (:func:`quantize_activation`),
    w [N, C, kh, kw] in the compute dtype, the amax of the codes (0-d float32
    on their device) -> out [B, N, Ho, Wo] in ``dtype``, x's.  The conv
    writes float32 or (for bf16) the bf16 rounding of the float32 value from
    its epilogue."""
    w_q, w_s = quantize_weight(w)
    out = conv_s8_igemm(x_q, w_q, w_s, x_amax, None, stride, padding, dilation,
                        out_dtype=_kernel_dtype(dtype))
    return out.permute(0, 3, 1, 2).to(dtype)


def _pair(v) -> list:
    return [v, v] if isinstance(v, int) else [int(v[0]), int(v[1])]


class Int8ConvST(torch.autograd.Function):
    """conv(x, w) with :func:`int8_conv_forward` on x's codes x_q as its
    forward and the dense conv's VJP at (x, w) as its backward; the codes and
    the amax get no gradient."""

    @staticmethod
    def forward(ctx, x, w, x_q, x_amax, stride, padding, dilation):
        ctx.save_for_backward(x, w)
        ctx.geometry = (_pair(stride), _pair(padding), _pair(dilation))
        return int8_conv_forward(x_q, w, x_amax, stride, padding, dilation, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation = ctx.geometry
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, stride, padding, dilation, False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None, None, None


class Int8ConvFullQ(torch.autograd.Function):
    """conv(x, w) with :func:`int8_conv_forward` as its forward, keeping x's
    int8 codes and the amax they were made with (not x), and an int8
    backward (the JAX package's ``_fullq_bwd``): g's dynamic amax (over every
    rank's rows where ``across_ranks``, in a process group), g's codes, then
    the data gradient (where x needs one; its weights' rotated codes made on
    the card) and the weight gradient."""

    @staticmethod
    def forward(ctx, x, w, x_q, x_amax, stride, padding, dilation, across_ranks):
        out = int8_conv_forward(x_q, w, x_amax, stride, padding, dilation, x.dtype)
        ctx.save_for_backward(x_q, x_amax, w)
        ctx.geometry = (_pair(stride), _pair(padding), _pair(dilation))
        ctx.x_dtype, ctx.across_ranks = x.dtype, across_ranks
        return out

    @staticmethod
    def backward(ctx, g):
        x_q, x_amax, w = ctx.saved_tensors
        geometry = ctx.geometry
        g_q, g_amax, _ = quantize_activation(g, ctx.across_ranks)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_rows, w_amax = rotated_weight_codes(w, geometry[0])
            dx = conv_s8_dgrad(g_q, w_rows, g_amax, w_amax, x_q.shape[1:3], *geometry,
                               out_dtype=_kernel_dtype(ctx.x_dtype), kernel_size=w.shape[2:])
            dx = dx.permute(0, 3, 1, 2).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = conv_s8_wgrad(x_q, g_q, x_amax, g_amax, w.shape[2:], *geometry,
                               out_dtype=_kernel_dtype(w.dtype)).to(w.dtype)
        return dx, dw, None, None, None, None, None, None


def int8_conv_st(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, dilation=1,
                 across_ranks: bool = False) -> torch.Tensor:
    """Dense conv whose forward runs int8 with a DYNAMIC activation scale
    (this tensor's amax) and whose gradients are the dense conv's."""
    x_q, amax, _ = quantize_activation(x, across_ranks)
    return Int8ConvST.apply(x, w, x_q, amax, stride, padding, dilation)


def int8_conv_static_amax(x: torch.Tensor, w: torch.Tensor, x_amax: torch.Tensor, stride=1,
                          padding=0, dilation=1, amax_decay: float = AMAX_DECAY,
                          across_ranks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-forward conv with a DELAYED activation scale: quantizes with the
    running ``x_amax`` (0-d float32, stale) and returns ``(out, new_amax)``,
    ``new_amax = max(max |x|, decay * x_amax)``, the caller's next running
    amax.  Gradients as :func:`int8_conv_st`."""
    x_q, _, cur = quantize_activation(x, across_ranks, x_amax)
    out = Int8ConvST.apply(x, w, x_q, x_amax, stride, padding, dilation)
    return out, torch.maximum(cur, x_amax.to(torch.float32) * amax_decay)


def int8_conv_fullq(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, dilation=1,
                    across_ranks: bool = False) -> torch.Tensor:
    """Conv whose forward AND backward run int8: the forward as
    :func:`int8_conv_st`'s, the backward :class:`Int8ConvFullQ`'s."""
    x_q, amax, _ = quantize_activation(x, across_ranks)
    return Int8ConvFullQ.apply(x, w, x_q, amax, stride, padding, dilation, across_ranks)


def int8_conv_fullq_static(x: torch.Tensor, w: torch.Tensor, x_amax: torch.Tensor, stride=1,
                           padding=0, dilation=1, amax_decay: float = AMAX_DECAY,
                           across_ranks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_conv_fullq` with a DELAYED forward activation scale, as
    :func:`int8_conv_static_amax` returns it: ``(out, new_amax)``; the
    backward's cotangent scale is dynamic.  The weight gradient reads the
    amax the forward quantized with: a copy, as the caller updates its
    running amax in place."""
    x_q, _, cur = quantize_activation(x, across_ranks, x_amax)
    out = Int8ConvFullQ.apply(x, w, x_q, x_amax.detach().clone(), stride, padding, dilation,
                              across_ranks)
    return out, torch.maximum(cur, x_amax.to(torch.float32) * amax_decay)


def int8_dilated_conv3x3(x: torch.Tensor, w: torch.Tensor, d: int, int8_bwd: bool = False,
                         across_ranks: bool = False, padding=None) -> torch.Tensor:
    """QAT atrous 3x3 (dilation and padding ``d``, stride 1) with a dynamic
    scale: the math of ``Conv2d(3, 3, dilation=d, padding=d)`` under the
    symmetric contract; the dense backward (straight-through), or the int8
    one with ``int8_bwd``.  ``padding`` (``(ph, pw)``) replaces d's: under
    ``parallel/spatial.py``'s split x holds a rank's rows with their halo,
    ``(0, d)``."""
    fn = int8_conv_fullq if int8_bwd else int8_conv_st
    return fn(x, w, 1, d if padding is None else padding, d, across_ranks)


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
