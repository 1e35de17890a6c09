"""The int8 compute path of ``int8_exec_xla`` serving, the counterpart of
``iswm_tpu/ops/int8_xla.py`` (whose name it keeps so that a reader finds it).

The JAX module hands int8 convs and matmuls to XLA's own lowering.  Here, on
the card, every function runs hand-written CUDA: the activation quantize and
the int8 convs of ``ops/kernels/int8_conv.py`` (``csrc/int8_conv.cu``), and,
for a matmul or 1x1 conv whose channel counts it takes, the int8 matmul #1 of
``ops/kernels/int8_matmul.py``.  On a CPU tensor each kernel's plain version
runs instead.

Quantization contract (the JAX module's, and #1's): a symmetric per-tensor
activation scale (codes clipped to +-127, rounded half to even after an IEEE
division), per-output-channel weight scales, an int32 sum, and the epilogue
``(float(acc) * x_scale) * w_scale`` in float32.

Layouts are the port's: activations NHWC, conv weights OIHW (PyTorch's, as
``quantize_params_int8`` stores them), ``w_scale`` [Cout] (any shape with
Cout values).  :func:`int8_conv` is the conv that every function here and
every routed module of ``int8_exec_xla`` serving runs (``Int8Conv`` and
``Int8ConcatConvBN`` in ``infer/quantization.py``, which lay their weights
out as OHWI once); the seven functions named as the JAX module's keep its
API for callers of that module.  The two TPU lowerings of a plain conv are not carried over:
:func:`int8_packed_stem_conv` runs the unpacked 7x7 / stride-2 / pad-3 conv
(K = 147) and :func:`int8_shifted_dilated_conv` the plain dilated 3x3 conv; a
tap in the zero padding adds 0, so the numbers are the same.
"""

from __future__ import annotations

import torch

from .kernels.int8_conv import conv_s8_direct, conv_s8_igemm, quantize_s8
from .kernels.int8_matmul import int8_matmul, int8_matmul_prequant, quantized_conv1x1


def quantize_activations(x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """float [...] -> int8 with a symmetric per-tensor scale."""
    return quantize_s8(x, x_scale)


def _matmul_fits(k: int, n: int) -> bool:
    """The shapes the int8 matmul #1 takes."""
    return k % 128 == 0 and n % 128 == 0


def int8_matmul_xla(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    x_scale: float) -> torch.Tensor:
    """[M, K] float @ [K, N] int8 -> [M, N] float32: #1 where K and N are
    multiples of 128, else the int8 conv as a 1x1 over the rows."""
    k, n = w_q.shape
    if _matmul_fits(k, n):
        return int8_matmul(x, w_q, w_scale, x_scale)
    x_q = quantize_s8(x.contiguous(), x_scale)
    return int8_matmul_prequant_xla(x_q, w_q, w_scale, x_scale)


def int8_matmul_prequant_xla(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                             x_scale: float) -> torch.Tensor:
    """:func:`int8_matmul_xla` with the codes ``x_q`` [M, K] int8 given."""
    k, n = w_q.shape
    if _matmul_fits(k, n):
        return int8_matmul_prequant(x_q, w_q, w_scale, x_scale)
    rows = x_q.contiguous().reshape(1, 1, x_q.shape[0], k)  # a 1 x 1 conv over the rows
    out = conv_s8_igemm(rows, w_q.t().reshape(n, 1, 1, k), w_scale, x_scale)
    return out.reshape(x_q.shape[0], n)


def _padding(padding):
    """JAX's ``"VALID"``, an int, ``(ph, pw)`` or ``((top, bottom), (left,
    right))``."""
    if isinstance(padding, str):
        if padding.upper() != "VALID":
            raise ValueError(f"padding {padding!r}: give explicit pads")
        return 0
    return padding


def int8_conv(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor, x_scale: float,
              bias: torch.Tensor | None = None, *, stride=1, padding=0, dilation=1,
              groups: int = 1, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [B, H, W, Cin] float (on the card, rows of contiguous channels: a
    channel slice of an NHWC tensor will do), w [Cout, kh, kw, Cin / groups]
    int8 (OHWI) -> [B, Ho, Wo, Cout] in ``out_dtype`` (float32, or its bf16
    rounding): x quantized with ``x_scale``, then a dense conv on the tensor
    cores (``conv_s8_igemm``) or a grouped or depthwise one on the CUDA cores
    (``conv_s8_direct``), its epilogue ``(acc * x_scale) * w_scale (+
    bias)``.  Each output channel contracts only its group's inputs, and the
    per-tensor x scale times the per-O w scale factors out of the group's sum
    as out of the dense one."""
    x_q = quantize_s8(x, x_scale)
    geometry = dict(stride=stride, padding=padding, dilation=dilation, out_dtype=out_dtype)
    if groups == 1:
        return conv_s8_igemm(x_q, w, w_scale, x_scale, bias, **geometry)
    return conv_s8_direct(x_q, w, w_scale, x_scale, bias, groups=groups, **geometry)


def quantized_conv_xla(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float, *,
    strides=(1, 1), padding="VALID", dilation=(1, 1), feature_group_count: int = 1,
) -> torch.Tensor:
    """General conv with int8 operands: x [B, H, W, Cin] float, w_q [Cout,
    Cin / groups, kh, kw] int8 -> [B, Ho, Wo, Cout] float32, through
    :func:`int8_conv`.  Zero padding is exact under symmetric quantization."""
    return int8_conv(x, w_q.permute(0, 2, 3, 1), w_scale, x_scale, stride=strides,
                     padding=_padding(padding), dilation=dilation, groups=feature_group_count)


def int8_packed_stem_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                          x_scale: float, k: int) -> torch.Tensor:
    """int8 execution of the stride-2 stem conv (the reference's ResNet stem
    Conv2d(3, 64, 7, stride=2, padding=3)): the input quantized at full
    resolution, then the k x k / stride-2 / pad k // 2 int8 conv.  The JAX
    module packs 2 x 2 pixels into channels first, a TPU lowering that gives
    the same numbers."""
    return quantized_conv_xla(x, w_q, w_scale, x_scale, strides=2, padding=k // 2)


def int8_shifted_dilated_conv(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
                              x_scale: float, d: int) -> torch.Tensor:
    """int8 3 x 3 atrous conv, dilation and padding ``d``, stride 1: the math
    of ``Conv2d(3, 3, dilation=d, padding=d)`` under the symmetric contract.
    The JAX module sums the taps' valid windows; a tap in the padding adds 0
    here."""
    return quantized_conv_xla(x, kernel_q, w_scale, x_scale, padding=d, dilation=d)


def quantized_conv1x1_xla(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                          x_scale: float) -> torch.Tensor:
    """1 x 1 conv, x [B, H, W, Cin] float, w_q [Cout, Cin, 1, 1] int8 ->
    [B, H, W, Cout] float32: #1 where Cin and Cout are multiples of 128, else
    the int8 conv."""
    cout, cin = w_q.shape[:2]
    if _matmul_fits(cin, cout):
        return quantized_conv1x1(x, w_q, w_scale, x_scale)
    return quantized_conv_xla(x, w_q, w_scale, x_scale)
