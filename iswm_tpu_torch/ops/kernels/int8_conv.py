"""int8 convolutions: the CUDA kernels ``csrc/int8_conv.cu`` for Hopper,
their wrappers and their plain versions.

What the JAX package's ``int8_exec_xla`` serving leaves to XLA
(``iswm_tpu/ops/int8_xla.py``: ``quantize_activations``, ``quantized_conv_xla``
and the two TPU lowerings of a plain conv), as three entries:

- :func:`quantize_s8`: float x -> ``clip(round(x / x_scale), -127, 127)``
  int8, rounding half to even, through an IEEE division;
- :func:`conv_s8_igemm`: a dense int8 conv of NHWC codes x_q [B, H, W, C]
  and weights w_q [N, KH, KW, C] (OHWI), any stride, padding and dilation,
  summed in int32 on the tensor cores, ``out = (float(acc) * x_scale) *
  w_scale[n] (+ bias[n])`` in float32, [B, Ho, Wo, N];
- :func:`conv_s8_direct`: the same for a grouped or depthwise conv, w_q
  [N, KH, KW, C / groups], on the CUDA cores.

``x_scale`` is a Python float (absmax / 127 in double, as calibration returns
it), rounded to float32 once, at the kernel boundary, as the JAX package
does.  A padding is an int, ``(ph, pw)`` (each side) or ``((top, bottom),
(left, right))``.

Each wrapper launches its kernel for a CUDA tensor and uses its plain version
only for a CPU tensor; on a CUDA tensor a call the kernel does not take
raises.  The plain conv is ``F.conv2d`` in float64 on the integer codes,
exact while 127^2 K < 2^53, rounded to int32, then the same epilogue.
``launches_quantize``, ``launches_igemm`` and ``launches_direct`` count the
launches of each kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

launches_quantize = 0
launches_igemm = 0
launches_direct = 0
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C entries of a library
    built from ``csrc/int8_conv.cu``."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.iswm_int8_quantize.argtypes = [ptr, i32, f32, ptr, i32, i32, i64, ptr]
    lib.iswm_int8_quantize.restype = i32
    geom = ctypes.POINTER(i32)
    lib.iswm_int8_conv_igemm.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, geom, ptr]
    lib.iswm_int8_conv_igemm.restype = i32
    lib.iswm_int8_conv_direct.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, geom, i32, ptr]
    lib.iswm_int8_conv_direct.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernels; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("int8_conv")
        _lib = bind(lib)
    return _lib, log


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _pads(padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """``int``, ``(ph, pw)`` or ``((top, bottom), (left, right))``."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    ph, pw = padding
    return (_pair(ph), _pair(pw))


def conv_geometry(x_shape, w_shape, stride=1, padding=0, dilation=1, groups=1) -> dict:
    """Output extent and the kernel's geometry for NHWC x and OHWI w."""
    b, h, w, c = x_shape
    n, kh, kw, cg = w_shape
    if c != cg * groups or n % groups:
        raise ValueError(f"x has {c} channels, w {tuple(w_shape)} with {groups} groups")
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = _pads(padding)
    ho = (h + pt + pb - dh * (kh - 1) - 1) // sh + 1
    wo = (w + pl + pr - dw * (kw - 1) - 1) // sw + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for x {tuple(x_shape)}, w {tuple(w_shape)}")
    return dict(B=b, H=h, W=w, C=c, Ho=ho, Wo=wo, N=n, KH=kh, KW=kw, sh=sh, sw=sw, ph=pt,
                pw=pl, dh=dh, dw=dw, pads=((pt, pb), (pl, pr)))


# ---------------------------------------------------------------- quantize
def quantize_s8_plain(x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """``clip(round(x / x_scale), -127, 127)`` as int8, in float32."""
    xs = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)


def _rows(x: torch.Tensor) -> tuple[int, int, int]:
    """(rows, C, row stride) of x as rows of its last, contiguous dim whose
    leading dims collapse to one stride; raises otherwise."""
    c = x.shape[-1]
    ok = x.dim() >= 1 and (x.stride(-1) == 1 or c == 1)
    ld = x.stride(-2) if x.dim() >= 2 else c
    for i in range(x.dim() - 2):
        ok = ok and (x.shape[i] == 1 or x.stride(i) == x.stride(i + 1) * x.shape[i + 1])
    if not ok:
        raise ValueError(f"x must be rows of contiguous channels with one row stride, got "
                         f"strides {x.stride()} for {tuple(x.shape)}")
    return x.numel() // max(c, 1), c, ld


def quantize_s8(x: torch.Tensor, x_scale: float) -> torch.Tensor:
    """bf16 / f32 x [..., C] -> int8 codes of x's shape, contiguous.  On the
    card x may be a channel slice of a contiguous NHWC tensor (rows of one
    stride)."""
    if x.device.type == "cpu":
        return quantize_s8_plain(x, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_s8 runs on CUDA or CPU, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    p, c, ld = _rows(x)
    if p * c >= 2**31:
        raise ValueError(f"quantize_s8: {p * c} values do not fit the kernel's int indices")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if p == 0 or c == 0:
        return out
    lib, _ = load_library()
    global launches_quantize
    with torch.cuda.device(x.device):
        launches_quantize += 1
        rc = lib.iswm_int8_quantize(x.data_ptr(), int(x.dtype == torch.bfloat16), x_scale,
                                    out.data_ptr(), p, c, ld,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, lib, "quantize_s8")
    return out


def _raise_on(rc: int, lib, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: {lib.iswm_cuda_error_string(rc).decode()}")


# ------------------------------------------------------------------- convs
def conv_s8_plain(x_q, w_q, w_scale, x_scale, bias=None, stride=1, padding=0,
                  dilation=1, groups=1) -> torch.Tensor:
    """The plain version of both convs: int8 NHWC x_q, OHWI w_q (C / groups
    input channels) -> [B, Ho, Wo, N] float32.  The integer products are
    summed in float64 (exact), rounded to int32, then ``(acc * x_scale) *
    w_scale (+ bias)`` in float32."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    g = conv_geometry(x_q.shape, w_q.shape, stride, padding, dilation, groups)
    (pt, pb), (pl, pr) = g["pads"]
    xd = F.pad(x_q.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w_q.permute(0, 3, 1, 2).double(), None, (g["sh"], g["sw"]), 0,
                   (g["dh"], g["dw"]), groups)
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)
    xs = torch.tensor(x_scale, dtype=torch.float32, device=x_q.device)
    out = acc.float() * xs * w_scale.float().reshape(-1)
    if bias is not None:
        out = out + bias.float().reshape(-1)
    return out.contiguous()


def _weight_rows(w_q: torch.Tensor) -> torch.Tensor:
    """OHWI int8 w_q -> [N, ldw] rows of (kh, kw, c), ldw = K rounded up to
    16 and zero past K, as the dense kernel reads them; a view of contiguous
    w_q when K is a multiple of 16."""
    n, k = w_q.shape[0], w_q[0].numel()
    rows = w_q.reshape(n, k)
    if k % 16 == 0:
        return rows.contiguous()
    return F.pad(rows, (0, 16 - k % 16))


def _launch(kind: str, x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
            groups) -> torch.Tensor:
    name = f"conv_s8_{kind}"
    if x_q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    if torch.cuda.get_device_capability(x_q.device) != (9, 0):
        raise RuntimeError(f"the {name} kernel is built for sm_90a (H100/H200)")
    g = conv_geometry(x_q.shape, w_q.shape, stride, padding, dilation, groups)
    if (kind == "igemm") != (groups == 1):
        raise ValueError(f"{name} takes {'groups 1' if kind == 'igemm' else 'groups > 1'}, "
                         f"got {groups}")
    if not x_q.is_contiguous() or x_q.data_ptr() % 16:
        raise ValueError(f"x_q must be contiguous NHWC and 16-byte aligned, got strides "
                         f"{x_q.stride()} for {tuple(x_q.shape)}")
    m = g["B"] * g["Ho"] * g["Wo"]
    if m * max(g["N"], g["C"]) >= 2**31 or g["B"] * g["H"] * g["W"] * g["C"] >= 2**31:
        raise ValueError(f"{name}: a tensor of {tuple(x_q.shape)} -> {g['N']} channels does "
                         "not fit the kernel's int indices")
    k = w_q[0].numel()
    if k * 127 * 127 >= 2**31:
        raise ValueError(f"{name}: K = {k} overflows the int32 sum")
    if kind == "igemm":
        if -(-m // 128) > 65535:
            raise ValueError(f"{name}: {m} output pixels exceed the grid")
        w = _weight_rows(w_q)
        ldw = w.shape[1]
    else:
        w, ldw = w_q.contiguous(), k
    tensors = [x_q, w, w_scale] + ([bias] if bias is not None else [])
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("x_q, w_q, w_scale and bias must be on one device")
    if w.data_ptr() % 16:
        raise ValueError("w_q must be 16-byte aligned")
    ws = w_scale.reshape(g["N"]).to(torch.float32).contiguous()
    bs = None if bias is None else bias.reshape(g["N"]).to(torch.float32).contiguous()
    out = torch.empty((g["B"], g["Ho"], g["Wo"], g["N"]), dtype=torch.float32,
                      device=x_q.device)
    if m == 0:
        return out
    geom = (ctypes.c_int * 17)(*(g[key] for key in ("B", "H", "W", "C", "Ho", "Wo", "N", "KH",
                                                    "KW", "sh", "sw", "ph", "pw", "dh", "dw")),
                               k, ldw)
    lib, _ = load_library()
    global launches_igemm, launches_direct
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        args = (x_q.data_ptr(), w.data_ptr(), ws.data_ptr(),
                None if bs is None else bs.data_ptr(), x_scale, out.data_ptr(), geom)
        if kind == "igemm":
            launches_igemm += 1
            rc = lib.iswm_int8_conv_igemm(*args, stream)
        else:
            launches_direct += 1
            rc = lib.iswm_int8_conv_direct(*args, groups, stream)
    _raise_on(rc, lib, name)
    return out


def conv_s8_igemm(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  x_scale: float, bias: torch.Tensor | None = None, stride=1, padding=0,
                  dilation=1) -> torch.Tensor:
    """Dense int8 conv (see the module docstring): x_q [B, H, W, C] int8,
    w_q [N, KH, KW, C] int8 -> [B, Ho, Wo, N] float32.  The weights are read
    as :func:`_weight_rows`, a view of contiguous w_q unless K is no multiple
    of 16."""
    if x_q.device.type == "cpu":
        return conv_s8_plain(x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation)
    return _launch("igemm", x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation, 1)


def conv_s8_direct(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                   x_scale: float, bias: torch.Tensor | None = None, stride=1, padding=0,
                   dilation=1, groups: int = 1) -> torch.Tensor:
    """Grouped / depthwise int8 conv: x_q [B, H, W, C] int8, w_q [N, KH, KW,
    C / groups] int8 -> [B, Ho, Wo, N] float32 (groups > 1)."""
    if x_q.device.type == "cpu":
        return conv_s8_plain(x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                             groups)
    return _launch("direct", x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                   groups)
