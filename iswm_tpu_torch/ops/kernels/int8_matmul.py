"""int8 x int8 -> int32 matmul with fused (de)quantize: the CUDA kernel
``csrc/int8_matmul.cu`` for Hopper, its wrapper and its plain version.

Counterpart of ``iswm_tpu/ops/pallas/int8_matmul.py`` (``int8_matmul``,
``int8_matmul_prequant`` and ``quantized_conv1x1``).  What it computes, for x [M, K] bf16/f32, w_q
[K, N] int8, w_scale [N] f32 and a per-tensor ``x_scale``:

    out = float(clip(round(x / x_scale), -127, 127) @ w_q) * x_scale * w_scale

``x_scale`` is a Python float (absmax / 127 in double, as calibration
returns it) and is rounded to float32 once, at the kernel boundary, as the
TPU wrapper does.  K and N must be multiples of 128.
``int8_matmul_prequant`` takes the codes ``x_q`` [M, K] int8 in place of x
and leaves the quantize out: the same kernel instantiated for int8 x.

Each wrapper launches the kernel for a CUDA tensor and uses its plain
version only for a CPU tensor.  ``launches`` counts the launches of
``int8_matmul``, ``launches_prequant`` those of ``int8_matmul_prequant``.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0
launches_prequant = 0
_lib = None


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernel; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("int8_matmul")
        lib.iswm_int8_matmul.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.iswm_int8_matmul.restype = ctypes.c_int
        lib.iswm_int8_matmul_prequant.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.iswm_int8_matmul_prequant.restype = ctypes.c_int
        lib.iswm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.iswm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib, log


def _check_shapes(x: torch.Tensor, w_q: torch.Tensor) -> tuple[int, int, int]:
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"K mismatch: {k} vs {k2}")
    if k % 128 or n % 128:
        raise ValueError(f"K ({k}) and N ({n}) must be multiples of 128")
    return m, k, n


def int8_matmul_plain(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """The plain PyTorch version: [M, K] float @ [K, N] int8 -> [M, N] f32.

    The integer products are summed in float64, which is exact while
    |acc| < 2**53 (float32 is not: 2048 * 127**2 > 2**24)."""
    _check_shapes(x, w_q)
    xs = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
    x_q = torch.clamp(torch.round(x.float() / xs), -127, 127)
    acc = x_q.double() @ w_q.double()
    return acc.float() * xs * w_scale.float().reshape(-1)


def _launch(x, x_dtypes, w_q, w_scale, x_scale, prequant: bool) -> torch.Tensor:
    """Check a CUDA call, launch the kernel for x's element type, count it."""
    m, k, n = _check_shapes(x, w_q)
    name = "int8_matmul_prequant" if prequant else "int8_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {x.device}")
    if x.dtype not in x_dtypes:
        raise TypeError(f"x must be {' or '.join(map(str, x_dtypes))}, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if w_q.device != x.device or w_scale.device != x.device:
        raise ValueError("x, w_q and w_scale must be on one device")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(f"the {name} kernel is built for sm_90a (H100/H200)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be contiguous and 16-byte aligned, got strides "
                         f"{x.stride()} for {tuple(x.shape)}, offset {x.storage_offset()}")
    if m >= 2**31:
        raise ValueError(f"M ({m}) does not fit the kernel's int row index")
    w_t = w_q.t().contiguous()  # [N, K]: a view when w_q is a transposed [N, K]
    ws = w_scale.reshape(n).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib, _ = load_library()
    global launches, launches_prequant
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if prequant:
            launches_prequant += 1
            rc = lib.iswm_int8_matmul_prequant(
                x.data_ptr(), w_t.data_ptr(), ws.data_ptr(), x_scale,
                out.data_ptr(), m, k, n, stream,
            )
        else:
            launches += 1
            rc = lib.iswm_int8_matmul(
                x.data_ptr(), int(x.dtype == torch.bfloat16), w_t.data_ptr(),
                ws.data_ptr(), x_scale, out.data_ptr(), m, k, n, stream,
            )
    if rc:
        raise RuntimeError(
            f"{name} launch failed: {lib.iswm_cuda_error_string(rc).decode()}"
        )
    return out


def int8_matmul(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """[M, K] bf16/f32 @ [K, N] int8 -> [M, N] f32 (see module docstring)."""
    _check_shapes(x, w_q)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, w_scale, x_scale)
    return _launch(x, (torch.bfloat16, torch.float32), w_q, w_scale, x_scale, False)


def int8_matmul_prequant_plain(
    x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """The plain PyTorch version of :func:`int8_matmul_prequant`: float64
    sums of the integer codes, then ``(acc * x_scale) * w_scale`` in
    float32."""
    _check_shapes(x_q, w_q)
    if x_q.dtype != torch.int8:
        raise TypeError(f"x_q must be int8, got {x_q.dtype}")
    xs = torch.tensor(x_scale, dtype=torch.float32, device=x_q.device)
    acc = x_q.double() @ w_q.double()
    return acc.float() * xs * w_scale.float().reshape(-1)


def int8_matmul_prequant(
    x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """[M, K] int8 codes @ [K, N] int8 -> [M, N] f32 =
    ``float(x_q @ w_q) * x_scale * w_scale``: :func:`int8_matmul` with the
    activations already quantized.  Nothing in the serving path calls it;
    it isolates the tensor-core path from the cost of the quantize
    prologue."""
    _check_shapes(x_q, w_q)
    if x_q.device.type == "cpu":
        return int8_matmul_prequant_plain(x_q, w_q, w_scale, x_scale)
    return _launch(x_q, (torch.int8,), w_q, w_scale, x_scale, True)


def _conv1x1(matmul, x, w_q, w_scale, x_scale):
    b, h, w, cin = x.shape
    cout = w_q.shape[0]
    # contiguous(): a no-op on channels-last pixels; an NCHW-contiguous
    # batch of one reshapes to a transposed view, which must be copied
    out = matmul(
        x.reshape(-1, cin).contiguous(), w_q.reshape(cout, cin).t(),
        w_scale.reshape(cout), x_scale,
    )
    return out.reshape(b, h, w, cout)


def quantized_conv1x1(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """1x1 conv as an int8 matmul over pixels: x [B, H, W, Cin] float,
    w_q [Cout, Cin, 1, 1] int8 (PyTorch's conv layout), w_scale [Cout]
    -> [B, H, W, Cout] f32.  A channels-last NCHW tensor permuted to NHWC
    reaches the kernel without a copy; any other layout is copied once."""
    return _conv1x1(int8_matmul, x, w_q, w_scale, x_scale)


def quantized_conv1x1_plain(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_scale: float
) -> torch.Tensor:
    """:func:`quantized_conv1x1` through :func:`int8_matmul_plain`."""
    return _conv1x1(int8_matmul_plain, x, w_q, w_scale, x_scale)
