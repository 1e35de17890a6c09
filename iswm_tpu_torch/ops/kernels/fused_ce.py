"""Fused binary softmax cross-entropy, forward and backward: the CUDA kernels
``csrc/fused_ce.cu`` for Hopper, their wrappers and their plain versions.

Counterpart of ``iswm_tpu/ops/pallas/fused_ce.py`` ``fused_binary_ce``.
For NCHW logits [B, 2, H, W] (a = class 0, b = class 1), labels [B, H, W],
class weights ``cw`` [2] and ``ignore_index``:

    logz = max(a, b) + log1p(exp(-|a - b|)),  ce = logz - (y == 1 ? b : a)
    w    = 0 where y == ignore_index, else cw[1] where y == 1, else cw[0]
    forward  -> (sum w * ce, sum w);  loss = sum w * ce / max(sum w, 1e-12)
    backward -> da = ((1 - p1) - (1 - y1)) * w * g / w_sum,
                db = (p1 - y1) * w * g / w_sum,   p1 = sigmoid(b - a)

Any label that is neither 1 nor ``ignore_index`` counts as class 0.  The
math is float32 whatever the logits' dtype (bf16 or f32); ``d_logits`` has
the logits' dtype and layout.  The kernels read the logits through their
strides, so NCHW-contiguous and channels-last logits both go in without a
copy.

Each wrapper launches its kernel for a CUDA tensor and uses the plain
version only for a CPU tensor.  ``launches_fwd`` / ``launches_bwd`` count
the wrapper calls that launched a kernel (the forward is one call of the
two-stage reduction).
"""

from __future__ import annotations

import ctypes

import torch

launches_fwd = 0
launches_bwd = 0
_lib = None
_LABEL_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
W_SUM_FLOOR = 1e-12


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernels; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("fused_ce")
        ll, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.iswm_fused_ce_fwd.argtypes = [
            ptr, i32, ptr, i32, ptr, ll, ll, ll, ll, ll, ll, ll, ll, ptr, ptr, ptr,
        ]
        lib.iswm_fused_ce_bwd.argtypes = [
            ptr, i32, ptr, i32, ptr, ptr, ptr, ll, ll, ll, ll, ll, ll, ll, ll,
            ptr, ll, ll, ll, ll, ptr,
        ]
        lib.iswm_fused_ce_fwd.restype = i32
        lib.iswm_fused_ce_bwd.restype = i32
        lib.iswm_fused_ce_max_partials.restype = i32
        lib.iswm_cuda_error_string.argtypes = [i32]
        lib.iswm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib, log


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.ndim != 4 or logits.shape[1] != 2:
        raise ValueError(f"logits must be [B, 2, H, W], got {tuple(logits.shape)}")
    b, _, h, w = logits.shape
    if tuple(labels.shape) != (b, h, w):
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits "
                         f"{tuple(logits.shape)}")


def _terms(logits, labels, class_weights, ignore_index, dtype):
    """Per-pixel (a, b, is_one, w) of the plain versions, in ``dtype``."""
    a = logits[:, 0].to(dtype)
    b = logits[:, 1].to(dtype)
    is_one = labels == 1
    cw = class_weights.to(device=logits.device, dtype=dtype)
    w = torch.where(is_one, cw[1], cw[0])
    w = torch.where(labels == ignore_index, torch.zeros_like(w), w)
    return a, b, is_one, w


def fused_binary_ce_fwd_plain(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int = 255, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The forward in PyTorch ops: [2] = (sum w * ce, sum w), computed in
    ``dtype`` (float32 as the kernel; float64 for a reference)."""
    _check(logits, labels)
    a, b, is_one, w = _terms(logits, labels, class_weights, ignore_index, dtype)
    logz = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
    ce = logz - torch.where(is_one, b, a)
    return torch.stack([(ce * w).sum(), w.sum()])


def fused_binary_ce_bwd_plain(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    w_sum: torch.Tensor, grad: torch.Tensor, ignore_index: int = 255,
) -> torch.Tensor:
    """The backward in PyTorch ops: d_logits [B, 2, H, W] in the logits'
    dtype, for the upstream gradient ``grad`` of the loss and the clamped
    ``w_sum``."""
    _check(logits, labels)
    a, b, is_one, w = _terms(logits, labels, class_weights, ignore_index,
                             torch.float32)
    scale = grad.float() / w_sum.float()
    p1 = torch.sigmoid(b - a)
    y1 = is_one.float()
    da = ((1.0 - p1) - (1.0 - y1)) * w * scale
    db = (p1 - y1) * w * scale
    out = torch.empty_like(logits)
    out[:, 0] = da
    out[:, 1] = db
    return out


def _cuda_args(logits, labels, class_weights):
    """Check a CUDA call and return (labels, cw, label kind, geometry)."""
    if logits.device.type != "cuda":
        raise ValueError(f"fused_binary_ce runs on CUDA or CPU, not {logits.device}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"logits must be bf16 or f32, got {logits.dtype}")
    if labels.dtype not in _LABEL_KINDS:
        raise TypeError(f"labels must be uint8, int32 or int64, got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError("logits and labels must be on one device")
    if torch.cuda.get_device_capability(logits.device) != (9, 0):
        raise RuntimeError("the fused_ce kernels are built for sm_90a (H100/H200)")
    labels = labels.contiguous()
    cw = class_weights.to(device=logits.device, dtype=torch.float32).contiguous()
    if cw.numel() != 2:
        raise ValueError(f"class_weights must have 2 entries, got {cw.numel()}")
    b, _, h, w = logits.shape
    return labels, cw, _LABEL_KINDS[labels.dtype], (b, h, w, *logits.stride())


def _raise_on(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.iswm_cuda_error_string(rc).decode()}")


def fused_binary_ce_fwd(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int = 255,
) -> torch.Tensor:
    """[2] f32 = (sum w * ce, sum w) on the logits' device."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_binary_ce_fwd_plain(logits, labels, class_weights, ignore_index)
    labels, cw, kind, geom = _cuda_args(logits, labels, class_weights)
    lib, _ = load_library()
    partials = torch.empty(2 * lib.iswm_fused_ce_max_partials(), dtype=torch.float32,
                           device=logits.device)
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    global launches_fwd
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        launches_fwd += 1
        rc = lib.iswm_fused_ce_fwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), labels.data_ptr(),
            kind, cw.data_ptr(), int(ignore_index), *geom, partials.data_ptr(),
            out.data_ptr(), stream,
        )
    _raise_on(lib, rc, "fused_binary_ce forward")
    return out


def fused_binary_ce_bwd(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    w_sum: torch.Tensor, grad: torch.Tensor, ignore_index: int = 255,
) -> torch.Tensor:
    """d_logits in the logits' dtype and memory format (see the module
    docstring); ``w_sum`` is the clamped sum of weights, ``grad`` the
    upstream gradient of the loss, both 0-d or 1-element tensors."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_binary_ce_bwd_plain(logits, labels, class_weights, w_sum, grad,
                                         ignore_index)
    labels, cw, kind, geom = _cuda_args(logits, labels, class_weights)
    g = grad.to(device=logits.device, dtype=torch.float32).contiguous()
    ws = w_sum.to(device=logits.device, dtype=torch.float32).contiguous()
    d_logits = torch.empty_like(logits)  # keeps the logits' strides
    lib, _ = load_library()
    global launches_bwd
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        launches_bwd += 1
        rc = lib.iswm_fused_ce_bwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), labels.data_ptr(),
            kind, cw.data_ptr(), g.data_ptr(), ws.data_ptr(), int(ignore_index), *geom,
            d_logits.data_ptr(), *d_logits.stride(), stream,
        )
    _raise_on(lib, rc, "fused_binary_ce backward")
    return d_logits


class FusedBinaryCE(torch.autograd.Function):
    """Weighted mean CE over valid pixels, with the kernel pair as forward
    and backward.  Saves the logits, labels, class weights and clamped
    ``w_sum``; nothing else is kept for the backward."""

    @staticmethod
    def forward(ctx, logits, labels, class_weights, ignore_index):
        sums = fused_binary_ce_fwd(logits, labels, class_weights, ignore_index)
        w_sum = torch.clamp_min(sums[1], W_SUM_FLOOR)
        ctx.save_for_backward(logits, labels, class_weights, w_sum)
        ctx.ignore_index = ignore_index
        return sums[0] / w_sum

    @staticmethod
    def backward(ctx, grad):
        logits, labels, class_weights, w_sum = ctx.saved_tensors
        d_logits = fused_binary_ce_bwd(logits, labels, class_weights, w_sum, grad,
                                       ctx.ignore_index)
        return d_logits, None, None, None


def fused_binary_ce(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int = 255,
) -> torch.Tensor:
    """Weighted mean binary CE of NCHW logits [B, 2, H, W] (0-d f32)."""
    return FusedBinaryCE.apply(logits, labels, class_weights, ignore_index)
