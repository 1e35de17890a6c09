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
version only for a CPU tensor.  Before the launch it picks the kernel's body
from the layout (:func:`choose_layout`): ``channels_last`` (dense
channels-last strides, the training step's), ``nchw`` (contiguous, H * W a
multiple of 8) or ``strided`` (any other view, or pointers not 16-byte
aligned).  The choice follows from the tensors alone; no body stands in
for another on an error.  ``launches_fwd`` / ``launches_bwd`` count the
wrapper calls that launched a kernel (the forward is one launch), and
``launches_by_layout`` counts both wrappers' launches by layout.

The sharded CE (``make_sharded_fused_ce``, the counterpart of the JAX
package's ``make_sharded_fused_ce``) runs on one rank's rows of the global
batch in a process group: the forward kernel on the local logits, an
all-reduce (sum) of the ``[2]`` pair, the loss from the global sums; the
backward kernel on the local logits with the global ``w_sum``.  It has no
kernel of its own: its collective is the process group's (NCCL on the card).
``launches_sharded`` counts its forwards on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import ctypes_entry

LAYOUTS = ("strided", "nchw", "channels_last")  # the C entries' layout codes
NCHW_PIXELS = 8  # H * W a multiple of this for ``nchw`` (the bf16 vector)
launches_fwd = 0
launches_bwd = 0
launches_sharded = 0
launches_by_layout = dict.fromkeys(LAYOUTS, 0)
_lib = None
_workspaces: dict = {}
_LABEL_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
W_SUM_FLOOR = 1e-12


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C entries of a library
    built from ``csrc/fused_ce.cu`` (also of the first source, whose entries
    took no layout and no plan, for comparing the two on the card)."""
    ll, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    geom = [ll] * 7  # B, H, W and the logits' four strides
    if hasattr(lib, "iswm_fused_ce_workspace_bytes"):
        plan = [i32] * 4  # layout, index64, vectors, blocks
        lib.iswm_fused_ce_fwd.argtypes = ([ptr, i32, ptr, i32, ptr, ll] + geom + plan
                                          + [ptr, ptr, ptr])
        lib.iswm_fused_ce_bwd.argtypes = ([ptr, i32, ptr, i32, ptr, ptr, ptr, ll] + geom
                                          + [ptr, ll, ll, ll, ll] + plan + [ptr])
        lib.iswm_fused_ce_workspace_bytes.restype = i32
        lib.iswm_fused_ce_plan.argtypes = [i32, i32, i32, ll, ctypes.POINTER(i32)]
        lib.iswm_fused_ce_plan.restype = None
    else:
        lib.iswm_fused_ce_fwd.argtypes = [ptr, i32, ptr, i32, ptr, ll] + geom + [ptr, ptr, ptr]
        lib.iswm_fused_ce_bwd.argtypes = ([ptr, i32, ptr, i32, ptr, ptr, ptr, ll] + geom
                                          + [ptr, ll, ll, ll, ll, ptr])
        lib.iswm_fused_ce_max_partials.restype = i32
    lib.iswm_fused_ce_fwd.restype = i32
    lib.iswm_fused_ce_bwd.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernels; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("fused_ce")
        _lib = bind(lib)
    return _lib, log


class Layout(NamedTuple):
    """A call's kernel body: its layout (one of :data:`LAYOUTS`) and whether
    its indices are 64-bit (always for ``strided``)."""

    name: str
    index64: bool


def choose_layout(shape, strides, pointers, d_strides=None) -> Layout:
    """The body for logits of ``shape`` [B, 2, H, W] and element ``strides``
    whose data (logits, labels and, for the backward, d_logits) start at the
    addresses ``pointers``, with d_logits in ``d_strides``.

    ``channels_last``: strides (2HW, 1, 2W, 2); ``nchw``: (2HW, HW, W, 1)
    with H * W a multiple of :data:`NCHW_PIXELS`; either also needs every
    pointer 16-byte aligned and d_logits in the logits' strides.  Anything
    else is ``strided``.  The vector bodies index in 32 bits while
    2 * B * H * W < 2^31."""
    b, _, h, w = shape
    strides, hw = tuple(strides), h * w
    name = "strided"
    if (all(p % 16 == 0 for p in pointers)
            and (d_strides is None or tuple(d_strides) == strides)):
        if strides == (2 * hw, 1, 2 * w, 2):
            name = "channels_last"
        elif strides == (2 * hw, hw, w, 1) and hw % NCHW_PIXELS == 0:
            name = "nchw"
    return Layout(name, name == "strided" or 2 * b * hw >= 2**31)


def workspace(lib, device: torch.device, stream: int) -> torch.Tensor:
    """The forward's workspace (per-block partials and the last-block
    ticket) of ``stream`` on ``device``: made zeroed at its first use and
    kept, so that launches on other streams never share a ticket."""
    key = (device, stream)
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(lib.iswm_fused_ce_workspace_bytes() // 4,
                                       dtype=torch.int32, device=device)
    return _workspaces[key]


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
    """Check a CUDA call and return (contiguous labels, f32 cw)."""
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
    cw = class_weights.to(device=logits.device, dtype=torch.float32).contiguous()
    if cw.numel() != 2:
        raise ValueError(f"class_weights must have 2 entries, got {cw.numel()}")
    return labels.contiguous(), cw


def _call_args(logits, labels, cw, ignore_index):
    b, _, h, w = logits.shape
    return (logits.data_ptr(), int(logits.dtype == torch.bfloat16), labels.data_ptr(),
            _LABEL_KINDS[labels.dtype], cw.data_ptr(), int(ignore_index), b, h, w,
            *logits.stride())


def _plan_args(layout: Layout, vectors: int, blocks: int) -> tuple:
    return LAYOUTS.index(layout.name), int(layout.index64), vectors, blocks


def launch_fwd(lib, logits, labels, cw, ignore_index, layout: Layout, ws, out, stream: int,
               vectors: int = 0, blocks: int = 0) -> int:
    """The forward's C entry on checked arguments (``vectors`` a thread and
    ``blocks``: 0 for the kernel's own plan); returns its error code."""
    return lib.iswm_fused_ce_fwd(*_call_args(logits, labels, cw, ignore_index),
                                 *_plan_args(layout, vectors, blocks), ws.data_ptr(),
                                 out.data_ptr(), stream)


def launch_bwd(lib, logits, labels, cw, g, ws_sum, ignore_index, layout: Layout, d_logits,
               stream: int, vectors: int = 0, blocks: int = 0) -> int:
    """The backward's C entry on checked arguments; see :func:`launch_fwd`."""
    a = _call_args(logits, labels, cw, ignore_index)
    return lib.iswm_fused_ce_bwd(*a[:5], g.data_ptr(), ws_sum.data_ptr(), *a[5:],
                                 d_logits.data_ptr(), *d_logits.stride(),
                                 *_plan_args(layout, vectors, blocks), stream)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.iswm_cuda_error_string(rc).decode()}")


@ctypes_entry
def fused_binary_ce_fwd(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int = 255,
) -> torch.Tensor:
    """[2] f32 = (sum w * ce, sum w) on the logits' device."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_binary_ce_fwd_plain(logits, labels, class_weights, ignore_index)
    labels, cw = _cuda_args(logits, labels, class_weights)
    lib, _ = load_library()
    out = torch.empty(2, dtype=torch.float32, device=logits.device)
    layout = choose_layout(logits.shape, logits.stride(),
                           (logits.data_ptr(), labels.data_ptr()))
    global launches_fwd
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        ws = workspace(lib, logits.device, stream)
        launches_fwd += 1
        launches_by_layout[layout.name] += 1
        rc = launch_fwd(lib, logits, labels, cw, ignore_index, layout, ws, out, stream)
    _raise_on(lib, rc, "fused_binary_ce forward")
    return out


@ctypes_entry
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
    labels, cw = _cuda_args(logits, labels, class_weights)
    g = grad.to(device=logits.device, dtype=torch.float32).contiguous()
    ws_sum = w_sum.to(device=logits.device, dtype=torch.float32).contiguous()
    d_logits = torch.empty_like(logits)  # keeps the logits' strides where dense
    layout = choose_layout(logits.shape, logits.stride(),
                           (logits.data_ptr(), labels.data_ptr(), d_logits.data_ptr()),
                           d_logits.stride())
    lib, _ = load_library()
    global launches_bwd
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        launches_bwd += 1
        launches_by_layout[layout.name] += 1
        rc = launch_bwd(lib, logits, labels, cw, g, ws_sum, ignore_index, layout, d_logits,
                        stream)
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


class ShardedFusedBinaryCE(torch.autograd.Function):
    """:class:`FusedBinaryCE` over the rows of every rank of ``group``: the
    forward sums of this rank's logits are all-reduced before the division,
    and the backward uses the global clamped ``w_sum``.  Each rank's backward
    starts from its own upstream gradient (1 for a loss), so each rank's
    d_logits is its rows' share of the gradient of the global loss; the JAX
    package's psum of the cotangent (which ``shard_map`` splits over the
    shards) has no counterpart.  ``plain`` takes the plain versions on any
    device."""

    @staticmethod
    def forward(ctx, logits, labels, class_weights, ignore_index, group, plain):
        fwd = fused_binary_ce_fwd_plain if plain else fused_binary_ce_fwd
        sums = fwd(logits, labels, class_weights, ignore_index)
        if logits.is_cuda and not plain:
            global launches_sharded
            launches_sharded += 1
        torch.distributed.all_reduce(sums, group=group)
        w_sum = torch.clamp_min(sums[1], W_SUM_FLOOR)
        ctx.save_for_backward(logits, labels, class_weights, w_sum)
        ctx.ignore_index, ctx.plain = ignore_index, plain
        return sums[0] / w_sum

    @staticmethod
    def backward(ctx, grad):
        logits, labels, class_weights, w_sum = ctx.saved_tensors
        bwd = fused_binary_ce_bwd_plain if ctx.plain else fused_binary_ce_bwd
        d_logits = bwd(logits, labels, class_weights, w_sum, grad, ctx.ignore_index)
        return d_logits, None, None, None, None, None


def make_sharded_fused_ce(group=None, ignore_index: int = 255):
    """``loss_fn(logits, labels, class_weights)``: the weighted mean binary CE
    of the global batch, from this rank's rows (0-d f32, the same value on
    every rank of ``group``, the default group when None)."""

    def loss_fn(logits, labels, class_weights):
        return ShardedFusedBinaryCE.apply(logits, labels, class_weights, ignore_index,
                                          group, False)

    return loss_fn


def sharded_fused_binary_ce_plain(
    logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
    ignore_index: int = 255, group=None,
) -> torch.Tensor:
    """:func:`make_sharded_fused_ce`'s loss through the plain versions and the
    same all-reduce (differentiable)."""
    return ShardedFusedBinaryCE.apply(logits, labels, class_weights, ignore_index,
                                      group, True)
