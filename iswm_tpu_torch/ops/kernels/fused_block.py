"""Fused bottleneck convs, a 1x1 or 3x3 conv with a normalize + ReLU prologue,
the BatchNorm statistics of its output and a fused backward: the CUDA kernels
``csrc/fused_block.cu`` for Hopper, their wrappers and their plain versions.

Counterpart of ``iswm_tpu/ops/pallas/fused_block.py``, and in its layout: the
public functions take the rows of an NHWC activation, ``x`` [M, K] with the
weight ``w`` [K, N] for the 1x1, ``y1`` [B, H, W, C] with ``w`` [3, 3, C, N] for
the 3x3 (stride 1, pad 1).  ``a``, ``b`` [K] float32 are the previous
BatchNorm folded into ``normalize(x) = a * x + b``.

- ``matmul_bn_stats(x, w, a, b, prologue)`` -> ``(y, s, q)``:
  ``y = (relu(a * x + b) rounded to x's dtype, if prologue, else x) @ w``
  rounded to x's dtype; ``s = sum_M y`` and ``q = sum_M y^2`` in float32 over
  the ROUNDED y.
- ``conv3x3_bn_stats(y1, a, b, w)`` -> ``(y2, s, q)``: the same for the 3x3
  conv of ``relu(a * y1 + b)``; the zero padding is applied AFTER the
  prologue (a border pixel sees 0, not ``relu(b)``).  ``w`` is cast to y1's
  dtype inside.

Both are ``torch.autograd.Function``s whose three outputs are all
differentiable: the backward takes ``(dy, ds, dq)`` and forms the total
cotangent ``dyt = dy + ds + 2 * y * dq`` in float32, rounded to the compute
dtype before both products; the prologue's z is rounded before the weight
gradient; the ReLU mask is ``a * x + b > 0`` in float32 for the 1x1 and
``rounded z > 0`` for the 3x3, as in the JAX kernels; ``dx = dz * a`` in
float32, then rounded; ``da = sum dz * x``, ``db = sum dz`` and ``dw`` in
float32.  The weight gradient's dtype follows the JAX package: the 1x1 takes
its weight already cast to the compute dtype and returns ``dw`` rounded to it
(so a bf16 run rounds the 1x1 weight gradients to bf16 before they reach the
float32 parameter); the 3x3 takes the float32 weight and its ``dw`` stays
float32.

Each wrapper launches its kernels for a CUDA tensor and uses the plain version
only for a CPU tensor (the counterpart of Pallas interpret mode).  The plain
versions repeat the kernels' arithmetic and rounding points, so kernel and
plain version differ by summation order only; with ``dtype=torch.float64``
they sum in float64 and serve as the reference.  ``launches_*`` count the
wrapper calls that launched a kernel (a backward is one call: a data-gradient
and a weight-gradient kernel).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import ctypes_entry

launches_mm_fwd = 0
launches_mm_bwd = 0
launches_c3_fwd = 0
launches_c3_bwd = 0
_lib = None
TAPS_3X3 = 9


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C entries of a library
    built from ``csrc/fused_block.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.iswm_fb_fwd.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
    lib.iswm_fb_dgrad.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
    lib.iswm_fb_wgrad.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
    lib.iswm_fb_sums_scratch.argtypes = [i32, i32]
    lib.iswm_fb_sums_scratch.restype = ctypes.c_longlong
    lib.iswm_fb_wgrad_splits.argtypes = [i32, i32, i32]
    if hasattr(lib, "iswm_fb_fwd_plan"):  # not in the sources before the pipelined forward
        lib.iswm_fb_fwd_planned.argtypes = [ptr] * 7 + [i32] * 7 + [ctypes.POINTER(i32), ptr]
        lib.iswm_fb_fwd_planned.restype = i32
        lib.iswm_fb_fwd_plan.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.iswm_fb_fwd_plan.restype = None
    for fn in (lib.iswm_fb_fwd, lib.iswm_fb_dgrad, lib.iswm_fb_wgrad,
               lib.iswm_fb_wgrad_splits):
        fn.restype = i32
    lib.iswm_cuda_error_string.argtypes = [i32]
    lib.iswm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load the kernels; returns (library, nvcc log)."""
    global _lib
    log = ""
    if _lib is None:
        from .build import load_library as build_and_load

        lib, log = build_and_load("fused_block")
        _lib = bind(lib)
    return _lib, log


FWD_PLAN_KEYS = ("bm", "bn", "nt", "blocks")


def plan_fwd(m: int, c: int, n: int, taps: int, prologue: bool) -> dict:
    """The bf16 forward's plan for M pixels, C input and N output channels,
    ``taps`` (1 or 9) and ``prologue``, as ``iswm_fb_fwd`` launches it: the
    tile (``bm`` x ``bn``), the column tiles a block walks (``nt``) and the
    ``blocks``.  Needs the built library (a CUDA machine)."""
    lib, _ = load_library()
    out = (ctypes.c_int * len(FWD_PLAN_KEYS))()
    lib.iswm_fb_fwd_plan(m, c, n, taps, int(prologue), out)
    return dict(zip(FWD_PLAN_KEYS, out))


# ------------------------------------------------------------ plain versions
def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype of the elementwise math: float32 (float64 for a
    float64 tensor, which only the tests' autograd check hands in)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _prologue(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(a * x + b in float32, its ReLU rounded to x's dtype): a multiply, then
    an add, over the last (channel) axis."""
    zf = _wide(x) * a + b
    return zf, torch.relu(zf).to(x.dtype)


def _total_cotangent(y, dy, ds, dq):
    """``dy + ds + 2 * y * dq`` in float32, rounded to y's dtype."""
    return (_wide(dy) + ds + 2.0 * _wide(y) * dq).to(y.dtype)


def _stats(y: torch.Tensor, dtype: torch.dtype):
    yf = y.to(dtype).reshape(-1, y.shape[-1])
    return yf.sum(0), (yf * yf).sum(0)


def _check_mm(x, w, a, b, prologue) -> None:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x [M, K] and w [K, N] expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if prologue and (a is None or b is None or a.numel() != x.shape[1]
                     or b.numel() != x.shape[1]):
        raise ValueError("the prologue needs a and b with one entry per input channel")


def _check_c3(y1, w, a, b) -> None:
    if y1.ndim != 4 or tuple(w.shape[:3]) != (3, 3, y1.shape[3]):
        raise ValueError(f"y1 [B, H, W, C] and w [3, 3, C, N] expected, got "
                         f"{tuple(y1.shape)} and {tuple(w.shape)}")
    if a.numel() != y1.shape[3] or b.numel() != y1.shape[3]:
        raise ValueError("a and b need one entry per input channel")


def matmul_bn_stats_plain(x, w, a=None, b=None, prologue: bool = False,
                          dtype: torch.dtype = torch.float32):
    """``(y, s, q)`` of the 1x1: the product and the sums in ``dtype``
    (float32 as the kernel accumulates; float64 for a reference), y rounded
    once to x's dtype."""
    _check_mm(x, w, a, b, prologue)
    z = _prologue(x, a, b)[1] if prologue else x
    y = (z.to(dtype) @ w.to(dtype)).to(x.dtype)
    return (y, *_stats(y, dtype))


def matmul_bn_stats_bwd_plain(x, w, a, b, y, dy, ds, dq, prologue: bool = False,
                              dtype: torch.dtype = torch.float32):
    """``(dx, dw [K, N], da, db)`` of the 1x1, products and sums in ``dtype``;
    da and db are zeros without prologue."""
    _check_mm(x, w, a, b, prologue)
    dyt = _total_cotangent(y, dy, ds, dq).to(dtype)
    dz = dyt @ w.to(dtype).t()
    if prologue:
        zf, z = _prologue(x, a, b)
        dzm = torch.where(zf > 0, dz, 0.0)
        dx = (dzm * a.to(dtype)).to(x.dtype)
        da, db = (dzm * _wide(x).to(dtype)).sum(0), dzm.sum(0)
    else:
        z, dx = x, dz.to(x.dtype)
        da = db = torch.zeros(x.shape[1], dtype=dtype, device=x.device)
    return dx, z.to(dtype).t() @ dyt, da, db


def _windows(t: torch.Tensor):
    """The nine shifted [B, H, W, C] views of ``t`` zero-padded by one pixel,
    in tap order (ky, kx): view[tap][p] = t[p + (ky - 1, kx - 1)]."""
    h, w = t.shape[1], t.shape[2]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    return [tp[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)]


def conv3x3_bn_stats_plain(y1, a, b, w, dtype: torch.dtype = torch.float32):
    """``(y2, s, q)`` of the 3x3 as nine shifted products in ``dtype``."""
    _check_c3(y1, w, a, b)
    z = _prologue(y1, a, b)[1].to(dtype)
    wk = w.to(y1.dtype).to(dtype).reshape(TAPS_3X3, w.shape[2], w.shape[3])
    acc = 0
    for tap, view in enumerate(_windows(z)):
        acc = acc + view @ wk[tap]
    y2 = acc.to(y1.dtype)
    return (y2, *_stats(y2, dtype))


def conv3x3_bn_stats_bwd_plain(y1, a, b, w, y2, dy2, ds, dq,
                               dtype: torch.dtype = torch.float32):
    """``(dy1, dw [3, 3, C, N], da, db)`` of the 3x3 in ``dtype``."""
    _check_c3(y1, w, a, b)
    c, n = w.shape[2], w.shape[3]
    z = _prologue(y1, a, b)[1]
    dyt = _total_cotangent(y2, dy2, ds, dq).to(dtype)
    wk = w.to(y1.dtype).to(dtype).reshape(TAPS_3X3, c, n)
    # dz[p] = sum_tap dyt[p - off(tap)] @ w[tap]^T: the windows in reverse order
    dz = 0
    for tap, view in enumerate(reversed(_windows(dyt))):
        dz = dz + view @ wk[tap].t()
    dzm = torch.where(z > 0, dz, 0.0)
    dy1 = (dzm * a.to(dtype)).to(y1.dtype)
    da = (dzm * _wide(y1).to(dtype)).sum(dim=(0, 1, 2))
    db = dzm.sum(dim=(0, 1, 2))
    flat = dyt.reshape(-1, n)
    dw = torch.stack([view.reshape(-1, c).t() @ flat for view in _windows(z.to(dtype))])
    return dy1, dw.reshape(3, 3, c, n), da, db


# ------------------------------------------------------------- CUDA wrappers
def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` row-major and 16-byte aligned: itself when it already is."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _vec(v: torch.Tensor | None, n: int, like: torch.Tensor) -> torch.Tensor | None:
    if v is None:
        return None
    v = _dense(v.detach().to(device=like.device, dtype=torch.float32))
    if v.numel() != n:
        raise ValueError(f"a per-channel vector of {n} entries expected, got {v.numel()}")
    return v


def _cuda_check(x: torch.Tensor, c: int, n: int, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the fused block kernels run on CUDA or CPU, not {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the activations must be bf16 or f32, got {x.dtype}")
    if c % 8 or n % 8:
        raise ValueError(f"the kernels take channel counts divisible by 8, got {c} -> {n}")
    if x.numel() // c >= 2**31:
        raise ValueError("the kernels index pixels with 32 bits")
    for t in others:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"every tensor must be {x.dtype} on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("the fused block kernels are built for sm_90a (H100/H200)")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.iswm_cuda_error_string(rc).decode()}")


def _f32(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(n, dtype=torch.float32, device=like.device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_fwd(x, w_nk, a, b, taps, prologue, geo, c, n):
    """x [M, C] dense, w_nk [N, taps * C] dense in x's dtype -> (y [M, N], s, q)."""
    m, h, w_ = geo
    lib, _ = load_library()
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    scratch, sq = _f32(lib.iswm_fb_sums_scratch(m, n), x), _f32(2 * n, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.iswm_fb_fwd(x.data_ptr(), w_nk.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
                             scratch.data_ptr(), sq.data_ptr(),
                             int(x.dtype == torch.bfloat16), taps, int(prologue),
                             m, h, w_, c, n, stream)
    _raise_on(lib, rc, "fused block forward")
    return y, sq[:n], sq[n:]


def _launch_bwd(x, w_ckn, a, b, y, dy, ds, dq, taps, prologue, geo, c, n):
    """-> (dx [M, C], dw [taps * C, N] f32, da, db [C] f32)."""
    m, h, w_ = geo
    lib, _ = load_library()
    bf16 = int(x.dtype == torch.bfloat16)
    dx = torch.empty((m, c), dtype=x.dtype, device=x.device)
    dab = torch.zeros(2 * c, dtype=torch.float32, device=x.device) if not prologue \
        else _f32(2 * c, x)
    sums = _f32(lib.iswm_fb_sums_scratch(m, c), x) if prologue else None
    parts = _f32(lib.iswm_fb_wgrad_splits(m, taps * c, n) * taps * c * n, x)
    dw = _f32(taps * c * n, x).reshape(taps * c, n)
    shape = (bf16, taps, int(prologue), m, h, w_, c, n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.iswm_fb_dgrad(dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dq.data_ptr(),
                               w_ckn.data_ptr(), x.data_ptr(), _ptr(a), _ptr(b),
                               dx.data_ptr(), _ptr(sums), dab.data_ptr(), *shape, stream)
        _raise_on(lib, rc, "fused block data gradient")
        rc = lib.iswm_fb_wgrad(x.data_ptr(), _ptr(a), _ptr(b), dy.data_ptr(), y.data_ptr(),
                               ds.data_ptr(), dq.data_ptr(), parts.data_ptr(),
                               dw.data_ptr(), *shape, stream)
    _raise_on(lib, rc, "fused block weight gradient")
    return dx, dw, dab[:c], dab[c:]


@ctypes_entry
def matmul_bn_stats_fwd(x, w, a=None, b=None, prologue: bool = False):
    """``(y [M, N], s [N], q [N])`` of x [M, K], w [K, N] (see the module)."""
    _check_mm(x, w, a, b, prologue)
    if x.device.type == "cpu":
        return matmul_bn_stats_plain(x, w, a, b, prologue)
    k, n = w.shape
    _cuda_check(x, k, n, w)
    a, b = (_vec(a, k, x), _vec(b, k, x)) if prologue else (None, None)
    global launches_mm_fwd
    launches_mm_fwd += 1
    return _launch_fwd(_dense(x), _dense(w.detach().t()), a, b, 1, prologue,
                       (x.shape[0], 1, x.shape[0]), k, n)


@ctypes_entry
def matmul_bn_stats_bwd(x, w, a, b, y, dy, ds, dq, prologue: bool = False):
    """``(dx [M, K], dw [K, N] float32, da [K], db [K])`` of the 1x1."""
    _check_mm(x, w, a, b, prologue)
    if x.device.type == "cpu":
        return matmul_bn_stats_bwd_plain(x, w, a, b, y, dy, ds, dq, prologue)
    k, n = w.shape
    _cuda_check(x, k, n, w, y, dy)
    a, b = (_vec(a, k, x), _vec(b, k, x)) if prologue else (None, None)
    global launches_mm_bwd
    launches_mm_bwd += 1
    return _launch_bwd(_dense(x), _dense(w.detach()), a, b, _dense(y), _dense(dy),
                       _vec(ds, n, x), _vec(dq, n, x), 1, prologue,
                       (x.shape[0], 1, x.shape[0]), k, n)


@ctypes_entry
def conv3x3_bn_stats_fwd(y1, a, b, w):
    """``(y2 [B, H, W, N], s [N], q [N])`` of y1 [B, H, W, C], w [3, 3, C, N]."""
    _check_c3(y1, w, a, b)
    if y1.device.type == "cpu":
        return conv3x3_bn_stats_plain(y1, a, b, w)
    bsz, h, w_, c = y1.shape
    n = w.shape[3]
    _cuda_check(y1, c, n)
    w_nk = w.detach().to(y1.dtype).permute(3, 0, 1, 2).reshape(n, TAPS_3X3 * c)
    global launches_c3_fwd
    launches_c3_fwd += 1
    y2, s, q = _launch_fwd(_dense(y1), _dense(w_nk), _vec(a, c, y1), _vec(b, c, y1),
                           TAPS_3X3, True, (bsz * h * w_, h, w_), c, n)
    return y2.reshape(bsz, h, w_, n), s, q


@ctypes_entry
def conv3x3_bn_stats_bwd(y1, a, b, w, y2, dy2, ds, dq):
    """``(dy1 [B, H, W, C], dw [3, 3, C, N] float32, da [C], db [C])``."""
    _check_c3(y1, w, a, b)
    if y1.device.type == "cpu":
        return conv3x3_bn_stats_bwd_plain(y1, a, b, w, y2, dy2, ds, dq)
    bsz, h, w_, c = y1.shape
    n = w.shape[3]
    _cuda_check(y1, c, n, y2, dy2)
    w_ckn = w.detach().to(y1.dtype).permute(2, 0, 1, 3).reshape(c, TAPS_3X3 * n)
    global launches_c3_bwd
    launches_c3_bwd += 1
    dy1, dw, da, db = _launch_bwd(
        _dense(y1), _dense(w_ckn), _vec(a, c, y1), _vec(b, c, y1), _dense(y2), _dense(dy2),
        _vec(ds, n, y1), _vec(dq, n, y1), TAPS_3X3, True, (bsz * h * w_, h, w_), c, n)
    return dy1.reshape(y1.shape), dw.reshape(3, 3, c, n), da, db


# ------------------------------------------------------------- entry points
class MatmulBNStats(torch.autograd.Function):
    """``matmul_bn_stats`` with its fused backward; y, s and q all carry
    gradients (s and q feed the BatchNorm's mean and variance)."""

    @staticmethod
    def forward(ctx, x, w, a, b, prologue):
        y, s, q = matmul_bn_stats_fwd(x, w, a, b, prologue)
        ctx.save_for_backward(x, w, a, b, y)
        ctx.prologue = prologue
        return y, s, q

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, a, b, y = ctx.saved_tensors
        dx, dw, da, db = matmul_bn_stats_bwd(x, w, a, b, y, dy.to(y.dtype), ds, dq,
                                             ctx.prologue)
        if not ctx.prologue:
            da = db = None
        # dw rounded to the dtype the weight came in, as the JAX package's VJP
        return dx, dw.to(w.dtype), da, db, None


class Conv3x3BNStats(torch.autograd.Function):
    """``conv3x3_bn_stats`` with its fused backward; dw stays float32."""

    @staticmethod
    def forward(ctx, y1, a, b, w):
        y2, s, q = conv3x3_bn_stats_fwd(y1, a, b, w)
        ctx.save_for_backward(y1, a, b, w, y2)
        return y2, s, q

    @staticmethod
    def backward(ctx, dy2, ds, dq):
        y1, a, b, w, y2 = ctx.saved_tensors
        dy1, dw, da, db = conv3x3_bn_stats_bwd(y1, a, b, w, y2, dy2.to(y2.dtype), ds, dq)
        return dy1, da, db, dw.to(w.dtype)


def matmul_bn_stats(x, w, a=None, b=None, prologue: bool = False):
    """``(y, s, q)`` of the 1x1 conv as a matmul, differentiable in x, w, a, b
    through every output.  Without prologue a and b are ignored (pass None)."""
    if not prologue:
        a = b = None
    return MatmulBNStats.apply(x, w, a, b, prologue)


def conv3x3_bn_stats(y1, a, b, w):
    """``(y2, s, q)`` of the 3x3 conv of ``relu(a * y1 + b)``, differentiable
    in y1, a, b, w through every output."""
    return Conv3x3BNStats.apply(y1, a, b, w)
