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
  w_scale[n] (+ bias[n])`` as float32 or rounded to bf16 (``out_dtype``),
  [B, Ho, Wo, N];
- :func:`conv_s8_direct`: the same for a grouped or depthwise conv, w_q
  [N, KH, KW, C / groups], on the CUDA cores.

``x_scale`` is a Python float (absmax / 127 in double, as calibration returns
it), rounded to float32 once, at the kernel boundary, as the JAX package
does; or, for the quantize and the dense conv, a 0-d float32 tensor holding
an AMAX on the tensor's device, from which the kernel forms the scale ``amax
> 0 ? amax / 127 : 1`` (float32, IEEE division: ``jnp.where(amax > 0, amax /
127.0, 1.0)`` of the JAX package's quantization-aware training,
``iswm_tpu/ops/int8_train.py``), so that a scale computed on the card is
never read back to the host.  The plain versions take either form.  A padding is an int, ``(ph, pw)`` (each side) or ``((top, bottom),
(left, right))``.

Each wrapper launches a kernel for a CUDA tensor and uses its plain version
only for a CPU tensor; on a CUDA tensor a call no kernel takes raises.  The
plain conv is ``F.conv2d`` in float64 on the integer codes, exact while
127^2 K < 2^53, rounded to int32, then the same epilogue, then ``.to(out_dtype)``.

Each conv has two bodies, and the wrapper picks one (:func:`igemm_body`,
:func:`direct_body`): the dense conv's ``wgmma`` body for C % 16 == 0 and
its ``bytes`` body (the stem's C = 3); the grouped conv's ``tiled`` body for
a depthwise 3x3 of C % 16 == 0 at stride and dilation 1 or 2, its
``generic`` body for the rest.  :func:`plan_igemm` plans the ``wgmma`` body:
the output rectangle of a block, BN, ring slots and K splits, from a cost
model of the card (``block_bwd_ab.py --kind igemm --sweep`` times every
plan); :func:`tile_taps` is its tap-skipping rule.  ``launches_quantize``,
``launches_igemm`` and ``launches_direct`` count the launches of each entry,
``launches_by_body`` those of each body, ``launches_by_scale`` those of the
quantize and the dense conv by where the scale came from (``host``: a float,
``device``: an amax tensor).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

launches_quantize = 0
launches_igemm = 0
launches_direct = 0
launches_by_body = dict.fromkeys(("wgmma", "bytes", "tiled", "generic"), 0)
launches_by_scale = {entry: dict.fromkeys(("host", "device"), 0)
                     for entry in ("quantize", "igemm")}
_lib = None

OUT_DTYPES = (torch.float32, torch.bfloat16)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C entries of a library
    built from ``csrc/int8_conv.cu``."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.iswm_int8_quantize.argtypes = [ptr, i32, f32, ptr, i32, i32, i64, ptr]
    lib.iswm_int8_quantize.restype = i32
    lib.iswm_int8_quantize_amax.argtypes = [ptr, i32, ptr, ptr, i32, i32, i64, ptr]
    lib.iswm_int8_quantize_amax.restype = i32
    ints = ctypes.POINTER(i32)
    lib.iswm_int8_conv_igemm.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, i32, ints, ints, ptr, ptr]
    lib.iswm_int8_conv_igemm.restype = i32
    lib.iswm_int8_conv_igemm_amax.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ints, ints, ptr,
                                              ptr]
    lib.iswm_int8_conv_igemm_amax.restype = i32
    lib.iswm_int8_conv_direct.argtypes = [ptr, ptr, ptr, ptr, f32, ptr, i32, ints, i32, i32, ptr]
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


# ---------------------------------------------------------------- scales
def ieee_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b``, correctly rounded on any device: on a CUDA tensor PyTorch
    divides by a Python number as a product with its reciprocal, which may
    differ in the last bit; a tensor divisor gives a true division."""
    return a / torch.full_like(a, b)


def scale_of(x_scale, device) -> torch.Tensor:
    """The float32 scale, 0-d on ``device``, of either form of ``x_scale``: a
    float, or an amax tensor (``amax > 0 ? amax / 127 : 1``)."""
    if isinstance(x_scale, torch.Tensor):
        amax = x_scale.to(device=device, dtype=torch.float32)
        return torch.where(amax > 0, ieee_div(amax, 127.0), torch.ones_like(amax))
    return torch.tensor(x_scale, dtype=torch.float32, device=device)


def _scale_arg(x_scale, device, name: str) -> tuple:
    """(C entry suffix, argument, source) of ``x_scale`` on the card: a float
    goes by value, an amax tensor by its device pointer."""
    if not isinstance(x_scale, torch.Tensor):
        return "", float(x_scale), "host"
    if x_scale.dtype != torch.float32 or x_scale.numel() != 1 or x_scale.device != device:
        raise ValueError(f"{name}: the amax must be one float32 on {device}, got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)} on {x_scale.device}")
    return "_amax", x_scale.data_ptr(), "device"


# ---------------------------------------------------------------- quantize
def quantize_s8_plain(x: torch.Tensor, x_scale) -> torch.Tensor:
    """``clip(round(x / x_scale), -127, 127)`` as int8, in float32."""
    xs = scale_of(x_scale, x.device)
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


def quantize_s8(x: torch.Tensor, x_scale) -> torch.Tensor:
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
    suffix, scale, source = _scale_arg(x_scale, x.device, "quantize_s8")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if p == 0 or c == 0:
        return out
    lib, _ = load_library()
    global launches_quantize
    with torch.cuda.device(x.device):
        launches_quantize += 1
        launches_by_scale["quantize"][source] += 1
        rc = getattr(lib, f"iswm_int8_quantize{suffix}")(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale, out.data_ptr(), p, c, ld,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, lib, "quantize_s8")
    return out


def _raise_on(rc: int, lib, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: {lib.iswm_cuda_error_string(rc).decode()}")


# ------------------------------------------------------------------- convs
def _out_dtype(out_dtype) -> torch.dtype:
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    return out_dtype


def conv_s8_plain(x_q, w_q, w_scale, x_scale, bias=None, stride=1, padding=0,
                  dilation=1, groups=1, out_dtype=torch.float32) -> torch.Tensor:
    """The plain version of both convs: int8 NHWC x_q, OHWI w_q (C / groups
    input channels) -> [B, Ho, Wo, N] in ``out_dtype``.  The integer
    products are summed in float64 (exact), rounded to int32, then ``(acc *
    x_scale) * w_scale (+ bias)`` in float32, then rounded to ``out_dtype``."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    out_dtype = _out_dtype(out_dtype)
    g = conv_geometry(x_q.shape, w_q.shape, stride, padding, dilation, groups)
    (pt, pb), (pl, pr) = g["pads"]
    xd = F.pad(x_q.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(xd, w_q.permute(0, 3, 1, 2).double(), None, (g["sh"], g["sw"]), 0,
                   (g["dh"], g["dw"]), groups)
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)
    out = acc.float() * scale_of(x_scale, x_q.device) * w_scale.float().reshape(-1)
    if bias is not None:
        out = out + bias.float().reshape(-1)
    return out.contiguous().to(out_dtype)


def _weight_rows(w_q: torch.Tensor) -> torch.Tensor:
    """OHWI int8 w_q -> [N, ldw] rows of (kh, kw, c), ldw = K rounded up to
    16 and zero past K, as the dense kernel reads them; a view of contiguous
    w_q when K is a multiple of 16."""
    n, k = w_q.shape[0], w_q[0].numel()
    rows = w_q.reshape(n, k)
    if k % 16 == 0:
        return rows.contiguous()
    return F.pad(rows, (0, 16 - k % 16))


# ------------------------------------------------------- the dense plan
GEOM_KEYS = ("B", "H", "W", "C", "Ho", "Wo", "N", "KH", "KW", "sh", "sw", "ph", "pw", "dh",
             "dw")
BM, BK = 128, 128          # output pixels of a block; K bytes of a stage
MAX_TAPS = 64              # taps a kernel of the wgmma body may have
DENSE_PLANS = ((256, 4), (128, 4), (128, 3), (64, 4), (8, 4))  # built (BN, slots)
TILE_WIDTHS = (128, 64, 32, 16, 8)    # TW of a block's TH x TW output rectangle
SPLITS = (1, 2, 4, 8, 16)
SMS = 132                  # SMs of an H100 SXM
SM_SMEM = 233472           # shared memory of an SM, with 1 KB reserved a block
SMEM_MAX = 232448          # shared memory a block may ask for


def dense_smem(bn: int, slots: int) -> tuple[int, int]:
    """(dynamic, static) shared memory bytes of the wgmma body: the ring of
    (128 + BN) x 128-byte stages, which the staged int32 tile [128][BN + 8]
    reuses; the tap table, the tile's weight scales and biases, the ring's
    mbarriers."""
    return max(slots * (BM + bn) * BK, BM * (bn + 8) * 4), MAX_TAPS * 16 + 4 + 8 * bn + 8 * slots


def igemm_body(g: dict) -> str:
    """``wgmma`` where every 16-byte chunk of K lies in one tap (C % 16 ==
    0), else ``bytes``, the byte-gathering body (the stem's C = 3)."""
    return "wgmma" if g["C"] % 16 == 0 and g["KH"] * g["KW"] <= MAX_TAPS else "bytes"


def _axis_hits(o0: int, o1: int, s: int, off: int, n: int) -> bool:
    """Whether some output position o in [o0, o1] reads o s + off inside [0,
    n): those positions are ceil(-off / s) .. floor((n - 1 - off) / s)."""
    if n - 1 - off < 0:
        return False
    lo = 0 if off >= 0 else (-off + s - 1) // s
    return max(lo, o0) <= min((n - 1 - off) // s, o1)


@functools.lru_cache(maxsize=256)
def _tile_taps(key: tuple, tw: int) -> tuple[tuple, tuple]:
    g = dict(zip(GEOM_KEYS, key))
    th = BM // tw

    def axis(out, t, k, s, d, p, n):
        return tuple(tuple(i for i in range(k) if _axis_hits(o0, min(o0 + t, out) - 1, s,
                                                             i * d - p, n))
                     for o0 in range(0, out, t))

    return (axis(g["Ho"], th, g["KH"], g["sh"], g["dh"], g["ph"], g["H"]),
            axis(g["Wo"], tw, g["KW"], g["sw"], g["dw"], g["pw"], g["W"]))


def tile_taps(g: dict, tw: int) -> tuple[tuple, tuple]:
    """The wgmma body's tap-skipping rule for output rectangles of 128 / tw
    x tw pixels: (for each rectangle row ty, the kernel rows kh that read
    inside the input for at least one of its output rows; for each rectangle
    column tx, the kernel columns kw alike).  A block at (ty, tx) walks the K
    of the taps (kh, kw) of both lists, in (kh, kw) order, and skips the
    rest: each of those reads only zero padding for every pixel of the
    block."""
    return _tile_taps(tuple(g[k] for k in GEOM_KEYS), tw)


def dense_tma(g: dict) -> bool:
    """Whether the wgmma body copies the weights by TMA: where every 64-byte
    half of a K stage lies in one tap (C % 64 == 0) and K has 1,024 bytes or
    more (a one- or two-stage K runs faster without the mbarrier's setup)."""
    return g["C"] % 64 == 0 and g["KH"] * g["KW"] * g["C"] >= 1024


def _dense_cost(g: dict, tw: int, bn: int, slots: int, splits: int, out_bytes: int) -> float:
    """Estimated SM cycles of a plan, a model fitted to every plan's time at
    the serving chunk's shapes on an H100 (``block_bwd_ab.py --kind igemm
    --sweep``; PERF.md).  A 128-byte K stage of a block takes the longer of
    its tensor work (4 BN cycles: two m64nBNk32 warpgroups at 8,192 int8
    operations a cycle an SM) and its copies out of L2 (the A tile's 128 x
    128 bytes and the B tile's BN x 128, at 20 bytes a cycle an SM, the B
    tile a quarter of that by TMA: the bound of the 3x3s and the ASPP
    branches); a block alone on its SM waits no less than 1,500 cycles of
    copy latency over the stages in flight.  A block adds 2,000 cycles and
    its stores at 16 bytes a cycle (prologue and epilogue), which a second
    block on the SM (``occ``) hides by half.  An SM runs its share of the
    blocks one after another; a K split adds its finishing pass: 4,000
    cycles and its bytes at 1,909 a cycle (3.35 TB/s)."""
    rows, cols = tile_taps(g, tw)
    kept = np.outer([len(r) for r in rows], [len(c) for c in cols]) * g["C"]
    steps = np.ceil(np.ceil(kept / BK) / splits)
    blocks = g["B"] * kept.size * splits * -(-g["N"] // bn)
    dyn, static = dense_smem(bn, slots)
    per_sm = -(-blocks // SMS)
    occ = max(1, min(2, SM_SMEM // (dyn + static + 1024), per_sm))
    step = max(4 * bn, (BM + (0.25 if dense_tma(g) else 1) * bn) * BK / 20)
    if occ == 1:
        step = max(step, 1500 / (slots - 2))
    cost = per_sm * (float(steps.mean()) * step + (2000 + BM * bn * out_bytes / 16) / occ)
    if splits > 1:
        m_n = g["B"] * g["Ho"] * g["Wo"] * g["N"]
        cost += 4000 + m_n * (4 * splits + out_bytes) / 1909
    return cost


@functools.lru_cache(maxsize=256)
def _plan(key: tuple, out_bytes: int) -> dict:
    g = dict(zip(GEOM_KEYS, key))
    best, best_cost = None, math.inf
    for bn, slots in DENSE_PLANS:
        if bn == 8 and g["N"] > 8:
            continue
        for tw in TILE_WIDTHS:
            for splits in SPLITS:
                cost = _dense_cost(g, tw, bn, slots, splits, out_bytes)
                if cost < best_cost:
                    best, best_cost = (tw, bn, slots, splits), cost
    tw, bn, slots, splits = best
    rows, cols = tile_taps(g, tw)
    kept = np.outer([len(r) for r in rows], [len(c) for c in cols])
    return {"tw": tw, "bn": bn, "slots": slots, "splits": splits, "tma": dense_tma(g),
            "blocks": g["B"] * kept.size * splits * -(-g["N"] // bn),
            "kept": float(kept.mean()) / (g["KH"] * g["KW"])}


def plan_igemm(g: dict, out_bytes: int = 4) -> dict:
    """The wgmma body's plan for a geometry (``conv_geometry``'s keys) and
    output element size: ``tw`` (the block's output rectangle is 128 / tw x
    tw pixels), ``bn``, ``slots`` (of the ring), ``splits`` (of K), ``tma``
    (the weights by TMA: :func:`dense_tma`), the ``blocks`` of the launch and
    the ``kept`` share of the taps' K steps after tap skipping."""
    return dict(_plan(tuple(g[k] for k in GEOM_KEYS), out_bytes))


def dense_launch(g: dict, out_dtype, plan: dict | None = None) -> tuple[dict, tuple]:
    """(the geometry the dense C entry runs, its plan array: body (0 wgmma, 1
    bytes), log2 of the tile width, BN, slots, splits, tma) for a conv
    geometry and output dtype; ``plan`` overrides the planner's wgmma plan."""
    if igemm_body(g) == "bytes":
        return g, (1, 0, 0, 0, 1, 0)
    g = as_rows(g)
    p = plan or plan_igemm(g, 2 if out_dtype == torch.bfloat16 else 4)
    return g, (0, p["tw"].bit_length() - 1, p["bn"], p["slots"], p["splits"], int(p["tma"]))


def as_rows(g: dict) -> dict:
    """A 1x1 conv of stride 1 and no padding is a matmul over the pixels:
    its geometry as one row of B H W pixels, so that a block's 128 pixels
    run on across rows and images."""
    if (g["KH"], g["KW"], g["sh"], g["sw"], g["ph"], g["pw"]) != (1, 1, 1, 1, 0, 0):
        return g
    m = g["B"] * g["H"] * g["W"]
    return {**g, "B": 1, "H": 1, "W": m, "Ho": 1, "Wo": m}


def direct_body(g: dict, groups: int) -> str:
    """``tiled`` for a depthwise 3x3 (C = N = groups) with C % 16 == 0 and
    the same stride and dilation, 1 or 2, on both axes; else ``generic``."""
    tiled = (groups == g["C"] == g["N"] and g["C"] % 16 == 0 and g["KH"] == g["KW"] == 3
             and g["sh"] == g["sw"] in (1, 2) and g["dh"] == g["dw"] in (1, 2))
    return "tiled" if tiled else "generic"


def _launch(kind: str, x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
            groups, out_dtype) -> torch.Tensor:
    name = f"conv_s8_{kind}"
    if x_q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {x_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    out_dtype = _out_dtype(out_dtype)
    if torch.cuda.get_device_capability(x_q.device) != (9, 0):
        raise RuntimeError(f"the {name} kernel is built for sm_90a (H100/H200)")
    g = conv_geometry(x_q.shape, w_q.shape, stride, padding, dilation, groups)
    shape = (g["B"], g["Ho"], g["Wo"], g["N"])
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
    suffix, scale, source = _scale_arg(x_scale, x_q.device, name)
    if suffix and kind != "igemm":
        raise ValueError(f"{name} takes its scale from the host (a float), not an amax tensor")
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    plan = None
    if kind == "igemm":
        body = igemm_body(g)
        w = _weight_rows(w_q)
        ldw = w.shape[1]
        if body == "bytes" and -(-m // 128) > 65535:
            raise ValueError(f"{name}: {m} output pixels exceed the grid")
        g, plan = dense_launch(g, out_dtype)
        if body == "wgmma":
            p = plan_igemm(g, out_bytes)
            dyn, static = dense_smem(p["bn"], p["slots"])
            if p["blocks"] >= 2**31 or dyn + static > SMEM_MAX:
                raise ValueError(f"{name}: plan {p} exceeds the grid or the shared memory")
    else:
        body = direct_body(g, groups)
        w, ldw = w_q.contiguous(), k
        if body == "tiled":
            th = 256 // (64 if g["C"] % 64 == 0 else 32 if g["C"] % 32 == 0 else 16)
            if g["B"] * -(-g["Ho"] // th) * -(-g["Wo"] // 16) * g["C"] // 16 >= 2**31:
                raise ValueError(f"{name}: {tuple(x_q.shape)} exceeds the grid")
    tensors = [x_q, w, w_scale] + ([bias] if bias is not None else [])
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("x_q, w_q, w_scale and bias must be on one device")
    if w.data_ptr() % 16:
        raise ValueError("w_q must be 16-byte aligned")
    ws = w_scale.reshape(g["N"]).to(torch.float32).contiguous()
    bs = None if bias is None else bias.reshape(g["N"]).to(torch.float32).contiguous()
    out = torch.empty(shape, dtype=out_dtype, device=x_q.device)
    if m == 0:
        return out
    partial = None
    if plan is not None and plan[4] > 1:
        partial = torch.empty((plan[4], m * g["N"]), dtype=torch.int32, device=x_q.device)
    geom = (ctypes.c_int * 17)(*(g[key] for key in GEOM_KEYS), k, ldw)
    lib, _ = load_library()
    global launches_igemm, launches_direct
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        args = (x_q.data_ptr(), w.data_ptr(), ws.data_ptr(),
                None if bs is None else bs.data_ptr(), scale, out.data_ptr(),
                int(out_dtype == torch.bfloat16), geom)
        launches_by_body[body] += 1
        if kind == "igemm":
            launches_igemm += 1
            launches_by_scale["igemm"][source] += 1
            rc = getattr(lib, f"iswm_int8_conv_igemm{suffix}")(
                *args, (ctypes.c_int * 6)(*plan),
                None if partial is None else partial.data_ptr(), stream)
        else:
            launches_direct += 1
            rc = lib.iswm_int8_conv_direct(*args, groups, 0 if body == "tiled" else 1, stream)
    _raise_on(rc, lib, name)
    return out


def conv_s8_igemm(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                  x_scale, bias: torch.Tensor | None = None, stride=1, padding=0,
                  dilation=1, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense int8 conv (see the module docstring): x_q [B, H, W, C] int8,
    w_q [N, KH, KW, C] int8 -> [B, Ho, Wo, N] in ``out_dtype`` (float32 or
    bfloat16).  The weights are read as :func:`_weight_rows`, a view of
    contiguous w_q unless K is no multiple of 16."""
    if x_q.device.type == "cpu":
        return conv_s8_plain(x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                             out_dtype=out_dtype)
    return _launch("igemm", x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation, 1,
                   out_dtype)


def conv_s8_direct(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                   x_scale: float, bias: torch.Tensor | None = None, stride=1, padding=0,
                   dilation=1, groups: int = 1,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped / depthwise int8 conv: x_q [B, H, W, C] int8, w_q [N, KH, KW,
    C / groups] int8 -> [B, Ho, Wo, N] in ``out_dtype`` (groups > 1)."""
    if x_q.device.type == "cpu":
        return conv_s8_plain(x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                             groups, out_dtype)
    return _launch("direct", x_q, w_q, w_scale, x_scale, bias, stride, padding, dilation,
                   groups, out_dtype)
