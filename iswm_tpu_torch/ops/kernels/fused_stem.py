"""Fused ResNet stem tail, BatchNorm(train) + ReLU + 3x3/s2 max-pool with a
fused backward: the CUDA kernels ``csrc/fused_stem.cu`` for Hopper, their
wrappers and their plain versions.

Counterpart of ``iswm_tpu/ops/pallas/fused_stem.py``.  Tensors are NCHW as
everywhere in this package: the image ``x`` [B, 3, 2S, 2S], the 7x7 / stride 2
/ pad 3 conv's output ``z`` [B, 64, S, S], the pooled ``p`` [B, 64, S/2, S/2].
The conv's forward stays ``F.conv2d`` (the JAX package leaves it to XLA);
everything after it, and the conv's weight gradient, is here:

- ``stem_stats(z)``: per-channel (sum z, sum z^2) in float32 over z as stored.
- ``stem_norm_relu_pool(z, scale, bias)``: ``maxpool3x3/s2/p1(relu(z * scale +
  bias))``, the affine in float32, the output in z's dtype.
- ``stem_tail_bwd(z, x, dp, gamma, beta, mean, sigma_inv)``: two kernels.
  The first recomputes y and the pool's argmax and sums ``s1 = sum d_bn``
  (dbeta) and ``s2 = sum d_bn * yhat`` (dgamma).  The second recomputes again,
  forms ``dz = gamma * sigma_inv * (d_bn - s1/N - yhat * s2/N)`` rounded to
  z's dtype and contracts it with the image's 7x7x3 windows into dW
  [64, 3, 7, 7] in float32 (bf16 on the tensor cores, float32 on the FMA
  units); dz never reaches device memory.
- ``stem_fused_train`` / ``stem_fused_eval``: the entry points the model uses.

Semantics, as the JAX kernels': float32 statistics with the fast variance
``max(0, E[z^2] - E[z]^2)``; pool-gradient ties are EQUAL-SPLIT (every
position of a window that equals the window's maximum receives dp / count,
where PyTorch's max-pool sends all of it to one index: a subgradient choice,
the gradient mass per window is the same); the ReLU mask is on the
post-affine y; the image receives NO gradient (NaN-filled when asked for, so
that saliency or adversarial code fails loudly; use ``fused_stem="never"``
there).

Each wrapper launches its kernel for a CUDA tensor and uses the plain version
only for a CPU tensor (the counterpart of Pallas interpret mode; the setting
``fused_stem="interpret"`` therefore means ``"always"``, and a test that
wants the plain version on the card calls the ``*_plain`` functions).  The
kernels read and write NHWC
memory (``torch.channels_last``), which is how the Trainer and the Predictor
keep the model on the card; a CUDA tensor in another layout is copied to it
once by the wrapper.  ``launches_*`` count the wrapper calls that launched a
kernel.

``stem_norm_relu_pool`` (#10), the one kernel of an eval forward, is the
dispatcher's operator ``torch.ops.iswm.stem_norm_relu_pool``
(``ops/kernels/__init__.py``): CUDA the kernel, CPU the plain version, and a
fake that gives the output's strides as each device's implementation does
(NHWC memory on the card, z's memory format on the CPU), so that a serving
fn exports with it.  The statistics and the backward (training) launch
through ctypes, outside the dispatcher.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...parallel.distributed import group_batch_sums, is_initialized, statistics_sum
from . import ctypes_entry, op

launches_stats = 0
launches_pool = 0
launches_bwd_sums = 0
launches_bwd_wgrad = 0
_lib = None
CHANNELS = 64  # the kernels are built for the stem's 64 channels
KERNEL_SIZE, STRIDE, PADDING = 7, 2, 3


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C entries of a library
    built from ``csrc/fused_stem.cu``."""
    ll, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.iswm_stem_stats.argtypes = [ptr, i32, ll, ptr, ptr, ptr]
    lib.iswm_stem_pool_fwd.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.iswm_stem_bwd_sums.argtypes = [ptr, ptr, i32, i32, i32] + [ptr] * 7
    lib.iswm_stem_bwd_wgrad.argtypes = [ptr, ptr, ptr, i32, i32, i32] + [ptr] * 9
    entries = [lib.iswm_stem_stats, lib.iswm_stem_pool_fwd, lib.iswm_stem_bwd_sums,
               lib.iswm_stem_bwd_wgrad, lib.iswm_stem_reduce_scratch, lib.iswm_stem_wgrad_scratch]
    if hasattr(lib, "iswm_stem_bwd_tiles"):  # not in the sources before the staged bf16 body
        lib.iswm_stem_bwd_sums_tiled.argtypes = [ptr, ptr, i32, i32] + [ptr] * 6 + [i32, i32, ptr]
        lib.iswm_stem_bwd_wgrad_tiled.argtypes = ([ptr, ptr, ptr, i32, i32] + [ptr] * 8
                                                  + [i32, i32, ptr])
        lib.iswm_stem_bwd_tiles.argtypes = [ctypes.POINTER(i32)]
        lib.iswm_stem_bwd_tiles.restype = None
        entries += [lib.iswm_stem_bwd_sums_tiled, lib.iswm_stem_bwd_wgrad_tiled]
    for fn in entries:
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

        lib, log = build_and_load("fused_stem")
        _lib = bind(lib)
    return _lib, log


def bwd_tiles() -> dict:
    """The conv-pixel tiles (rows, columns) of the bf16 backward's two kernels
    (the built library, so the card's machine)."""
    out = (ctypes.c_int * 4)()
    load_library()[0].iswm_stem_bwd_tiles(out)
    return {"sums": (out[0], out[1]), "wgrad": (out[2], out[3])}


# ------------------------------------------------------------ plain versions
def _check(z: torch.Tensor, dp: torch.Tensor | None = None,
           x: torch.Tensor | None = None) -> None:
    if z.ndim != 4 or z.shape[2] != z.shape[3] or z.shape[2] % 2 or z.shape[2] < 4:
        raise ValueError(f"z must be [B, F, S, S] with S even and >= 4, got {tuple(z.shape)}")
    b, f, s, _ = z.shape
    if dp is not None and tuple(dp.shape) != (b, f, s // 2, s // 2):
        raise ValueError(f"dp {tuple(dp.shape)} does not match z {tuple(z.shape)}")
    if x is not None and (x.ndim != 4 or x.shape[0] != b
                          or tuple(x.shape[2:]) != (2 * s, 2 * s)):
        raise ValueError(f"x {tuple(x.shape)} does not match z {tuple(z.shape)}")


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.float().reshape(1, -1, 1, 1)


def _relu_affine(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = relu(z * scale + bias) in float32 (a multiply, then an add)."""
    return torch.relu(z.float() * _per_channel(scale) + _per_channel(bias))


def _window_slices(s: int):
    """The nine strided slices of a zero-padded [.., S + 2, S + 2] map that
    hold, for every pool window, its position (di, dj)."""
    stop = s - 1  # di + 2 * (S/2 - 1) + 1
    return [(slice(di, di + stop, 2), slice(dj, dj + stop, 2))
            for di in range(3) for dj in range(3)]


def _window_max(y: torch.Tensor):
    """(zero-padded y, its nine window views, the windows' maxima).  Zero
    stands for -inf in the padding because y >= 0."""
    yp = F.pad(y, (1, 1, 1, 1))
    views = [yp[:, :, rows, cols] for rows, cols in _window_slices(y.shape[2])]
    pmax = views[0]
    for v in views[1:]:
        pmax = torch.maximum(pmax, v)
    return yp, views, pmax


def stem_stats_plain(z: torch.Tensor, dtype: torch.dtype = torch.float32):
    """(sum z, sum z^2) per channel, summed in ``dtype`` (float32 as the
    kernel; float64 for a reference)."""
    _check(z)
    zf = z.to(dtype)
    return zf.sum(dim=(0, 2, 3)), (zf * zf).sum(dim=(0, 2, 3))


def stem_norm_relu_pool_plain(z: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3/s2/p1(relu(z * scale + bias))`` in z's dtype."""
    _check(z)
    return _window_max(_relu_affine(z, scale, bias))[2].to(z.dtype)


def _bwd_terms(z, dp, scale, bias, mean, sigma_inv):
    """(d_bn, yhat) in float32: the ReLU-masked equal-split pool gradient and
    the normalized conv output.  Every position of a window that equals the
    window's maximum gets dp / count; a conv pixel lies in one, two or four
    windows, whose shares reach it in the order of the nine slices."""
    y = _relu_affine(z, scale, bias)
    yp, views, pmax = _window_max(y)
    count = torch.zeros_like(pmax)
    for v in views:
        count += v == pmax
    share = dp.float() / count.clamp_min(1.0)
    dyp = torch.zeros_like(yp)
    for (rows, cols), v in zip(_window_slices(y.shape[2]), views):
        dyp[:, :, rows, cols] += torch.where(v == pmax, share, 0.0)
    d_bn = torch.where(y > 0, dyp[:, :, 1:-1, 1:-1], 0.0)
    yhat = (z.float() - _per_channel(mean)) * _per_channel(sigma_inv)
    return d_bn, yhat


def stem_bwd_sums_plain(z, dp, scale, bias, mean, sigma_inv,
                        dtype: torch.dtype = torch.float32):
    """(s1, s2) = (sum d_bn, sum d_bn * yhat) per channel, summed in ``dtype``."""
    _check(z, dp)
    d_bn, yhat = _bwd_terms(z, dp, scale, bias, mean, sigma_inv)
    d_bn, yhat = d_bn.to(dtype), yhat.to(dtype)
    return d_bn.sum(dim=(0, 2, 3)), (d_bn * yhat).sum(dim=(0, 2, 3))


def stem_bwd_wgrad_plain(z, dp, x, scale, bias, mean, sigma_inv, mean_s1, mean_s2,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dW [F, C, 7, 7] in ``dtype``: dz rounded to z's dtype, then contracted
    with the image's windows (stride 2, pad 3) in ``dtype``."""
    _check(z, dp, x)
    d_bn, yhat = _bwd_terms(z, dp, scale, bias, mean, sigma_inv)
    dz = (_per_channel(scale) * (d_bn - _per_channel(mean_s1)
                                 - yhat * _per_channel(mean_s2))).to(z.dtype)
    shape = (z.shape[1], x.shape[1], KERNEL_SIZE, KERNEL_SIZE)
    return torch.nn.grad.conv2d_weight(x.to(dtype), shape, dz.to(dtype),
                                       stride=STRIDE, padding=PADDING)


# ------------------------------------------------------------- CUDA wrappers
def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in dense NHWC memory, 16-byte aligned: itself when it already
    is (the model on the card), else the one copy the kernels need."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.channels_last)


def _cuda_check(z: torch.Tensor, *others: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"the fused stem runs on CUDA or CPU, not {z.device}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"z must be bf16 or f32, got {z.dtype}")
    if z.shape[1] != CHANNELS:
        raise ValueError(f"the stem kernels take {CHANNELS} channels, got {z.shape[1]}")
    for t in others:
        if t.device != z.device or t.dtype != z.dtype:
            raise ValueError(f"every tensor must be {z.dtype} on {z.device}, got "
                             f"{t.dtype} on {t.device}")
    if torch.cuda.get_device_capability(z.device) != (9, 0):
        raise RuntimeError("the fused stem kernels are built for sm_90a (H100/H200)")


def _vec(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    v = v.detach().to(device=like.device, dtype=torch.float32).contiguous()
    if v.numel() != CHANNELS:
        raise ValueError(f"per-channel vectors have {CHANNELS} entries, got {v.numel()}")
    return v


def _raise_on(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.iswm_cuda_error_string(rc).decode()}")


def _scratch(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(n, dtype=torch.float32, device=like.device)


@ctypes_entry
def stem_stats(z: torch.Tensor):
    """Per-channel (sum, sum of squares) of z [B, F, S, S] in float32."""
    _check(z)
    if z.device.type == "cpu":
        return stem_stats_plain(z)
    _cuda_check(z)
    z = _nhwc(z)
    lib, _ = load_library()
    scratch, out = _scratch(lib.iswm_stem_reduce_scratch(), z), _scratch(2 * CHANNELS, z)
    global launches_stats
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        launches_stats += 1
        rc = lib.iswm_stem_stats(z.data_ptr(), int(z.dtype == torch.bfloat16),
                                 z.numel() // CHANNELS, scratch.data_ptr(),
                                 out.data_ptr(), stream)
    _raise_on(lib, rc, "stem_stats")
    return out[:CHANNELS], out[CHANNELS:]


def _pool_cuda(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check(z)
    _cuda_check(z)
    z, scale, bias = _nhwc(z), _vec(scale, z), _vec(bias, z)
    b, f, s, _ = z.shape
    p = torch.empty((b, f, s // 2, s // 2), dtype=z.dtype, device=z.device,
                    memory_format=torch.channels_last)
    lib, _ = load_library()
    global launches_pool
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        launches_pool += 1
        rc = lib.iswm_stem_pool_fwd(z.data_ptr(), int(z.dtype == torch.bfloat16), b, s,
                                    scale.data_ptr(), bias.data_ptr(), p.data_ptr(), stream)
    _raise_on(lib, rc, "stem_norm_relu_pool")
    return p


def _pool_format(z: torch.Tensor) -> torch.memory_format:
    """The memory format of #10's output: the kernel's NHWC on the card, z's
    on the CPU (channels last where z is that and not also contiguous)."""
    if z.device.type == "cuda" or (z.is_contiguous(memory_format=torch.channels_last)
                                   and not z.is_contiguous()):
        return torch.channels_last
    return torch.contiguous_format


def _pool_fake(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check(z)
    b, f, s, _ = z.shape
    return torch.empty((b, f, s // 2, s // 2), dtype=z.dtype, device=z.device,
                       memory_format=_pool_format(z))


_pool = op("stem_norm_relu_pool(Tensor z, Tensor scale, Tensor bias) -> Tensor",
           lambda z, scale, bias: stem_norm_relu_pool_plain(z, scale, bias).contiguous(
               memory_format=_pool_format(z)),
           _pool_cuda, _pool_fake)


def stem_norm_relu_pool(z: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3/s2/p1(relu(z * scale + bias))``: z [B, F, S, S] ->
    [B, F, S/2, S/2] in z's dtype (NHWC memory from the kernel).

    ``scale`` / ``bias`` are the folded BN affine ([F] float32):
    ``scale = gamma * sigma_inv``, ``bias = beta - mean * scale``."""
    return _pool(z, scale, bias)


@ctypes_entry
def stem_bwd_sums(z, dp, scale, bias, mean, sigma_inv):
    """(s1, s2) [F] float32 of the fused backward's first kernel."""
    _check(z, dp)
    if z.device.type == "cpu":
        return stem_bwd_sums_plain(z, dp, scale, bias, mean, sigma_inv)
    _cuda_check(z, dp)
    z, dp = _nhwc(z), _nhwc(dp)
    vectors = [_vec(v, z) for v in (scale, bias, mean, sigma_inv)]
    lib, _ = load_library()
    scratch, out = _scratch(lib.iswm_stem_reduce_scratch(), z), _scratch(2 * CHANNELS, z)
    global launches_bwd_sums
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        launches_bwd_sums += 1
        rc = lib.iswm_stem_bwd_sums(
            z.data_ptr(), dp.data_ptr(), int(z.dtype == torch.bfloat16), z.shape[0],
            z.shape[2], *(v.data_ptr() for v in vectors), scratch.data_ptr(),
            out.data_ptr(), stream)
    _raise_on(lib, rc, "stem_tail_bwd sums")
    return out[:CHANNELS], out[CHANNELS:]


@ctypes_entry
def stem_bwd_wgrad(z, dp, x, scale, bias, mean, sigma_inv, mean_s1,
                   mean_s2) -> torch.Tensor:
    """dW [F, 3, 7, 7] float32 of the fused backward's second kernel;
    ``mean_s1 = s1 / N``, ``mean_s2 = s2 / N`` with N = B * S * S."""
    _check(z, dp, x)
    if z.device.type == "cpu":
        return stem_bwd_wgrad_plain(z, dp, x, scale, bias, mean, sigma_inv,
                                    mean_s1, mean_s2)
    _cuda_check(z, dp, x)
    if x.shape[1] != 3:
        raise ValueError(f"the wgrad kernel takes a 3-channel image, got {x.shape[1]}")
    z, dp, x = _nhwc(z), _nhwc(dp), _nhwc(x)
    vectors = [_vec(v, z) for v in (scale, bias, mean, sigma_inv, mean_s1, mean_s2)]
    lib, _ = load_library()
    scratch = _scratch(lib.iswm_stem_wgrad_scratch(), z)
    dw = torch.empty((CHANNELS, 3, KERNEL_SIZE, KERNEL_SIZE), dtype=torch.float32,
                     device=z.device)
    global launches_bwd_wgrad
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        launches_bwd_wgrad += 1
        rc = lib.iswm_stem_bwd_wgrad(
            z.data_ptr(), dp.data_ptr(), x.data_ptr(), int(z.dtype == torch.bfloat16),
            z.shape[0], z.shape[2], *(v.data_ptr() for v in vectors),
            scratch.data_ptr(), dw.data_ptr(), stream)
    _raise_on(lib, rc, "stem_tail_bwd wgrad")
    return dw


def fold_affine(gamma, beta, mean, sigma_inv):
    """(scale, bias) float32: ``gamma * sigma_inv``, ``beta - mean * scale``."""
    scale = gamma.float() * sigma_inv
    return scale, beta.float() - mean * scale


def stem_tail_bwd(z, x, dp, gamma, beta, mean, sigma_inv, n=None):
    """Fused backward of ``pool(relu(bn(conv(x))))`` given d(pooled).

    z: the conv output [B, F, S, S] (the residual, in the compute dtype);
    x: the image [B, 3, 2S, 2S]; dp: the pooled output's cotangent;
    gamma / beta: the BN affine [F]; mean / sigma_inv: the batch statistics
    [F] float32; n: the values a channel they were taken over (default
    B * S * S; in a process group the group's count, which the caller
    passes).  Returns (dW [F, 3, 7, 7] float32, dgamma [F], dbeta [F]).

    In a process group the statistics are the group's: the first kernel's
    sums are all-reduced before the second kernel takes them, and dgamma /
    dbeta are this rank's sums from before the all-reduce, its share, which
    the gradient reduction (a sum over the ranks) completes; the global sums
    there would count every rank's rows once for each rank."""
    scale, bias = fold_affine(gamma, beta, mean, sigma_inv)
    s1, s2 = stem_bwd_sums(z, dp, scale, bias, mean, sigma_inv)
    if n is None:
        n = z.numel() // z.shape[1]
    g1, g2 = s1, s2
    if is_initialized():
        g1, g2 = statistics_sum(torch.cat([s1, s2])).chunk(2)
    dw = stem_bwd_wgrad(z, dp, x, scale, bias, mean, sigma_inv, g1 / n, g2 / n)
    return dw, s2, s1


# ------------------------------------------------------------- entry points
def _stem_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7x7 / stride 2 / pad 3 conv in x's dtype (left to the library, as
    the JAX package leaves it to XLA)."""
    return F.conv2d(x, weight.to(x.dtype), None, STRIDE, PADDING)


class StemFusedTrain(torch.autograd.Function):
    """``pool3x3s2p1(relu(bn_train(conv(x, weight))))`` with the fused tail.

    Saves z, x, gamma, beta and the batch statistics; the backward is the two
    kernels of :func:`stem_tail_bwd`.  The statistics feed the caller's
    running averages and carry no gradient.

    In a process group the statistics are the global batch's, as the JAX
    package's under a jit sharded over the data axis: ``(sum z, sum z^2, n)``
    of ``stem_stats`` go through one all-reduce before ``fold_affine``, so
    ``stem_norm_relu_pool`` normalizes with them, and the backward
    all-reduces the first kernel's sums before the second.  dgamma and
    dbeta stay this rank's local sums (see :func:`stem_tail_bwd`), the
    weight gradient this rank's rows' contraction: the data-parallel step's
    gradient reduction sums them over the ranks, as ``CrossReplicaBatchNorm``
    keeps its ``dweight`` and ``dbias`` local."""

    @staticmethod
    def forward(ctx, x, weight, gamma, beta, eps):
        z = _stem_conv(x, weight)
        n = z.numel() // z.shape[1]
        total, total_sq = stem_stats(z)
        total, total_sq, n = group_batch_sums(total, total_sq, n)
        ctx.n = n
        mean = total / n
        var = torch.clamp_min(total_sq / n - mean * mean, 0.0)
        sigma_inv = torch.rsqrt(var + eps)
        scale, bias = fold_affine(gamma, beta, mean, sigma_inv)
        p = stem_norm_relu_pool(z, scale, bias)
        ctx.save_for_backward(z, x, gamma, beta, mean, sigma_inv)
        ctx.weight_dtype = weight.dtype
        ctx.mark_non_differentiable(mean, var)
        return p, mean, var

    @staticmethod
    def backward(ctx, dp, _dmean, _dvar):
        z, x, gamma, beta, mean, sigma_inv = ctx.saved_tensors
        dw, dgamma, dbeta = stem_tail_bwd(z, x, dp.to(z.dtype), gamma, beta, mean,
                                          sigma_inv, ctx.n)
        # d(image) is deliberately not computed: the stem is the first layer.
        # NaN and not zero, so that a caller who does ask for it fails loudly.
        dx = torch.full_like(x, float("nan")) if ctx.needs_input_grad[0] else None
        return (dx, dw.to(z.dtype).to(ctx.weight_dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None)


def stem_fused_train(x, weight, gamma, beta, eps: float):
    """(pooled [B, F, S/2, S/2], batch mean [F], batch var [F]) of the image
    x [B, 3, 2S, 2S], the conv weight [F, 3, 7, 7] and the BN affine."""
    return StemFusedTrain.apply(x, weight, gamma, beta, eps)


class StemFusedEval(torch.autograd.Function):
    """``pool3x3s2p1(relu(conv(x, weight) * scale + bias))``, forward only.

    The inference tail has no backward in the JAX package (differentiating
    its kernel raises), and a ctypes launch records no autograd node: so the
    backward raises here too, on either device, instead of leaving conv1 and
    bn1 silently without a gradient."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias):
        return stem_norm_relu_pool(_stem_conv(x, weight), scale, bias)

    @staticmethod
    def backward(ctx, _dp):
        raise RuntimeError(
            "the fused stem's eval forward has no backward: differentiate in train mode, "
            "or build the model with fused_stem='never'")


def stem_fused_eval(x, weight, scale, bias) -> torch.Tensor:
    """The inference stem tail: conv, then the affine folded from the running
    statistics + ReLU + pool.  Not differentiable (see :class:`StemFusedEval`)."""
    return StemFusedEval.apply(x, weight, scale, bias)
