"""The fused BatchNorm-training bottleneck path, the counterpart of
``iswm_tpu/models/fused_block.py``.

``fused_bottleneck_apply(block, x)`` computes a whole ResNet ``Bottleneck`` in
training mode through the kernels of ``ops/kernels/fused_block.py``: every
conv emits the statistics of its own output, and the next conv applies that
BatchNorm and the ReLU to its input on the way in, so a normalized activation
is never written to device memory.  What the JAX package leaves to XLA stays
plain torch under autograd here: folding the statistics into ``a * y + b``
(``_finalize_stats``) and the final normalize + residual add + ReLU.

It owns no parameter: it takes the block's own ``conv1/bn1/conv2/bn2/conv3/
bn3/downsample.{0,1}``, so the state-dict keys are those of the unfused block
and checkpoints interchange.  Statistics as ``layers.BatchNorm2d``: float32
sums over the rounded conv output, the fast variance
``max(0, E[y^2] - E[y]^2)``, running statistics
``r = (1 - m) * r + m * batch`` with the biased variance.  Summation order
differs from the unfused modules', so the two agree to rounding, not bit for
bit.

In a process group the statistics are the global batch's, as the JAX
package's under a jit sharded over the data axis: each kernel's sums
``(s, q)`` and this rank's count go through one all-reduce
(``parallel.distributed.group_batch_sums``) before they are folded, and the
backward all-reduces their cotangents before the kernels' VJPs take them, so
every rank normalizes with the same statistics and each rank's data
gradient is that of the global batch.  The weight gradients and the BatchNorm
parameters' gradients stay this rank's share, which the data-parallel
step's gradient reduction (a sum over the ranks) completes, as for
``CrossReplicaBatchNorm``.

Scope, as in the JAX package: training mode, stride 1, dilation 1, groups 1,
base width 64 (``Bottleneck.forward`` checks), and a shape that
``fused_block_eligible`` accepts.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels.fused_block import conv3x3_bn_stats, matmul_bn_stats
from ..parallel.distributed import group_batch_sums
from .remat import recomputing


def _pick_tile_m(m: int, target: int = 2048) -> int:
    """The JAX kernels' row tile: the largest divisor of ``m`` that is
    <= target and a multiple of 16, 0 if there is none.  The CUDA kernels mask
    ragged tiles and need no such divisor; the rule is kept so that one
    configuration takes the same path in both packages."""
    best = 0
    for t in range(16, target + 1, 16):
        if m % t == 0:
            best = t
    return best


def fused_block_eligible(shape) -> bool:
    """Whether an NCHW activation shape takes the fused path: 4-D, B * H * W
    with a row tile, and an image of at least 3 x 3."""
    if len(shape) != 4:
        return False
    b, _, h, w = shape
    return _pick_tile_m(b * h * w) > 0 and h >= 3 and w >= 3


def _finalize_stats(s, q, count: int, bn: nn.BatchNorm2d):
    """(mean, var, a, b) in float32 with ``normalize(y) = a * y + b``, from the
    sums of y and y^2 over ``count`` values per channel (this rank's); in a
    process group the sums and the count are first summed over the ranks."""
    s, q, count = group_batch_sums(s, q, count)
    mean = s / count
    var = torch.clamp_min(q / count - mean * mean, 0.0)
    a = torch.rsqrt(var + bn.eps) * bn.weight.float()
    return mean, var, a, bn.bias.float() - mean * a


def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    if recomputing():  # a rematerialized segment updates them once
        return
    with torch.no_grad():  # flax's update: the biased batch variance
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean.detach(), alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var.detach(), alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)


def _weight_1x1(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv's weight [N, K, 1, 1] as the matmul's [K, N], cast to the
    compute dtype (so its gradient is rounded to it, as in the JAX package)."""
    n, k = conv.weight.shape[:2]
    return conv.weight.reshape(n, k).t().to(dtype)


def fused_bottleneck_apply(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """One ``Bottleneck`` in training mode through the fused kernels.

    ``x`` is NCHW [B, C, H, W] in the compute dtype (on the card in
    ``channels_last`` memory, which is the NHWC the kernels read: no copy);
    the output is NCHW of the same dtype, in NHWC memory.  Updates the
    running statistics of the block's BatchNorms (in a process group with
    the global batch's statistics: four all-reduces forward, four backward).
    """
    bsz, cin, h, w = x.shape
    cdt = x.dtype
    count = bsz * h * w
    planes = block.conv1.out_channels
    x2 = x.permute(0, 2, 3, 1).reshape(count, cin)

    # conv1: 1x1, no prologue (the block's input is already post-ReLU)
    y1, s1, q1 = matmul_bn_stats(x2, _weight_1x1(block.conv1, cdt))
    mean1, var1, a1, b1 = _finalize_stats(s1, q1, count, block.bn1)
    _update_running(block.bn1, mean1, var1)

    # conv2: 3x3, normalize + ReLU prologue; the float32 weight goes in as it is
    y2, s2, q2 = conv3x3_bn_stats(y1.reshape(bsz, h, w, planes), a1, b1,
                                  block.conv2.weight.permute(2, 3, 1, 0))
    mean2, var2, a2, b2 = _finalize_stats(s2, q2, count, block.bn2)
    _update_running(block.bn2, mean2, var2)

    # conv3: 1x1 expand, normalize + ReLU prologue
    y3, s3, q3 = matmul_bn_stats(y2.reshape(count, planes), _weight_1x1(block.conv3, cdt),
                                 a2, b2, prologue=True)
    mean3, var3, a3, b3 = _finalize_stats(s3, q3, count, block.bn3)
    _update_running(block.bn3, mean3, var3)

    # the identity path, with the optional 1x1 projection
    if block.downsample is not None:
        conv_d, bn_d = block.downsample[0], block.downsample[1]
        yd, sd, qd = matmul_bn_stats(x2, _weight_1x1(conv_d, cdt))
        meand, vard, ad, bd = _finalize_stats(sd, qd, count, bn_d)
        _update_running(bn_d, meand, vard)
        identity = yd.float() * ad + bd
    else:
        identity = x2.float()

    # final normalize + residual add + ReLU in float32, then the compute dtype
    out = torch.relu(y3.float() * a3 + b3 + identity).to(cdt)
    return out.reshape(bsz, h, w, planes * block.expansion).permute(0, 3, 1, 2)
