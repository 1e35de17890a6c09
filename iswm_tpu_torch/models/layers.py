"""Shared building blocks, the counterpart of ``iswm_tpu/models/layers.py``.

NCHW activations and OIHW weights, as PyTorch keeps them.  Parameters are
float32; the compute dtype is the dtype of the activations, and every conv
casts its weight to it, as the JAX modules cast their kernels to ``dtype``.
The TPU lowering rewrites of the JAX package (``PackedStrided2Conv``,
``ShiftedDilatedConv``, ``ConcatConvBN``, ``BlockDiagConv``) compute the
same math as a plain conv, so here each of them is one ``Conv2d``.
``max_pool_torch`` is ``nn.MaxPool2d(3, 2, 1)`` and ``global_avg_pool`` is
``nn.AdaptiveAvgPool2d(1)``.  ``FusedStemPool`` runs the stem's conv, BatchNorm,
ReLU and max-pool through the fused stem kernels (``ops/kernels/fused_stem``).
In a process group, train-mode ``BatchNorm2d`` takes its statistics over every
rank's rows (``CrossReplicaBatchNorm``), as the JAX package's does under a
jit sharded over the data axis.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.distributed import is_initialized

# all-reduces launched by the cross-replica BatchNorm, forward and backward
cross_replica_all_reduces = 0


def torch_conv_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric per-side padding torch uses: (k//2)*d for odd k."""
    return (kernel_size // 2) * dilation


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the dtype of its input: the weight (and
    bias) are cast to it, which is a no-op once they are stored in it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in float32 on an activation of any dtype, with the
    output in the activation's dtype: flax ``nn.BatchNorm`` with
    ``dtype=bf16`` and float32 statistics.

    In train mode it normalizes with the batch statistics over (N, H, W)
    and updates the running ones as flax does, ``r = (1 - m) * r + m * batch``
    with the BIASED batch variance (``nn.BatchNorm2d`` would take the
    unbiased one).  ``momentum`` is torch's (``1 -`` flax's) and is set,
    with ``eps``, from ``ModelConfig`` by ``build_model``.  One value per
    channel (the ASPP pooling branch at batch 1) gives variance 0 and the
    output ``bias``, as in flax, where ``nn.BatchNorm2d`` raises.

    In a process group (of any size) train mode goes through
    ``CrossReplicaBatchNorm``: the statistics of the global batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias,
                                False, 0.0, self.eps)
        if is_initialized():
            out, mean, var = CrossReplicaBatchNorm.apply(x, weight, bias, self.eps)
            self._update_running(mean, var)
            return out
        n = x.numel() // x.shape[1]
        if n == 1:
            xf = x.float()  # x - mean is exactly 0: output = bias, zero grads
            mean, var = xf.detach().reshape(-1), torch.zeros_like(self.running_var)
            out = (xf - xf.mean(dim=(0, 2, 3), keepdim=True)) * (
                weight * self.eps ** -0.5
            ).reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
            out = out.to(x.dtype)
        else:
            # the batch mean and (unbiased) variance land in these with
            # momentum 1; the output uses the biased one, as flax's does
            mean = torch.zeros_like(self.running_mean)
            var = torch.zeros_like(self.running_var)
            out = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
            var = var * ((n - 1) / n)
        self._update_running(mean, var)
        return out

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    global cross_replica_all_reduces
    cross_replica_all_reduces += 1
    torch.distributed.all_reduce(t)
    return t


class CrossReplicaBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank of the default group,
    flax's arithmetic on the global batch: one float32 all-reduce of
    ``(sum x, sum x^2, n)`` per channel, ``mean = sum x / n``, the fast
    variance ``max(sum x^2 / n - mean^2, 0)`` (biased, into the running
    statistics too), ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``.
    One value per channel in the whole group gives variance 0 and ``y = bias``.

    The backward all-reduces ``(sum dy, sum dy * xhat)`` and forms ``dx`` from
    the global sums; the gradients of ``weight`` and ``bias`` are this rank's
    share, which the gradient reduction (a sum over ranks) completes.  Returns
    (y in x's dtype, mean, var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        dims = (0, 2, 3)
        local_n = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32,
                             device=x.device)
        sums = _all_reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims), local_n]))
        c = x.shape[1]
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
        sigma_inv = torch.rsqrt(var + eps)
        per_channel = (1, c, 1, 1)
        out = ((xf - mean.reshape(per_channel)) * (sigma_inv * weight).reshape(per_channel)
               + bias.reshape(per_channel))
        ctx.save_for_backward(x, weight, mean, sigma_inv, n)
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, sigma_inv, n = ctx.saved_tensors
        dims, per_channel = (0, 2, 3), (1, x.shape[1], 1, 1)
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(per_channel)) * sigma_inv.reshape(per_channel)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dweight = local.chunk(2)
        total = _all_reduce(local.clone())
        sum_dy, sum_dy_xhat = (t.reshape(per_channel) / n for t in total.chunk(2))
        dx = ((weight * sigma_inv).reshape(per_channel)
              * (dyf - sum_dy - xhat * sum_dy_xhat))
        return dx.to(x.dtype), dweight, dbias, None


def conv(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
         dilation: int = 1, groups: int = 1, bias: bool = False) -> Conv2d:
    """Conv2d with torch geometry (padding (k//2)*d)."""
    return Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                  padding=torch_conv_padding(kernel_size, dilation),
                  dilation=dilation, groups=groups, bias=bias)


class ConvBN(nn.Sequential):
    """Conv2d(bias=False) + BatchNorm + optional ReLU, as children ``0``,
    ``1`` (and ``2``) — the reference's ``nn.Sequential`` key layout."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, groups: int = 1,
                 use_relu: bool = True, bn_epsilon: float = 1e-5):
        layers = [conv(in_ch, features, kernel_size, strides, dilation, groups),
                  BatchNorm2d(features, eps=bn_epsilon)]
        if use_relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


class FusedStemPool(nn.Module):
    """The stem's conv + BatchNorm + ReLU + ``MaxPool2d(3, 2, 1)`` with the
    chain after the conv fused (``ops/kernels/fused_stem.py``): statistics and
    normalize + ReLU + pool forward, and a backward that recomputes the pool's
    argmax and contracts dz straight into the conv's weight gradient.

    It owns no parameter: ``forward`` takes the stem's own ``Conv2d`` and
    ``BatchNorm2d``, so the state-dict keys are those of the unfused stem and
    checkpoints interchange.  Pool-gradient ties are EQUAL-SPLIT and the image
    gets no gradient (see the kernel module's docstring); the eval-mode forward
    cannot be differentiated at all (its backward raises)."""

    def forward(self, x: torch.Tensor, conv1: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
        from ..ops.kernels.fused_stem import stem_fused_eval, stem_fused_train

        if (conv1.kernel_size, conv1.stride, conv1.padding) != ((7, 7), (2, 2), (3, 3)):
            raise ValueError("FusedStemPool is specialized to the 7x7 / stride 2 / pad 3 stem")
        if bn.training:
            p, mean, var = stem_fused_train(x, conv1.weight, bn.weight, bn.bias, bn.eps)
            with torch.no_grad():  # flax's update: the biased batch variance
                bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
                bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
                bn.num_batches_tracked.add_(1)
            return p
        sigma_inv = torch.rsqrt(bn.running_var.float() + bn.eps)
        scale = bn.weight.float() * sigma_inv
        bias = bn.bias.float() - bn.running_mean.float() * scale
        return stem_fused_eval(x, conv1.weight, scale, bias)


def fused_stem_eligible(x_shape, kernel_size: int = 7) -> bool:
    """The fused stem is specialized to the 7x7 / stride 2 stem and needs a
    square NCHW input whose side is divisible by 4 (a conv output that the pool
    halves) and at least 8."""
    h, w = x_shape[2], x_shape[3]
    return kernel_size == 7 and h % 4 == 0 and w % 4 == 0 and h == w and h >= 8


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init as the JAX package's: kaiming-normal (fan-in, gain 2)
    conv weights, zero conv biases, BatchNorm at identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
