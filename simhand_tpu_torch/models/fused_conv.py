"""The fused 1x1-conv + BatchNorm site of a bottleneck in train mode
(counterpart of ``simhand_tpu/models/fused_conv.py:43-102, :146-207``).

The forward runs kernel #10 (``ops/conv1x1.conv1x1_stats``): y = x @ w.T in
the compute dtype with the column sums of y and y^2 in its epilogue, so the
statistics need no second read of y. Then mu = s1/M, var = s2/M - mu^2
(biased, flax's), and the affine in float32 rounded once:
``o = (y * a32 + b32).to(dtype)``.

The backward is the reference's ``_fused_bwd`` (:75-99) in plain PyTorch:
xhat recomputed from the saved y, the two reductions, the BatchNorm dx
rounded to the compute dtype, and the two products of a 1x1 convolution's
backward, ``dx = dy @ w`` and ``dw = dy.T @ x``, with ``torch.matmul`` (the
reference leaves both to ``jnp.dot`` outside its kernel).

With a BatchNorm axis the site is the reference's
``_conv1x1_bn_train_synced`` (:150-267): the forward takes the psum of
#10's per-channel (sum, sum of squares) and of the row count, so the
statistics are global; the backward takes the psum of its two reductions
for dy, and returns this rank's own sums as the scale's and bias's
gradients, as autodiff of flax's synced BatchNorm does.
"""
from __future__ import annotations

import torch

from simhand_tpu_torch.models.bn_epilogue import as_rows
from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d, update_running_stats
from simhand_tpu_torch.ops.conv1x1 import conv1x1_stats


class Conv1x1BNTrain(torch.autograd.Function):
    """(o, mu, var) of BN(x2d @ w.T) with batch statistics; w is (Cout, Cin).
    mu and var feed the running statistics and take no gradient. With an
    axis, the statistics and the backward's reductions are global."""

    @staticmethod
    def forward(ctx, x2d, w, scale, bias, eps, axis=None):
        y, s1, s2 = conv1x1_stats(x2d, w)
        m = x2d.shape[0]
        if axis is not None:
            m *= axis.size
            s1, s2 = axis.reduce_raw(torch.stack([s1, s2]), "sum")
        mu = s1 / m
        var = s2 / m - mu * mu
        inv = torch.rsqrt(var + eps)
        a32 = inv * scale.float()
        b32 = bias.float() - mu * a32
        ctx.save_for_backward(x2d, w, y, mu, inv, scale)
        ctx.axis, ctx.m = axis, m
        ctx.mark_non_differentiable(mu, var)
        return (y.float() * a32 + b32).to(y.dtype), mu, var

    @staticmethod
    def backward(ctx, do, _dmu, _dvar):
        x2d, w, y, mu, inv, scale = ctx.saved_tensors
        m = ctx.m
        do32 = do.float()
        xhat = (y.float() - mu) * inv
        local_sum_do = do32.sum(0)
        local_sum_do_xhat = (do32 * xhat).sum(0)
        sum_do, sum_do_xhat = local_sum_do, local_sum_do_xhat
        if ctx.axis is not None:
            sum_do, sum_do_xhat = ctx.axis.reduce_raw(
                torch.stack([local_sum_do, local_sum_do_xhat]), "sum")
        a = scale.float() * inv
        dy = (a * (do32 - sum_do / m - xhat * (sum_do_xhat / m))).to(y.dtype)
        return (dy @ w, dy.T @ x2d, local_sum_do_xhat.to(scale.dtype),
                local_sum_do.to(scale.dtype), None, None)


def conv1x1_bn_train(x2d, w, scale, bias, eps: float, axis=None):
    """(o, mu, var): o = BN(x2d @ w.T) in train mode, float32 statistics
    (global over ``axis`` when one is given)."""
    return Conv1x1BNTrain.apply(x2d, w, scale, bias, eps, axis)


def fused_conv_bn_site(conv: Conv2d, bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """bn(conv(x)) in train mode through :func:`conv1x1_bn_train`, for a
    bias-free stride-1 1x1 ``conv`` and an exact ``bn`` (whose running
    statistics it updates with the kernel's mu and var, flax momentum; its
    axis, if it has one, makes the statistics global).

    The modules stay the block's own, so the state-dict keys, the decay mask
    and the conversion from the reference are those of the plain site. x is
    NCHW with channels-last strides; so is the result.
    """
    n, _, h, w_ = x.shape
    x2d = as_rows(x.to(conv.dtype))
    w = conv.weight.to(conv.dtype).view(conv.out_channels, -1)
    o, mu, var = conv1x1_bn_train(x2d, w, bn.weight, bn.bias, bn.eps, bn.axis)
    update_running_stats(bn, mu, var)
    return o.view(n, h, w_, -1).permute(0, 3, 1, 2)
