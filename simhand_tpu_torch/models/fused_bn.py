"""BatchNorm with a hand-derived backward (counterpart of
``simhand_tpu/models/fused_bn.py``).

The forward is plain PyTorch with flax numerics: one-pass float32
statistics (``var = E[x^2] - mu^2``, ``bn_epilogue.batch_stats``) and the
affine ``y = x*A + B`` with A and B rounded to the compute dtype
(``bn_epilogue.bn_affine``). No ReLU. The backward needs two reductions
over the activation, which are also the parameter gradients:

  sum_dy = sum(dy),  sum_dy_xhat = sum(dy * xhat),  xhat = (x - mu) * inv

and one elementwise pass, ``dx = a (dy - sum_dy/M - xhat sum_dy_xhat/M)``
with ``a = scale * inv`` (with ``stop_gradient_stats``, ``dx = a dy``).
``reduce_impl="kernel"`` (the reference's ``"pallas"``) takes the two
reductions through ``bn_backward_reduces``, kernel #9 of
``csrc/bn_epilogue.cu``; ``"plain"`` (the reference's ``"xla"``) through
its plain version on any device. ``dx`` is plain PyTorch, as the reference
computes it outside its kernel.

``bn_backward_reduces`` takes its plain version's tensors with the channel
on dim 1: (M, C) planes or NCHW activations with channels-last strides. On
CPU tensors it calls the plain version; on CUDA tensors it launches the
kernel on the current stream or raises, and adds one to its ``launches``
count at each launch and nowhere else.
"""
from __future__ import annotations

import torch

from simhand_tpu_torch.device import on_cpu
from simhand_tpu_torch.models import bn_epilogue as E
from simhand_tpu_torch.models.layers import BatchNorm2d, update_running_stats


def bn_backward_reduces_plain(x2d, dy2d, mu, inv):
    """(sum dy, sum dy*xhat) over the rows of (M, C) planes, float32, with
    xhat = (x - mu) * inv in the reference's order (fused_bn.py:69, :167)."""
    dy = dy2d.float()
    xhat = (x2d.float() - mu) * inv
    return dy.sum(0), (dy * xhat).sum(0)


def _launch(x, dy, mu, inv):
    x2d = E._plane(x, "x")
    out = E._reduce("dual_reduce", [E._gradient_plane(dy, x), x2d], dict(mu=mu, inv=inv))
    return out[0], out[1]


def bn_backward_reduces(x, dy, mu, inv):
    """(sum dy, sum dy*xhat) per channel, float32; xhat = (x - mu) * inv."""
    if on_cpu(x, dy, mu, inv):
        return bn_backward_reduces_plain(E.as_rows(x), E.as_rows(dy), mu, inv)
    out = _launch(x, dy, mu, inv)
    bn_backward_reduces.launches += 1
    return out


KERNELS = (bn_backward_reduces,)
bn_backward_reduces.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


class BNTrain(torch.autograd.Function):
    """bn(x) in train mode with the hand-derived backward (fused_bn.py:32-88);
    returns (y, mu, var). reduce_impl="kernel" takes the backward's two
    reductions through the kernel wrapper, "plain" through the plain version
    on any device."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, stop_gradient_stats, reduce_impl):
        mu, var, inv = E.batch_stats(x, eps)
        ctx.save_for_backward(x, mu, inv, scale)
        ctx.stop_gradient_stats, ctx.reduce_impl = stop_gradient_stats, reduce_impl
        ctx.mark_non_differentiable(mu, var)
        return E.bn_affine(x, mu, inv, scale, bias), mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        x, mu, inv, scale = ctx.saved_tensors
        # one (M, C) plane of each: a view of the channels-last activation;
        # the gradient is copied once if autograd hands it in another layout
        x2d, g2d = E.as_rows(x), E.as_rows(g)
        m = x2d.shape[0]
        if ctx.reduce_impl == "kernel":
            sum_dy, sum_dyx = bn_backward_reduces(x2d, g2d, mu, inv)
        else:
            sum_dy, sum_dyx = bn_backward_reduces_plain(x2d, g2d, mu, inv)
        a = scale.float() * inv
        g32 = g2d.float()
        if ctx.stop_gradient_stats:
            # the statistics are constants: dx is a scaled dy (fused_bn.py:73-76)
            dx = a * g32
        else:
            xhat = (x2d.float() - mu) * inv
            dx = a * (g32 - sum_dy / m - xhat * (sum_dyx / m))
        return (E.from_rows(dx.to(x.dtype), x), sum_dyx.to(scale.dtype),
                sum_dy.to(scale.dtype), None, None, None)


class FusedBatchNorm(BatchNorm2d):
    """BatchNorm with flax numerics and the hand-derived backward
    (``bn_fused=True``: ``reduce_impl="plain"``; ``bn_fused="pallas"``:
    ``reduce_impl="kernel"``), optionally with the statistics' gradients
    stopped.

    A BatchNorm2d, so its state-dict keys, the weight-decay mask and the
    initialisation are those of the exact BatchNorm. Train mode updates the
    running statistics with flax momentum and the biased variance; eval mode
    applies them with the same two-rounding affine. The output has the
    input's dtype; statistics are float32.
    """

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5,
                 stop_gradient_stats: bool = False, reduce_impl: str = "kernel", axis=None):
        if axis is not None:
            # as the reference asserts (fused_bn.py:114)
            raise NotImplementedError(
                "FusedBatchNorm is per-replica only: it has no cross-replica statistics; "
                "use the exact BatchNorm (bn_fused=False) with a BatchNorm axis")
        super().__init__(c, momentum, eps)
        if reduce_impl not in ("kernel", "plain"):
            raise ValueError(f"reduce_impl must be 'kernel' or 'plain', got {reduce_impl!r}")
        self.stop_gradient_stats, self.reduce_impl = stop_gradient_stats, reduce_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return E.bn_affine(x, self.running_mean, inv, self.weight, self.bias)
        y, mu, var = BNTrain.apply(x, self.weight, self.bias, self.eps,
                                   self.stop_gradient_stats, self.reduce_impl)
        update_running_stats(self, mu, var)
        return y
