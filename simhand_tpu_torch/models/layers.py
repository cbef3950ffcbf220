"""Convolution, dense and BatchNorm layers with flax's semantics and
PyTorch's state-dict keys.

Each layer takes an explicit compute ``dtype``: it casts its input and its
float32 parameters to it, and the parameters' gradients flow back to
float32. No ``torch.autocast``.

Every train-mode BatchNorm of the port updates its running statistics
through ``update_running_stats``, which does nothing inside
``frozen_running_stats()``: the recomputation of a rematerialised encoder
runs there, so the statistics move once a step, as flax's ``nn.remat``
leaves them.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: (low, high). A stride-2 3x3
    convolution of an even input pads (0, 1), not PyTorch's (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """Convolution, bias-free unless ``bias=True`` (flax's ``use_bias``);
    ``padding=None`` is flax's default 'SAME', an int pads that much on
    every side, ((top, bottom), (left, right)) pads each side as given."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding=None, dtype: torch.dtype = torch.float32,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=0, bias=bias)
        self.explicit_padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if isinstance(self.explicit_padding, int):
            return F.conv2d(x, w, b, stride=self.stride, padding=self.explicit_padding)
        if self.explicit_padding is not None:
            (top, bottom), (left, right) = self.explicit_padding
        else:
            (kh, kw), (sh, sw) = self.kernel_size, self.stride
            top, bottom = same_pads(x.shape[-2], kh, sh)
            left, right = same_pads(x.shape[-1], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, w, b, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=self.stride)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME",
    use_bias=False)``, computing in ``dtype``: the output is twice the
    input's size. flax applies its (kH, kW, I, O) kernel without flipping
    it, so the weight (I, O, kH, kW) holds that kernel with its spatial taps
    reversed."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 4, stride=2, padding=1, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  stride=2, padding=1)


class Linear(nn.Linear):
    """Dense layer computing in ``dtype``."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, on this thread, no BatchNorm updates its running statistics."""
    before = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = before


@torch.no_grad()
def update_running_stats(bn: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """flax's update with momentum m: running = m * running + (1 - m) * batch,
    from the batch mean and biased variance."""
    if getattr(_FROZEN, "on", False):
        return
    m = bn.flax_momentum
    bn.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
    bn.running_var.mul_(m).add_(var, alpha=1.0 - m)


class _FlaxBatchNorm:
    """flax ``nn.BatchNorm`` semantics on PyTorch's BatchNorm modules.

    Training normalises with the batch mean and the biased batch variance,
    reduced in float32, and updates the running statistics with flax
    momentum ``m`` as ``m * running + (1 - m) * batch`` using the biased
    variance (PyTorch's own update uses the unbiased one). Evaluation
    normalises with the running statistics. The output has the input's
    dtype; the parameters stay float32.

    With an ``axis`` (``parallel.mesh``), training takes cross-replica
    statistics as flax's ``nn.BatchNorm(axis_name=...)`` does: the float32
    mean and mean square of this rank's batch are pmean'd (the backward
    goes through the same collective), var = max(E[x^2] - mu^2, 0), and
    y = (x - mu) * (rsqrt(var + eps) * scale) + bias in float32, rounded
    once to the input's dtype. The running statistics take the global ones.
    """

    axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # statistics in float32, or in float64 for a float64 input
        dt = torch.promote_types(x.dtype, torch.float32)
        weight, bias = self.weight.to(dt), self.bias.to(dt)
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(dt), self.running_var.to(dt),
                                weight, bias, False, 0.0, self.eps)
        if self.axis is not None:
            return self._synced(x.to(dt), weight, bias).to(x.dtype)
        # momentum 1.0 makes batch_norm write the batch mean and the
        # unbiased batch variance into these scratch buffers
        mean = torch.zeros_like(self.running_mean, dtype=dt)
        var = torch.zeros_like(self.running_var, dtype=dt)
        y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        update_running_stats(self, mean, var * ((n - 1) / n))
        return y

    def _synced(self, x, weight, bias):
        dims = [d for d in range(x.dim()) if d != 1]
        mu, mu2 = self.axis.pmean(torch.stack([x.mean(dims), (x * x).mean(dims)]))
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        update_running_stats(self, mu.detach(), var.detach())
        shape = (1, -1, *([1] * (x.dim() - 2)))
        mul = torch.rsqrt(var + self.eps) * weight
        return (x - mu.view(shape)) * mul.view(shape) + bias.view(shape)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5, axis=None):
        super().__init__(c, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum, self.axis = momentum, axis


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(c, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum
