"""BatchNorm with statistics from a leading subset of the batch, and the
stop-gradient BatchNorm (counterpart of ``simhand_tpu/models/norm.py``).

``subsample=k`` takes the forward statistics from the first N // k images
(at least one); the batch is shuffled, so they are a uniform subset. A
negative ``k`` takes the whole batch and ``k = 0`` raises
``ZeroDivisionError`` in train mode, as the reference does.
``stop_gradient_stats`` keeps gradients out of the mean and variance
(``--bn_variant stop_grad`` of the JAX CLI). Statistics are float32 with
the variance clamped at 0; the statistics and the affine are folded into
one per-channel multiply-add applied in the input's dtype. With an
``axis`` (``parallel.mesh``) the subset's mean and mean square are
pmean'd over the ranks before the variance is formed.
"""
from __future__ import annotations

import torch

from simhand_tpu_torch.models.layers import BatchNorm2d, update_running_stats


class SubsampledBatchNorm(BatchNorm2d):
    """A BatchNorm2d (same keys, weight-decay mask and initialisation) with
    subset statistics and optionally stopped gradients through them."""

    def __init__(self, c: int, subsample: int = 4, stop_gradient_stats: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5, axis=None):
        super().__init__(c, momentum, eps, axis)
        self.subsample, self.stop_gradient_stats = subsample, stop_gradient_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # as the reference: a subsample < 1 takes the whole batch, and 0
            # raises ZeroDivisionError here
            n_sub = max(x.shape[0] // self.subsample, 1)
            sub = x[:n_sub] if self.subsample > 1 else x
            sub32 = sub.float()
            dims = [d for d in range(x.dim()) if d != 1]
            mean, mean2 = sub32.mean(dims), (sub32 * sub32).mean(dims)
            if self.axis is not None:
                mean, mean2 = self.axis.pmean(torch.stack([mean, mean2]))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            update_running_stats(self, mean, var)
            if self.stop_gradient_stats:
                mean, var = mean.detach(), var.detach()
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        scale = self.weight.float()
        a = (inv * scale).to(x.dtype)
        b = (self.bias.float() - mean * inv * scale).to(x.dtype)
        shape = (1, -1, *([1] * (x.dim() - 2)))
        return x * a.view(shape) + b.view(shape)
