"""Max-pool whose backward routes each window's gradient to the first
maximal element in row-major window order (counterpart of
``simhand_tpu/models/pool.py``).

The forward is ``F.max_pool2d`` over the input padded with -inf. The
backward recomputes the mask from strided slices of the padded input, one
window tap at a time, and accumulates the gradient in float32 before one
rounding to the input's dtype. Under ties, common after a ReLU where exact
zeros repeat, the first tap of the window takes the gradient.

Tensors are NCHW (any strides), as ``F.max_pool2d`` takes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Window = tuple[int, int]
Padding = tuple[tuple[int, int], tuple[int, int]]


def _padded(x: torch.Tensor, padding: Padding) -> torch.Tensor:
    (ph0, ph1), (pw0, pw1) = padding
    return F.pad(x, (pw0, pw1, ph0, ph1), value=float("-inf"))


class _MaxPoolFirstMatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        y = F.max_pool2d(_padded(x, padding), window, strides)
        ctx.save_for_backward(x, y)
        ctx.window, ctx.strides, ctx.padding = window, strides, padding
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (wh, ww), (sh, sw) = ctx.window, ctx.strides
        (ph0, _), (pw0, _) = ctx.padding
        h, w = x.shape[2:]
        oh, ow = y.shape[2:]
        # -inf padding never claims a window: each holds a real element
        xp = _padded(x, ctx.padding)
        dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
        claimed = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
        g32 = g.float()
        for a in range(wh):
            for b in range(ww):
                rows = slice(a, a + sh * (oh - 1) + 1, sh)
                cols = slice(b, b + sw * (ow - 1) + 1, sw)
                m = (xp[:, :, rows, cols] == y) & ~claimed
                claimed |= m
                dxp[:, :, rows, cols] += torch.where(m, g32, 0.0)
        dx = dxp[:, :, ph0:ph0 + h, pw0:pw0 + w].to(x.dtype)
        return dx, None, None, None


def max_pool_firstmatch(x: torch.Tensor, window: Window = (3, 3),
                        strides: Window = (2, 2),
                        padding: Padding = ((1, 1), (1, 1))) -> torch.Tensor:
    """NCHW max-pool with the first-match masked backward."""
    return _MaxPoolFirstMatch.apply(x, tuple(window), tuple(strides),
                                    tuple(map(tuple, padding)))
