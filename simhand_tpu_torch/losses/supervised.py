"""The median used by the projection statistics (counterpart of
``simhand_tpu/losses/supervised.py:56-65``)."""
from __future__ import annotations

import torch


def torch_median(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """The lower of the two middle order statistics for even counts (sorted
    index ``(n-1)//2``), where an interpolating median would average them."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    return torch.sort(x, dim=dim).values.select(dim, (n - 1) // 2)
