"""SimCLR projection head (counterpart of ``simhand_tpu/models/projection.py``):
Linear -> BatchNorm -> ReLU -> Linear without bias, float32 output. Its
BatchNorm is per-replica unless ``ContrastiveModel.sync_batch_norms`` gives
it an axis (the FSDP step's global batch)."""
from __future__ import annotations

import torch
from torch import nn

from simhand_tpu_torch.models.layers import BatchNorm1d, Linear


class ProjectionHead(nn.Module):
    def __init__(self, input_dim: int = 2048, hidden_dim: int = 512,
                 output_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(input_dim, hidden_dim, dtype=dtype)
        self.bn1 = BatchNorm1d(hidden_dim)
        self.fc2 = Linear(hidden_dim, output_dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.fc1(x)))
        return self.fc2(x).to(torch.float32)
