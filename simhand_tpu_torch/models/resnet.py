"""ResNet 18/34/50/101/152 (counterpart of ``simhand_tpu/models/resnet.py``)
with torchvision's state-dict keys and flax's numerics: 'SAME' padding,
exact train-mode BatchNorm with flax momentum 0.9, an explicit compute
``dtype`` with float32 parameters.

The public layout is the JAX package's: images are (N, H, W, C). Inside,
the permuted view is NCHW with channels-last strides.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d


class BasicBlock(nn.Module):
    """ResNet-18/34 block: 3x3 -> 3x3, expansion 1."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, dtype=dtype)
        self.bn2 = BatchNorm2d(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride, dtype=dtype), BatchNorm2d(filters)
            )

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """ResNet-50/101/152 block: 1x1 -> 3x3 -> 1x1, expansion 4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, dtype=dtype)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = Conv2d(filters, cout, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, dtype=dtype), BatchNorm2d(cout)
            )

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """torchvision-layout ResNet with the conv7 stem.

    pool=True returns the float32 (N, C) global-average-pooled embedding;
    pool=False the (N, H/32, W/32, C) feature map.
    """

    def __init__(self, stage_sizes, block, dtype: torch.dtype = torch.float32,
                 pool: bool = True):
        super().__init__()
        self.dtype, self.pool = dtype, pool
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, 64 * 2**stage, stride, dtype))
                cin = 64 * 2**stage * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_features = cin

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)      # NHWC -> NCHW view
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.pool:
            return x.mean(dim=(2, 3)).to(torch.float32)
        return x.permute(0, 2, 3, 1).to(torch.float32)


resnet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
resnet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
resnet50 = partial(ResNet, (3, 4, 6, 3), Bottleneck)
resnet101 = partial(ResNet, (3, 4, 23, 3), Bottleneck)
resnet152 = partial(ResNet, (3, 8, 36, 3), Bottleneck)

RESNETS = {"18": resnet18, "34": resnet34, "50": resnet50, "101": resnet101,
           "152": resnet152}
FEATURE_DIMS = {"18": 512, "34": 512, "50": 2048, "101": 2048, "152": 2048}
