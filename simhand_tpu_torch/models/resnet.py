"""ResNet 18/34/50/101/152 (counterpart of ``simhand_tpu/models/resnet.py``)
with torchvision's state-dict keys and flax's numerics: 'SAME' padding,
exact train-mode BatchNorm with flax momentum 0.9, an explicit compute
``dtype`` with float32 parameters.

The public layout is the JAX package's: images are (N, H, W, C). Inside,
the permuted view is NCHW with channels-last strides.

The BatchNorm variants of the JAX ``ResNet``, with its precedence:
``bn_fused="epilogue"`` (or ``"epilogue_xla"``, the same with the plain
backward) routes every bn+relu and bn+add+relu site through
``bn_epilogue.BNRelu`` and keeps exact BatchNorm at the downsample sites;
it ignores ``bn_subsample`` and ``bn_stop_gradient_stats``, as the
reference does. Otherwise ``bn_subsample > 1`` or
``bn_stop_gradient_stats`` puts ``norm.SubsampledBatchNorm`` at every site.
``maxpool="masked"`` takes the stem pool through ``pool.max_pool_firstmatch``.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from simhand_tpu_torch.models.bn_epilogue import BNRelu
from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d
from simhand_tpu_torch.models.norm import SubsampledBatchNorm
from simhand_tpu_torch.models.pool import max_pool_firstmatch


def bn_relu(bn: nn.Module, y: torch.Tensor, residual: torch.Tensor | None = None):
    """relu(bn(y)) or relu(bn(y) + residual); one fused site for a BNRelu."""
    if isinstance(bn, BNRelu):
        return bn(y, residual)
    y = bn(y)
    return torch.relu(y if residual is None else y + residual)


def norm_layers(bn_fused=False, bn_subsample: int = 1,
                bn_stop_gradient_stats: bool = False):
    """(norm, act_norm): the factories of the plain BatchNorm sites and of
    the bn+relu sites (None: the same as norm)."""
    if bn_fused in ("epilogue", "epilogue_xla"):
        impl = "plain" if bn_fused == "epilogue_xla" else "kernel"
        return BatchNorm2d, partial(BNRelu, impl=impl)
    if bn_fused in (True, "pallas"):
        raise NotImplementedError(
            f"bn_fused={bn_fused!r} (models/fused_bn.py, kernel "
            "bn_backward_reduces) is not ported yet: ROADMAP Queue 2 #9")
    if bn_fused not in (False,):
        raise ValueError(f"bn_fused={bn_fused!r}: expected False, True, 'pallas', "
                         "'epilogue' or 'epilogue_xla'")
    if bn_subsample < 1:
        raise ValueError(f"bn_subsample must be >= 1, got {bn_subsample}")
    if bn_subsample > 1 or bn_stop_gradient_stats:
        return partial(SubsampledBatchNorm, subsample=bn_subsample,
                       stop_gradient_stats=bn_stop_gradient_stats), None
    return BatchNorm2d, None


class BasicBlock(nn.Module):
    """ResNet-18/34 block: 3x3 -> 3x3, expansion 1."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 norm=BatchNorm2d, act_norm=None):
        super().__init__()
        act_norm = act_norm or norm
        self.conv1 = Conv2d(cin, filters, 3, stride, dtype=dtype)
        self.bn1 = act_norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, dtype=dtype)
        self.bn2 = act_norm(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride, dtype=dtype), norm(filters)
            )

    def forward(self, x):
        y = bn_relu(self.bn1, self.conv1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return bn_relu(self.bn2, self.conv2(y), residual)


class Bottleneck(nn.Module):
    """ResNet-50/101/152 block: 1x1 -> 3x3 -> 1x1, expansion 4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 norm=BatchNorm2d, act_norm=None):
        super().__init__()
        act_norm = act_norm or norm
        cout = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1, dtype=dtype)
        self.bn1 = act_norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, dtype=dtype)
        self.bn2 = act_norm(filters)
        self.conv3 = Conv2d(filters, cout, 1, dtype=dtype)
        self.bn3 = act_norm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, dtype=dtype), norm(cout)
            )

    def forward(self, x):
        y = bn_relu(self.bn1, self.conv1(x))
        y = bn_relu(self.bn2, self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return bn_relu(self.bn3, self.conv3(y), residual)


class ResNet(nn.Module):
    """torchvision-layout ResNet with the conv7 stem.

    pool=True returns the float32 (N, C) global-average-pooled embedding;
    pool=False the (N, H/32, W/32, C) feature map. ``bn_fused``,
    ``bn_subsample``, ``bn_stop_gradient_stats`` and ``maxpool`` ("xla" or
    "masked") are the JAX ``ResNet``'s fields of the same names.
    """

    def __init__(self, stage_sizes, block, dtype: torch.dtype = torch.float32,
                 pool: bool = True, bn_fused=False, bn_subsample: int = 1,
                 bn_stop_gradient_stats: bool = False, maxpool: str = "xla"):
        super().__init__()
        if maxpool not in ("xla", "masked"):
            raise ValueError(f"maxpool must be 'xla' or 'masked', got {maxpool!r}")
        norm, act_norm = norm_layers(bn_fused, bn_subsample, bn_stop_gradient_stats)
        self.dtype, self.pool, self.maxpool = dtype, pool, maxpool
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn1 = (act_norm or norm)(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, 64 * 2**stage, stride, dtype, norm, act_norm))
                cin = 64 * 2**stage * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_features = cin

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)      # NHWC -> NCHW view
        x = bn_relu(self.bn1, self.conv1(x))
        if self.maxpool == "masked":
            x = max_pool_firstmatch(x)
        else:
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
