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
reference does. ``bn_fused=True`` or ``"xla"`` (or ``"pallas"``, with
kernel #9 in the backward) puts ``fused_bn.FusedBatchNorm`` at every site,
downsample included; it passes ``bn_stop_gradient_stats`` on and ignores
``bn_subsample``. Otherwise ``bn_subsample > 1`` or
``bn_stop_gradient_stats`` puts ``norm.SubsampledBatchNorm`` at every site;
``bn_subsample < 1`` is exact BatchNorm, as the reference's ``> 1`` test
makes it.
``conv1x1_fuse_min_cin > 0`` takes each bottleneck's conv1 and conv3 with
at least that many input channels through ``fused_conv.fused_conv_bn_site``
(kernel #10) in train mode; it composes only with exact BatchNorm.
``maxpool="masked"`` takes the stem pool through ``pool.max_pool_firstmatch``.

``bn_axis`` (a ``parallel.mesh`` axis) gives every BatchNorm site of the
encoder cross-replica statistics in train mode: the exact BatchNorm, the
subsampled one and the fused conv1x1+BN site. ``FusedBatchNorm`` and the
epilogue refuse it, as the reference does (``fused_bn.py:114``,
``resnet.py:173-183``): that is the data-parallel route. The FSDP step's
global batch reaches every site, the fused ones too, through
``ContrastiveModel.sync_batch_norms``.

``stem="space_to_depth"`` is the reference's MLPerf stem: the images
rearranged by ``space_to_depth(x, 2)``, then ``conv1_s2d``, a 4x4 stride-1
convolution padded (2, 1) on each side over the 12-channel tensor, the same
linear map as the conv7 stem with ``s2d_stem_kernel``'s weights.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from simhand_tpu_torch.models.bn_epilogue import BNRelu
from simhand_tpu_torch.models.fused_bn import FusedBatchNorm
from simhand_tpu_torch.models.fused_conv import fused_conv_bn_site
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
                bn_stop_gradient_stats: bool = False, bn_axis=None):
    """(norm, act_norm): the factories of the plain BatchNorm sites and of
    the bn+relu sites (None: the same as norm)."""
    if bn_fused in ("epilogue", "epilogue_xla"):
        if bn_axis is not None:
            raise NotImplementedError(
                f"bn_fused={bn_fused!r} has no cross-replica statistics: its BNRelu sites "
                "would take per-replica statistics while the downsample BatchNorms sync "
                "over the axis. Use the exact BatchNorm with bn_axis")
        impl = "plain" if bn_fused == "epilogue_xla" else "kernel"
        return BatchNorm2d, partial(BNRelu, impl=impl)
    if bn_fused in (True, "xla", "pallas"):
        return partial(FusedBatchNorm, stop_gradient_stats=bn_stop_gradient_stats,
                       reduce_impl="kernel" if bn_fused == "pallas" else "plain",
                       axis=bn_axis), None
    if bn_fused not in (False,):
        raise ValueError(f"bn_fused={bn_fused!r}: expected False, True, 'xla', 'pallas', "
                         "'epilogue' or 'epilogue_xla'")
    # bn_subsample < 1 takes the reference's branches too: exact BatchNorm,
    # or with stopped gradients SubsampledBatchNorm over the whole batch
    if bn_subsample > 1 or bn_stop_gradient_stats:
        return partial(SubsampledBatchNorm, subsample=bn_subsample,
                       stop_gradient_stats=bn_stop_gradient_stats, axis=bn_axis), None
    return partial(BatchNorm2d, axis=bn_axis), None


class BasicBlock(nn.Module):
    """ResNet-18/34 block: 3x3 -> 3x3, expansion 1."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 norm=BatchNorm2d, act_norm=None, fuse_min_cin: int = 0):
        # fuse_min_cin: taken for uniformity with Bottleneck; a basic block
        # has no stride-1 1x1 site
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
                 norm=BatchNorm2d, act_norm=None, fuse_min_cin: int = 0):
        super().__init__()
        act_norm = act_norm or norm
        self.fuse_min_cin = fuse_min_cin
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

    def _conv_bn_relu(self, conv, bn, x, residual=None):
        """relu(bn(conv(x)) (+ residual)) of a 1x1 site: in train mode
        through the fused conv1x1+BN site when x has at least fuse_min_cin
        channels (the reference's _conv_bn_site, resnet.py:75-81)."""
        if self.fuse_min_cin and self.training and x.shape[1] >= self.fuse_min_cin:
            y = fused_conv_bn_site(conv, bn, x)
            return torch.relu(y if residual is None else y + residual)
        return bn_relu(bn, conv(x), residual)

    def forward(self, x):
        y = self._conv_bn_relu(self.conv1, self.bn1, x)
        y = bn_relu(self.bn2, self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self._conv_bn_relu(self.conv3, self.bn3, y, residual)


class ResNet(nn.Module):
    """torchvision-layout ResNet.

    pool=True returns the float32 (N, C) global-average-pooled embedding;
    pool=False the (N, H/32, W/32, C) feature map. ``bn_axis`` is the JAX
    ``ResNet``'s ``bn_axis_name``; ``stem`` ("conv7" or "space_to_depth"),
    ``bn_fused``, ``bn_subsample``, ``bn_stop_gradient_stats``,
    ``conv1x1_fuse_min_cin`` and ``maxpool`` ("xla" or "masked") are its
    fields of the same names.
    """

    def __init__(self, stage_sizes, block, dtype: torch.dtype = torch.float32,
                 pool: bool = True, bn_axis=None, stem: str = "conv7", bn_fused=False,
                 bn_subsample: int = 1, bn_stop_gradient_stats: bool = False,
                 conv1x1_fuse_min_cin: int = 0, maxpool: str = "xla"):
        super().__init__()
        if maxpool not in ("xla", "masked"):
            raise ValueError(f"maxpool must be 'xla' or 'masked', got {maxpool!r}")
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"stem must be 'conv7' or 'space_to_depth', got {stem!r}")
        norm, act_norm = norm_layers(bn_fused, bn_subsample, bn_stop_gradient_stats, bn_axis)
        self.dtype, self.pool, self.maxpool, self.stem = dtype, pool, maxpool, stem
        self.conv1x1_fuse_min_cin = conv1x1_fuse_min_cin
        # the fused conv1x1+BN site owns the whole site with exact BatchNorm;
        # the reference refuses the other variants in train mode (resnet.py:262-269)
        self._fuse_conflict = bool(bn_fused) or bn_subsample > 1 or bn_stop_gradient_stats
        if stem == "space_to_depth":
            self.conv1_s2d = Conv2d(12, 64, 4, 1, padding=((2, 1), (2, 1)), dtype=dtype)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, padding=3, dtype=dtype)
        self.bn1 = (act_norm or norm)(64)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, 64 * 2**stage, stride, dtype, norm, act_norm,
                                    conv1x1_fuse_min_cin))
                cin = 64 * 2**stage * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_features = cin

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.conv1x1_fuse_min_cin and self.training and self._fuse_conflict:
            raise NotImplementedError(
                "conv1x1_fuse_min_cin composes only with exact BatchNorm (it owns the "
                "whole conv+BN site); disable the bn_fused/bn_subsample/stop-gradient "
                "variants")
        x = images.to(self.dtype)
        if self.stem == "space_to_depth":
            x = self.conv1_s2d(space_to_depth(x, 2).permute(0, 3, 1, 2))
        else:
            x = self.conv1(x.permute(0, 3, 1, 2))          # NHWC -> NCHW view
        x = bn_relu(self.bn1, x)
        if self.maxpool == "masked":
            x = max_pool_firstmatch(x)
        else:
            x = nn.functional.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.pool:
            return x.mean(dim=(2, 3)).to(torch.float32)
        return x.permute(0, 2, 3, 1).to(torch.float32)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channels ordered (py, px, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, block * block * c)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """A conv7 stride-2 stem weight (O, C, 7, 7) as the equivalent weight
    (O, 4C, 4, 4) of the space-to-depth stem (the reference's
    ``s2d_stem_kernel``, in PyTorch's layout): output(y, x) sums
    W[dy, dx] I[2y + dy - 3, 2x + dx - 3], and dy - 3 = 2a + py (py in
    {0, 1}) puts each 7x7 tap at 4x4 tap (a + 2, b + 2) of s2d channel
    (py, px, c). The taps no 7x7 tap reaches stay zero."""
    o, c = w7.shape[0], w7.shape[1]
    w2 = w7.new_zeros((o, 4, 4, 2, 2, c))
    for dy in range(7):
        a, py = divmod(dy + 1, 2)
        for dx in range(7):
            b, px = divmod(dx + 1, 2)
            w2[:, a, b, py, px] = w7[:, :, dy, dx]
    return w2.permute(0, 3, 4, 5, 1, 2).reshape(o, 4 * c, 4, 4)


resnet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
resnet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
resnet50 = partial(ResNet, (3, 4, 6, 3), Bottleneck)
resnet101 = partial(ResNet, (3, 4, 23, 3), Bottleneck)
resnet152 = partial(ResNet, (3, 8, 36, 3), Bottleneck)

RESNETS = {"18": resnet18, "34": resnet34, "50": resnet50, "101": resnet101,
           "152": resnet152}
FEATURE_DIMS = {"18": 512, "34": 512, "50": 2048, "101": 2048, "152": 2048}
