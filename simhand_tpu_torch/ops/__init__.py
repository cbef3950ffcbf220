# ``bottleneck_block`` stays the module's name here (``from simhand_tpu_torch.ops
# import bottleneck_block`` is the module, as ``conv1x1`` is); its wrapper of
# the same name lives in it.
from simhand_tpu_torch.ops.bottleneck_block import (
    FoldedBf16Ops,
    fold_block_weights,
    make_folded_encoder_bf16,
)
from simhand_tpu_torch.ops.conv1x1 import conv1x1_bn_relu_stats, conv1x1_stats
from simhand_tpu_torch.ops.conv_bias import conv_bias_act

__all__ = ["FoldedBf16Ops", "conv1x1_bn_relu_stats", "conv1x1_stats", "conv_bias_act",
           "fold_block_weights", "make_folded_encoder_bf16"]
