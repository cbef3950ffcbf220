from simhand_tpu_torch.ops.conv1x1 import conv1x1_bn_relu_stats, conv1x1_stats

__all__ = ["conv1x1_bn_relu_stats", "conv1x1_stats"]
