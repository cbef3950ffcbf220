from simhand_tpu_torch.models.contrastive import (
    ContrastiveConfig,
    ContrastiveModel,
    contrastive_loss_from_projections,
    projection_stats,
)
from simhand_tpu_torch.models.resnet import RESNETS, ResNet

__all__ = [
    "ContrastiveConfig",
    "ContrastiveModel",
    "RESNETS",
    "ResNet",
    "contrastive_loss_from_projections",
    "projection_stats",
]
