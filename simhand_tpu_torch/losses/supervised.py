"""Supervised 2.5D losses and EPE metrics (counterpart of
``simhand_tpu/losses/supervised.py``; reference: src/models/utils.py:23-107,
cal_l1_loss, cal_3d_loss, calculate_metrics). Used by the downstream 2.5D
regression head; ``torch_median`` also by the projection statistics."""
from __future__ import annotations

import torch

from simhand_tpu_torch.core.geometry import convert_2_5d_to_3d


def l1_loss_25d(pred_joints: torch.Tensor, true_joints: torch.Tensor, scale: torch.Tensor,
                joints_valid: torch.Tensor | None = None):
    """Validity-weighted L1 on (B, 21, 3) 2.5D joints, z penalized apart;
    ``scale`` (B,) unscales the relative depth, ``joints_valid`` (B, 21, 1)
    (None: all valid). Returns (loss_2d, loss_z, loss_z_unscaled)."""
    if joints_valid is None:
        joints_valid = torch.ones_like(true_joints[..., -1:])
    w = joints_valid / torch.sum(joints_valid)
    err = torch.abs(pred_joints - true_joints)
    loss_2d = torch.sum(err[..., :-1] * w) / 2.0
    loss_z = err[..., -1:] * w
    loss_z_unscaled = torch.sum(loss_z * scale.reshape(-1, 1, 1))
    return loss_2d, torch.sum(loss_z), loss_z_unscaled


def loss_3d(pred_25d: torch.Tensor, joints3d_gt: torch.Tensor, scale: torch.Tensor,
            K: torch.Tensor, joints_valid: torch.Tensor,
            z_root: torch.Tensor | None = None) -> torch.Tensor:
    """3D MAE after lifting predicted 2.5D joints back to camera space."""
    pred_3d = convert_2_5d_to_3d(pred_25d, scale, K, z_root=z_root)
    w = joints_valid / torch.sum(joints_valid)
    return torch.sum(torch.abs(pred_3d - joints3d_gt) * w) / 3.0


def torch_median(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """The lower of the two middle order statistics for even counts (sorted
    index ``(n-1)//2``), where an interpolating median would average them."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    return torch.sort(x, dim=dim).values.select(dim, (n - 1) // 2)


def epe_metrics(y_pred: torch.Tensor, y_true: torch.Tensor, prefix: str = "train"):
    """Mean / median end-point error over (B, 21, D) joints (reference:
    src/models/utils.py:56-76, the median through torch.median)."""
    d = torch.sqrt(torch.sum((y_pred - y_true) ** 2, dim=-1))
    return {f"EPE_mean_{prefix}": torch.mean(d), f"EPE_median_{prefix}": torch_median(d)}
