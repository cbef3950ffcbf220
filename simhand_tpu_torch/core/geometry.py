"""2-D rotation in the OpenCV convention and the augmentation's crop box
(counterpart of ``simhand_tpu/core/geometry.py:125-197``)."""
from __future__ import annotations

import math

import numpy as np
import torch


def rotation_matrix_2d(angle_deg: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise 2x2 rotation matrix (batched over leading dims)."""
    rad = angle_deg * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def opencv_rotation_matrix(
    center_x: torch.Tensor,
    center_y: torch.Tensor,
    angle_deg: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """``cv2.getRotationMatrix2D`` semantics, batched: (..., 2, 3).

    A positive angle rotates counter-clockwise in image coordinates (y
    down), as OpenCV does.
    """
    rad = angle_deg * (math.pi / 180.0)
    alpha = scale * torch.cos(rad)
    beta = scale * torch.sin(rad)
    row0 = torch.stack(
        [alpha, beta, (1.0 - alpha) * center_x - beta * center_y], dim=-1
    )
    row1 = torch.stack(
        [-beta, alpha, beta * center_x + (1.0 - alpha) * center_y], dim=-1
    )
    return torch.stack([row0, row1], dim=-2)


def apply_affine_2d(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Applies a (..., 2, 3) affine matrix to (..., N, 2) points."""
    return (
        torch.einsum("...ij,...nj->...ni", mat[..., :2], points)
        + mat[..., None, :, 2]
    )


def joint_mean(joints_xy: torch.Tensor) -> torch.Tensor:
    """Mean over the joints (dim -2) as XLA computes ``jnp.mean`` there: a
    float32 sum in joint order, times the float32 reciprocal of the count.
    Every device follows that order to the bit, so a mean that the callers
    truncate lands on the same integer everywhere."""
    n = joints_xy.shape[-2]
    total = joints_xy[..., 0, :]
    for i in range(1, n):
        total = total + joints_xy[..., i, :]
    return total * float(np.float32(1.0) / np.float32(n))


def crop_box_from_joints(
    joints_xy: torch.Tensor,
    crop_margin: torch.Tensor | float,
    jitter_xy: torch.Tensor,
):
    """Square crop box around the joint centroid: center = int(mean), side =
    2 * int(max radius * margin), origin clamped at 0, and the recorded
    jitter is ``center - side / 2 - origin`` (<= 0).

    Args:
      joints_xy: (..., 21, 2) pixel coordinates.
      crop_margin: scalar or (...,) margin multiplier.
      jitter_xy: (..., 2) integer-valued crop jitter (>= 0).

    Returns:
      origin_xy (..., 2), side (...,) and the recorded jitter (..., 2), all
      integer-valued floats.
    """
    center = torch.trunc(joint_mean(joints_xy))
    d = joints_xy - center[..., None, :]
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    # float32 sqrt through float64: correctly rounded on every device (the
    # CPU's vectorised float32 sqrt is not)
    radius = torch.sqrt(r2.amax(dim=-1).double()).float()
    side_half = torch.trunc(radius * crop_margin)
    origin = torch.clamp_min(center - side_half[..., None] + jitter_xy, 0.0)
    recorded_jitter = center - side_half[..., None] - origin
    return origin, 2.0 * side_half, recorded_jitter
