"""2-D rotation in the OpenCV convention (counterpart of
``simhand_tpu/core/geometry.py:125-163``)."""
from __future__ import annotations

import math

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
