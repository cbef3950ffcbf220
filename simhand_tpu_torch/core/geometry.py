"""Hand geometry (counterpart of ``simhand_tpu/core/geometry.py``): the 2.5D
<-> 3D conversion and scale-normalized root depth (arXiv:1804.09534 eq.
6/7), 2-D rotation in the OpenCV convention and the augmentation's crop box.

The 3-term products (K @ X and its inverse's) are two float32 fused
multiply-adds in the joint order, as XLA's CPU dot computes them: each taken
in float64 and rounded once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from simhand_tpu_torch.core.joints import CHILD_JOINT, PARENT_JOINT


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _apply3(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) matrices applied to (..., N, 3) row vectors: out[..., k, i]
    = sum_j mat[..., i, j] vecs[..., k, j], in the order j = 0, 1, 2."""
    m = mat[..., None, :, :]             # (..., 1, 3, 3)
    v = vecs[..., :, None, :]            # (..., N, 1, 3)
    return _fma(m[..., 2], v[..., 2], _fma(m[..., 1], v[..., 1], m[..., 0] * v[..., 0]))


def _bone_length(joints_3d: torch.Tensor) -> torch.Tensor:
    bone = joints_3d[..., CHILD_JOINT, :] - joints_3d[..., PARENT_JOINT, :]
    sq = bone * bone
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def convert_to_2_5d(K: torch.Tensor, joints_3d: torch.Tensor):
    """3D camera-space joints -> 2.5D (pixel u, v, scale-normalized rel. depth).

    Args:
      K: (..., 3, 3) camera intrinsics.
      joints_3d: (..., 21, 3) joints in camera space.

    Returns:
      joints_25d: (..., 21, 3) — u, v in pixels; z relative to the wrist,
        normalized by the wrist->index_mcp bone length.
      scale: (...,) the bone length used for normalization.
    """
    scale = _bone_length(joints_3d)
    proj = _apply3(K, joints_3d) / joints_3d[..., -1:]
    z_rel = (joints_3d[..., -1] - joints_3d[..., PARENT_JOINT, -1][..., None]) / scale[..., None]
    return torch.cat([proj[..., :2], z_rel[..., None]], dim=-1), scale


def root_depth(joints_25d: torch.Tensor, K: torch.Tensor):
    """Scale-normalized absolute root (wrist) depth from 2.5D joints: the
    quadratic of arXiv:1804.09534 eq. 6/7 under the unit bone-length
    constraint between wrist and index_mcp
    (reference: src/data_loader/utils.py:69-108).

    Returns:
      z_root: (...,) scale-normalized root depth; K_inv: (..., 3, 3).
    """
    K_inv = torch.linalg.inv(K)
    ones = torch.ones_like(joints_25d[..., :1, -1])

    def back_project(j):
        uv1 = torch.cat([joints_25d[..., j, :2], ones], dim=-1)
        return _apply3(K_inv, uv1[..., None, :])[..., 0, :]

    xyz_n = back_project(PARENT_JOINT)
    xyz_m = back_project(CHILD_JOINT)
    x_n, y_n = xyz_n[..., 0], xyz_n[..., 1]
    x_m, y_m = xyz_m[..., 0], xyz_m[..., 1]
    Z_n = joints_25d[..., PARENT_JOINT, -1]
    Z_m = joints_25d[..., CHILD_JOINT, -1]
    C = 1.0

    a = (x_n - x_m) ** 2 + (y_n - y_m) ** 2
    b = 2.0 * (
        Z_n * (x_n**2 + y_n**2 - x_n * x_m - y_n * y_m)
        + Z_m * (x_m**2 + y_m**2 - x_n * x_m - y_n * y_m)
    )
    c = (
        (x_n * Z_n - x_m * Z_m) ** 2
        + (y_n * Z_n - y_m * Z_m) ** 2
        + (Z_n - Z_m) ** 2
        - C
    )
    z_root = 0.5 * (-b + torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 1e-6))
                    ) / torch.clamp_min(a, 1e-6)
    return z_root, K_inv


def convert_2_5d_to_3d(joints_25d: torch.Tensor, scale: torch.Tensor, K: torch.Tensor,
                       z_root: torch.Tensor | None = None) -> torch.Tensor:
    """2.5D joints (..., 21, 3) -> metric 3D camera-space joints (..., 21, 3);
    ``z_root``: an externally refined scale-normalized root depth."""
    z_root_calc, K_inv = root_depth(joints_25d, K)
    if z_root is None:
        z_root = z_root_calc
    z = (joints_25d[..., -1] + z_root[..., None]) * scale[..., None]
    uv1 = torch.cat([joints_25d[..., :2], torch.ones_like(joints_25d[..., -1:])], dim=-1)
    return _apply3(K_inv, uv1) * z[..., None]


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
