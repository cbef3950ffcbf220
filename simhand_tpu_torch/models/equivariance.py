"""PeCLR feature-space equivariance (counterpart of
``simhand_tpu/models/equivariance.py``): undo the crop translation and the
rotation directly on the 128-D projections viewed as 64 2-D points.

The centroid and spread statistics are taken under ``detach()``, as the
reference does.
"""
from __future__ import annotations

import torch

from simhand_tpu_torch.core.geometry import apply_affine_2d, opencv_rotation_matrix


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(|x|, eps), with the clamp inside the sqrt: the forward equals
    ``F.normalize``'s, and the gradient at an exactly-zero vector is finite
    (``F.normalize`` clamps outside the norm, whose gradient there is 0/0)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def translate_encodings(enc, translate_x, translate_y):
    """Shift (B, P, 2) encodings by the normalised jitter, scaled by each
    sample's detached per-axis spread."""
    stats = enc.detach()
    spread = stats.amax(dim=1) - stats.amin(dim=1)         # (B, 2)
    dx = (translate_x * spread[:, 0])[:, None]
    dy = (translate_y * spread[:, 1])[:, None]
    return torch.stack([enc[..., 0] + dx, enc[..., 1] + dy], dim=-1)


def rotate_encodings(enc, angle_deg):
    """Rotate (B, P, 2) encodings by ``angle_deg`` about their detached
    centroid, OpenCV convention."""
    center = enc.detach().mean(dim=1)                      # (B, 2)
    mat = opencv_rotation_matrix(center[:, 0], center[:, 1], angle_deg)
    return apply_affine_2d(enc, mat)


def inverse_transform_projections(projections, jitter_x, jitter_y, angles,
                                  image_side: float):
    """The full PeCLR inverse transform of raw (2B, D) projections.

    jitter_x, jitter_y, angles: (2B,) per view, or None when that
    equivariance is off. Returns the re-normalised (z1, z2), (B, D) each.
    """
    two_b, d = projections.shape
    b = two_b // 2
    z = torch.cat(
        [_l2_normalize(projections[:b]), _l2_normalize(projections[b:])], dim=0
    ).reshape(two_b, d // 2, 2)
    if jitter_x is not None:
        z = translate_encodings(z, -jitter_x / image_side, -jitter_y / image_side)
    if angles is not None:
        z = rotate_encodings(z, -angles)
    z = z.reshape(two_b, d)
    return _l2_normalize(z[:b]), _l2_normalize(z[b:])
