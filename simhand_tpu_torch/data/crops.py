"""Joint-driven square cropping with the intrinsics updated (counterpart of
``simhand_tpu/data/crops.py``): a square crop of side max(bbox) * scale
around the 2D keypoints' bbox centre, resized to ``target_size``, with the
joints rescaled and the camera matrix updated (fx/fy scaled, principal
point shifted). ``cv2`` is imported inside the function.
"""
from __future__ import annotations

import numpy as np


def crop_and_resize_via_joints(
    image: np.ndarray,
    joints_2d: np.ndarray,
    target_size: int,
    scale: float,
    K: np.ndarray,
):
    """Returns (cropped_image, joints_scaled, K_updated)."""
    import cv2

    h, w = image.shape[:2]
    x1, y1 = joints_2d.min(axis=0)
    x2, y2 = joints_2d.max(axis=0)
    side = max(x2 - x1, y2 - y1) * scale
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0

    sx1 = max(0, min(int(cx - side / 2), w - 1))
    sy1 = max(0, min(int(cy - side / 2), h - 1))
    sx2 = max(0, min(int(cx + side / 2), w - 1))
    sy2 = max(0, min(int(cy + side / 2), h - 1))

    crop = image[sy1:sy2, sx1:sx2]
    if crop.size == 0:
        raise ValueError("empty crop — check keypoints/bounds")
    resized = cv2.resize(crop, (target_size, target_size))

    joints_scaled = (
        (joints_2d - np.array([sx1, sy1])) / (sx2 - sx1) * target_size
    )

    factor = target_size / side
    K_new = np.asarray(K, np.float32).copy()
    K_new[0, 0] *= factor
    K_new[1, 1] *= factor
    K_new[0, 2] = (K[0, 2] - sx1) * factor
    K_new[1, 2] = (K[1, 2] - sy1) * factor
    return resized, joints_scaled.astype(np.float32), K_new
