"""Hand100M (Ego4D / 100DOH) sample source (counterpart of
``simhand_tpu/data/sources/hand100m.py``), with the reference loader's
semantics:

  * decode the full frame, crop the annotated hand box at SCALE=1.3 into a
    square 224x224 RGB crop;
  * pixel-scale the normalized keypoints to the crop;
  * left hands are flipped horizontally (image + keypoints) so the model
    only ever sees right hands;
  * camera K is identity, relative depth forced to 1.0, joints_valid = 0
    (pseudo labels: the 2D keypoints only drive crops and weights);
  * each sample carries its mined positive's dataset index and distance.

``cv2`` is imported only where a frame is read or cropped.
"""
from __future__ import annotations

import os

import numpy as np

from simhand_tpu_torch.data.annotations import (
    Hand100MAnnotations,
    annotation_path,
    load_hand100m,
)

BOX_SCALE = 1.3
CROP_SIZE = 224


def crop_and_resize_box(
    image: np.ndarray, box: np.ndarray, scale: float, target_size: int
) -> np.ndarray:
    """Square crop around a scaled box, resized to target (reference:
    src/data_loader/utils.py:392-420 — int truncations preserved)."""
    import cv2

    x1, y1, x2, y2 = (int(v) for v in box)
    width, height = x2 - x1, y2 - y1
    scaled_w, scaled_h = int(width * scale), int(height * scale)
    sx1 = x1 - int((scaled_w - width) / 2)
    sy1 = y1 - int((scaled_h - height) / 2)
    sx2 = x2 + int((scaled_w - width) / 2)
    sy2 = y2 + int((scaled_h - height) / 2)
    cx, cy = (sx1 + sx2) / 2, (sy1 + sy2) / 2
    half = max(sx2 - sx1, sy2 - sy1) // 2
    qx1 = max(0, int(cx - half))
    qy1 = max(0, int(cy - half))
    qx2 = min(image.shape[1], int(cx + half))
    qy2 = min(image.shape[0], int(cy + half))
    crop = image[qy1:qy2, qx1:qx2]
    return cv2.resize(crop, (target_size, target_size))


class Hand100MSource:
    """Index-addressable sample source over one annotation file."""

    def __init__(
        self,
        root_dir: str,
        source: str = "ego4d",
        scale: str = "1m",
        split: str = "train",
        annotations: Hand100MAnnotations | None = None,
        crop_size: int = CROP_SIZE,
    ):
        """``crop_size``: side of the square hand crop. The reference
        hard-codes 224 (ego4d_loader.py RES), but since keypoints are
        stored NORMALIZED and pixel-scaled here (and pseudo-depth is
        forced to 1.0), any crop size is exactly "the reference loader
        at that resolution" — one resample from the full frame, no
        geometry drift. Used by the train-resolution crop cache
        (data/cache.py) to cut host+H2D bytes ~2-3x for the 128² model.
        """
        self.root_dir = root_dir
        self.source = source
        self.split = split
        self.crop_size = int(crop_size)
        if annotations is None:
            annotations = load_hand100m(annotation_path(root_dir, source, scale))
        self.db = annotations

    def __len__(self) -> int:
        return len(self.db)

    def __getitem__(self, idx: int) -> dict:
        import cv2

        a = self.db.annotations[idx]
        img_rec = self.db.image_by_id[a["image_id"]]
        img_name = os.path.join(self.root_dir, img_rec["file_name"])
        img = cv2.cvtColor(cv2.imread(img_name), cv2.COLOR_BGR2RGB)

        crop = crop_and_resize_box(
            img, self.db.boxes(idx), BOX_SCALE, self.crop_size
        )

        joints25d = self.db.keypoints(idx).copy()        # normalized
        joints_raw = joints25d.copy()
        joints25d[:, 0] *= crop.shape[1]
        joints25d[:, 1] *= crop.shape[0]

        if a["left_right"] == "Left":
            crop = cv2.flip(crop, 1)
            joints25d[:, 0] = crop.shape[1] - joints25d[:, 0]
            joints_raw[:, 0] = 1.0 - joints_raw[:, 0]

        joints25d[:, -1] = 1.0  # pseudo depth (reference: ego4d_loader.py:138)

        return {
            "image": crop,
            "image_name": img_name,
            "hand_id": int(a["hand_id"]),
            "K": np.eye(3, dtype=np.float32),
            "joints3D": joints25d.astype(np.float32),
            "joints_valid": np.zeros((21, 1), dtype=np.float32),
            "joints_raw": joints_raw.astype(np.float32),
            "positive_sample": str(a["positive_sample"][0]),
            "positive_sample_idx": self.db.positive_index(idx),
            "distance": float(a["distance"][0]),
        }
