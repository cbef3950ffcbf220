"""YouTube3DHands pre-training source (counterpart of
``simhand_tpu/data/sources/youtube.py``).

Reference: src/data_loader/youtube_loader.py (YTB_DB): COCO-style
youtube_train.json whose annotations carry 778-vertex MANO meshes; 21
joints are recovered as J_regressor-weighted vertices + 5 fingertip
vertices (src/data_loader/utils.py:372-390), then reordered mano->ait.

The 16x778 regressor matrix ships with MANO and is passed in. Like the JAX
package's, the pre-training entry point's ``build_sources`` refuses this
source; ``cv2`` is imported where a frame is read.
"""
from __future__ import annotations

import json
import os

import numpy as np

from simhand_tpu_torch.core.joints import TIP_VERTEX_IDS, JointMap

_JM = JointMap()


class YoutubeSource:
    def __init__(self, root_dir: str, split: str = "train",
                 mano_regressor: np.ndarray | None = None):
        self.root = root_dir
        with open(os.path.join(root_dir, f"youtube_{split}.json")) as f:
            data = json.load(f)
        self.images = {img["id"]: img for img in data["images"]}
        self.annotations = data["annotations"]
        if mano_regressor is None:
            raise ValueError(
                "YoutubeSource needs the MANO 16x778 J_regressor "
                "(pass ManoModel(pkl).J_regressor)"
            )
        self.regressor = np.asarray(mano_regressor, np.float32)

    def __len__(self) -> int:
        return len(self.annotations)

    def joints_from_mesh(self, vertices: np.ndarray) -> np.ndarray:
        joints16 = self.regressor @ vertices
        tips = vertices[list(TIP_VERTEX_IDS)]
        return np.concatenate([joints16, tips], axis=0)

    def __getitem__(self, idx: int) -> dict:
        import cv2

        a = self.annotations[idx]
        img_rec = self.images[a["image_id"]]
        img_name = os.path.join(self.root, img_rec["name"])
        raw = cv2.imread(img_name)
        if raw is None:
            raise FileNotFoundError(img_name)
        img = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
        vertices = np.asarray(a["vertices"], np.float32)
        joints_mano = self.joints_from_mesh(vertices)
        joints3d = _JM.mano_to_ait(joints_mano).astype(np.float32)
        # reference semantics (youtube_loader.py:160-178): left hands are
        # flipped to right; depth := 1.0 (identity K, like the mined
        # crops); joints_valid is zeros — the pseudo-labels are not
        # supervision. The loader computes a mesh-depth joints_raw but
        # DROPS it from the sample dict, so the preps' fallback
        # (data_set.py:379-383) makes the EFFECTIVE joints_raw the
        # depth-1.0 joints3D — reproduced here.
        if int(a.get("is_left", 0)) == 1:
            img = cv2.flip(img, 1)
            joints3d[:, 0] = img.shape[1] - joints3d[:, 0]
        joints3d[:, -1] = 1.0
        joints_raw = joints3d.copy()
        return {
            "image": img,
            "image_name": img_name,
            "K": np.eye(3, dtype=np.float32),
            "joints3D": joints3d,
            "joints_valid": np.zeros((21, 1), np.float32),
            "joints_raw": joints_raw,
        }
