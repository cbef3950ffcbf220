"""FreiHAND pre-training source (real 3D labels + intrinsics; counterpart of
``simhand_tpu/data/sources/freihand.py``). ``cv2`` is imported only where a
frame is read.

Reference: src/data_loader/freihand_loader.py (F_DB): reads the official
training_{xyz,K,scale}.json, x4 green-screen replication of the train
split, freihand->ait joint reorder, per-sample dict with camera-space
joints3D so the supervised / simclr preps can compute true 2.5D.
"""
from __future__ import annotations

import json
import os

import numpy as np

from simhand_tpu_torch.core.joints import JointMap

_JM = JointMap()


class FreihandPretrainSource:
    def __init__(self, root_dir: str, split: str = "train",
                 train_ratio: float = 0.99, seed: int = 5):
        self.root = root_dir
        with open(os.path.join(root_dir, "training_K.json")) as f:
            self.K = np.asarray(json.load(f), np.float32)
        with open(os.path.join(root_dir, "training_xyz.json")) as f:
            self.xyz = np.asarray(json.load(f), np.float32)
        n = len(self.xyz)
        # seeded SHUFFLED split, replicating sklearn.train_test_split
        # (freihand_loader.py:45-71: random_state=seed, then sorted) — a
        # contiguous cut would make val a biased single-session tail,
        # FreiHAND being ordered by capture session
        perm = np.random.RandomState(seed).permutation(n)
        n_train = int(np.floor(n * train_ratio))
        n_test = int(np.ceil(n * (1.0 - train_ratio)))
        base = np.sort(
            perm[n_test : n_test + n_train] if split == "train"
            else perm[:n_test]
        )
        # x4 replication: green-screen composites share labels with originals
        self.indices = np.concatenate([base + k * n for k in range(4)])
        self.n_unique = n

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> dict:
        import cv2

        i = int(self.indices[idx])
        label = i % self.n_unique
        img_name = os.path.join(self.root, "training", "rgb", f"{i:08d}.jpg")
        img = cv2.cvtColor(cv2.imread(img_name), cv2.COLOR_BGR2RGB)
        joints3d = _JM.freihand_to_ait(self.xyz[label])
        return {
            "image": img,
            "image_name": img_name,
            "K": self.K[label],
            "joints3D": joints3d.astype(np.float32),
            "joints_valid": np.ones((21, 1), np.float32),
            "joints_raw": joints3d.astype(np.float32),
        }
