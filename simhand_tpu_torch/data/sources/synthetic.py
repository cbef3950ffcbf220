"""Synthetic Hand100M data (counterpart of
``simhand_tpu/data/sources/synthetic.py``): procedural "hands" (dots at the
joints over a random background) with known keypoints, and positives
linked across "videos" by an exact top-1 MPJPE search.

The numpy half (``render_hands``, ``top1_cross_video`` and the in-memory
``SyntheticHandSource``) needs no ``cv2``: it builds a corpus and its crop
cache on a machine without it, and so does ``write_synthetic_annotation``,
which writes the annotation JSON of the JAX package's on-disk dataset.
``generate_synthetic_hand100m`` writes that dataset whole (the JPEG frames
beside the annotation) from the same draws, and imports ``cv2`` inside.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _render_hand(rng: np.random.Generator, side: int, joints_norm: np.ndarray):
    """Draws dots at the joints over a random background (uint8 RGB)."""
    img = rng.integers(0, 255, size=(side, side, 3), dtype=np.uint8)
    pts = (joints_norm[:, :2] * side).astype(np.int32)
    color = rng.integers(100, 255, size=3)
    for x, y in pts:
        x0, x1 = max(x - 2, 0), min(x + 3, side)
        y0, y1 = max(y - 2, 0), min(y + 3, side)
        img[y0:y1, x0:x1] = color
    return img


def _random_hand_joints(rng: np.random.Generator) -> np.ndarray:
    """Plausible normalized 21x3 keypoints: wrist + 5 fingers of 4 joints."""
    wrist = rng.uniform(0.35, 0.65, size=2)
    joints = np.zeros((21, 3), dtype=np.float32)
    joints[0, :2] = wrist
    for f in range(5):
        ang = rng.uniform(-np.pi, np.pi)
        direction = np.array([np.cos(ang), np.sin(ang)])
        for seg in range(4):
            # ait order: mcp block 1-5, pip 6-10, dip 11-15, tip 16-20
            j = 1 + seg * 5 + f
            joints[j, :2] = wrist + direction * 0.08 * (seg + 1)
    joints[:, :2] = np.clip(joints[:, :2], 0.02, 0.98)
    joints[:, 2] = rng.uniform(-0.2, 0.2, size=21)
    return joints


def render_hands(num_images: int, side: int, seed: int = 0):
    """The images (N, side, side, 3) uint8, normalised joints (N, 21, 3)
    float32 and left-hand flags (N,) of the synthetic corpus of ``seed``,
    drawn in the JAX generator's order (joints, image, hand side)."""
    rng = np.random.default_rng(seed)
    images = np.empty((num_images, side, side, 3), np.uint8)
    joints = np.empty((num_images, 21, 3), np.float32)
    left = np.empty(num_images, bool)
    for i in range(num_images):
        joints[i] = _random_hand_joints(rng)
        images[i] = _render_hand(rng, side, joints[i])
        left[i] = not rng.random() > 0.3
    return images, joints, left


def top1_cross_video(joints_xy: np.ndarray, video_ids: np.ndarray, rows: int = 256):
    """Each hand's nearest hand of another video by MPJPE (the metric the
    mining job uses), and that distance: (top1 (N,), distance (N,)). The
    (N, N) distances are computed ``rows`` at a time."""
    J = np.asarray(joints_xy)
    vid = np.asarray(video_ids)
    top1 = np.empty(len(J), np.int64)
    dist = np.empty(len(J), J.dtype)
    for lo in range(0, len(J), rows):
        d = np.linalg.norm(J[lo:lo + rows, None] - J[None, :], axis=-1).mean(-1)
        d[vid[lo:lo + rows, None] == vid[None, :]] = np.inf   # exclude same-video
        top1[lo:lo + rows] = d.argmin(axis=1)
        dist[lo:lo + rows] = d[np.arange(len(d)), top1[lo:lo + rows]]
    return top1, dist


class SyntheticHandSource:
    """An in-memory Hand100M-style source of the synthetic corpus, its
    images rendered at the crop side: the sample schema of the JAX
    package's ``Hand100MSource`` (pixel joints, pseudo depth 1, identity K,
    left hands flipped), with positives from ``top1_cross_video``, or the
    ``(positive_idx, distance)`` arrays given (a mining job's)."""

    def __init__(self, num_images: int, num_videos: int = 8, side: int = 224, seed: int = 0,
                 positives: tuple[np.ndarray, np.ndarray] | None = None):
        self.images, joints, left = render_hands(num_images, side, seed)
        if positives is None:
            positives = top1_cross_video(joints[:, :, :2], np.arange(num_images) % num_videos)
        self.positive_idx, self.distance = (np.asarray(a) for a in positives)
        self.joints_raw = joints.copy()
        self.joints_raw[left, :, 0] = 1.0 - self.joints_raw[left, :, 0]
        self.images[left] = self.images[left, :, ::-1]
        self.joints3d = self.joints_raw.copy()
        self.joints3d[..., :2] *= side
        self.joints3d[..., 2] = 1.0

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> dict:
        return {
            "image": self.images[idx],
            "image_name": f"synthetic:{idx}",
            "hand_id": idx,
            "K": np.eye(3, dtype=np.float32),
            "joints3D": self.joints3d[idx],
            "joints_valid": np.zeros((21, 1), np.float32),
            "joints_raw": self.joints_raw[idx],
            "positive_sample": str(self.positive_idx[idx]),
            "positive_sample_idx": int(self.positive_idx[idx]),
            "distance": float(self.distance[idx]),
        }


def write_synthetic_annotation(
    root_dir: str,
    num_images: int = 64,
    num_videos: int = 8,
    side: int = 256,
    source: str = "100doh",
    scale: str = "smoke",
    seed: int = 0,
) -> tuple[str, np.ndarray]:
    """Writes the annotation JSON of the synthetic Hand100M dataset under
    ``root_dir`` (the v1-1 schema, positives from ``top1_cross_video``), as
    ``generate_synthetic_hand100m`` writes it for the same arguments, but no
    frame: it needs no ``cv2``. Returns the annotation path and the images
    (N, side, side, 3) uint8 of the frames it names."""
    sub = {"ego4d": "Ego4D", "100doh": "100DOH"}[source.lower()]
    images, joints, left = render_hands(num_images, side, seed)
    video_ids = np.arange(num_images) % num_videos
    top1, dist = top1_cross_video(joints[:, :, :2], video_ids)

    records, annotations = [], []
    for i in range(num_images):
        file_name = os.path.join("frames", sub, f"video{video_ids[i]:03d}_frame{i:06d}.jpg")
        records.append({"id": i, "file_name": file_name, "width": side, "height": side})
        xy = joints[i, :, :2] * side
        x1, y1 = xy.min(axis=0)
        x2, y2 = xy.max(axis=0)
        annotations.append({
            "image_id": i,
            "hand_id": i,
            "boxes": json.dumps([float(x1), float(y1), float(x2), float(y2)]),
            "keypoint_25d": joints[i].reshape(-1).tolist(),
            "left_right": "Left" if left[i] else "Right",
            "positive_sample": [int(top1[i])],
            "distance": [float(dist[i])],
        })

    anno_path = os.path.join(
        root_dir, "annotations", sub, f"Hand100M_{sub}_{scale}_v1-1.json"
    )
    os.makedirs(os.path.dirname(anno_path), exist_ok=True)
    with open(anno_path, "w") as f:
        json.dump({"images": records, "annotations": annotations}, f)
    return anno_path, images


def generate_synthetic_hand100m(
    root_dir: str,
    num_images: int = 64,
    num_videos: int = 8,
    side: int = 256,
    source: str = "100doh",
    scale: str = "smoke",
    seed: int = 0,
) -> str:
    """Writes a synthetic Hand100M dataset under ``root_dir`` (JPEG frames
    and the annotation JSON, as the JAX package writes them for the same
    arguments). Returns the annotation JSON path."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("synthetic dataset generation needs cv2") from e

    anno_path, images = write_synthetic_annotation(
        root_dir, num_images, num_videos, side, source, scale, seed)
    with open(anno_path) as f:
        records = json.load(f)["images"]
    for record, image in zip(records, images):
        path = os.path.join(root_dir, record["file_name"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    return anno_path
