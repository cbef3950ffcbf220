"""Hand100M annotation JSON (counterpart of ``simhand_tpu/data/annotations.py``):
reader, writer, index maps.

Schema (written by the mining job, read by ``data/sources/hand100m.py``):

  {
    "images": [
      {"id": int, "file_name": str, "width": int, "height": int}, ...
    ],
    "annotations": [
      {
        "image_id": int,
        "hand_id": int-convertible id (unique),
        "boxes": JSON-encoded "[x1, y1, x2, y2]" string,
        "keypoint_25d": 63 floats (21 x (x, y, z), x/y normalized to [0,1]),
        "left_right": "Left" | "Right",
        "positive_sample": [hand_id, ...]   (top-k similar hands),
        "distance": [float, ...]            (their similarity distances)
      }, ...
    ]
  }

The file name convention is
``annotations/{Ego4D,100DOH}/Hand100M_{source}_{scale}_v1-1.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np


@dataclasses.dataclass
class Hand100MAnnotations:
    images: list[dict]
    annotations: list[dict]

    def __post_init__(self):
        self.image_by_id = {img["id"]: img for img in self.images}
        self.index_by_hand_id = {
            str(a["hand_id"]): i for i, a in enumerate(self.annotations)
        }
        if len(self.index_by_hand_id) != len(self.annotations):
            raise ValueError("duplicate hand_id in annotations")

    def __len__(self) -> int:
        return len(self.annotations)

    def positive_index(self, idx: int) -> int:
        """Dataset index of the top-1 similar hand of annotation ``idx``."""
        a = self.annotations[idx]
        return self.index_by_hand_id[str(a["positive_sample"][0])]

    def keypoints(self, idx: int) -> np.ndarray:
        return np.asarray(
            self.annotations[idx]["keypoint_25d"], dtype=np.float32
        ).reshape(21, 3)

    def boxes(self, idx: int) -> np.ndarray:
        b = self.annotations[idx]["boxes"]
        if isinstance(b, str):
            b = json.loads(b)
        return np.asarray(b, dtype=np.float32)


def annotation_path(
    root_dir: str, source: str, scale: str, version: str = "v1-1"
) -> str:
    sub = {"ego4d": "Ego4D", "100doh": "100DOH"}[source.lower()]
    return os.path.join(
        root_dir, "annotations", sub, f"Hand100M_{sub}_{scale}_{version}.json"
    )


def load_hand100m(path: str) -> Hand100MAnnotations:
    with open(path) as f:
        data = json.load(f)
    return Hand100MAnnotations(images=data["images"], annotations=data["annotations"])


def write_hand100m(
    path: str, images: list[dict], annotations: list[dict]
) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def default(o: Any):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f, default=default)
