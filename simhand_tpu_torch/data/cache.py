"""The pre-cropped packed crop cache (counterpart of
``simhand_tpu/data/cache.py``, with the same layout on disk: a cache
written by either package reads the same in the other).

Every 224x224 uint8 crop is materialised once into fixed-record shards
that memmap straight into batch assembly: no JPEG decode, no crop
arithmetic, one native gather.

Layout under ``cache_dir``:
  crops_{i:05d}.npy   uint8 (n, 224, 224, 3), np.save format (memmapped)
  meta.npz            joints3D / joints_raw / positive_idx / hand_id /
                      distance arrays for the whole corpus
  index.json          {"num_samples": N, "shard_size": S, "crop_size": C}

``CachedHand100MSource`` has the sample schema of the JAX package's
``Hand100MSource``, so it drops into ``PretrainDataset`` unchanged.
"""
from __future__ import annotations

import json
import os

import numpy as np

from simhand_tpu_torch.gather import gather_records_sharded


def build_crop_cache(source, cache_dir: str, shard_size: int = 4096,
                     progress: bool = False) -> str:
    """Materialises a Hand100M-style source (``source[i]`` -> a sample dict
    with ``image``, ``joints3D`` and ``joints_raw``) into packed shards."""
    os.makedirs(cache_dir, exist_ok=True)
    n = len(source)
    first = source[0]
    crop_size = first["image"].shape[0]

    joints3d = np.zeros((n, 21, 3), np.float32)
    joints_raw = np.zeros((n, 21, 3), np.float32)
    positive_idx = np.zeros(n, np.int64)
    hand_id = np.zeros(n, np.int64)
    distance = np.zeros(n, np.float32)

    shard = None
    shard_idx = -1
    for i in range(n):
        s = source[i]
        k, off = divmod(i, shard_size)
        if k != shard_idx:
            if shard is not None:
                shard.flush()
            shard_idx = k
            count = min(shard_size, n - k * shard_size)
            shard = np.lib.format.open_memmap(
                os.path.join(cache_dir, f"crops_{k:05d}.npy"),
                mode="w+", dtype=np.uint8,
                shape=(count, crop_size, crop_size, 3),
            )
        shard[off] = s["image"]
        joints3d[i] = s["joints3D"]
        joints_raw[i] = s["joints_raw"]
        positive_idx[i] = s.get("positive_sample_idx", i)
        hand_id[i] = s.get("hand_id", i)
        distance[i] = s.get("distance", 0.0)
        if progress and (i + 1) % 10000 == 0:
            print(f"cached {i + 1}/{n}", flush=True)
    if shard is not None:
        shard.flush()

    np.savez(
        os.path.join(cache_dir, "meta.npz"),
        joints3d=joints3d, joints_raw=joints_raw,
        positive_idx=positive_idx, hand_id=hand_id, distance=distance,
    )
    with open(os.path.join(cache_dir, "index.json"), "w") as f:
        json.dump(
            {"num_samples": n, "shard_size": shard_size, "crop_size": crop_size},
            f,
        )
    return cache_dir


class CachedHand100MSource:
    """Memmap-backed source; schema-compatible with Hand100MSource."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "index.json")) as f:
            idx = json.load(f)
        self.n = idx["num_samples"]
        self.shard_size = idx["shard_size"]
        self.crop_size = int(idx.get("crop_size", 224))
        meta = np.load(os.path.join(cache_dir, "meta.npz"))
        self.joints3d = meta["joints3d"]
        self.joints_raw = meta["joints_raw"]
        self.positive_idx = meta["positive_idx"]
        self.hand_id = meta["hand_id"]
        self.distance = meta["distance"]
        n_shards = -(-self.n // self.shard_size)
        self.shards = [
            np.load(
                os.path.join(cache_dir, f"crops_{k:05d}.npy"), mmap_mode="r"
            )
            for k in range(n_shards)
        ]

    def __len__(self) -> int:
        return self.n

    def gather_crops(self, indices, out: np.ndarray | None = None) -> np.ndarray:
        """Batch crop assembly: (len(indices), C, C, 3) uint8 by one
        multithreaded native call across all shards, into ``out`` where
        given."""
        idx = np.asarray(indices, np.int64)
        return gather_records_sharded(
            self.shards, idx // self.shard_size, idx % self.shard_size, out
        )

    def __getitem__(self, idx: int) -> dict:
        k, off = divmod(idx, self.shard_size)
        return {
            "image": np.asarray(self.shards[k][off]),
            "image_name": f"cache:{idx}",
            "hand_id": int(self.hand_id[idx]),
            "K": np.eye(3, dtype=np.float32),
            "joints3D": self.joints3d[idx].copy(),
            "joints_valid": np.zeros((21, 1), np.float32),
            "joints_raw": self.joints_raw[idx].copy(),
            "positive_sample": str(self.hand_id[self.positive_idx[idx]]),
            "positive_sample_idx": int(self.positive_idx[idx]),
            "distance": float(self.distance[idx]),
        }
