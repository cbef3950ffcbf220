"""The general generator of pre-training traffic: a corpus of synthetic hand
crops with their joints and mined positives, written once into the port's
packed crop cache format, which the feed then reads.

A traffic file (``traffic/<name>.json``) gives its parameters:

  corpus_size      crops in the corpus (a multiple of 2: positives come in pairs)
  crop_side        side of each uint8 crop, in pixels
  corpus_seed      the seed of the corpus's draws
  shard_size       crops in each cache shard
  positive_noise   spread (normalised units) of a positive's joints about its partner's
  left_share       share of left hands, mirrored as the reference's loader mirrors them

The drawing is ``data/sources/synthetic.py``'s, rewritten in torch and batched
on the card: a wrist in [0.35, 0.65]^2, five fingers of four joints each at
0.08 steps along a random direction, a depth in [-0.2, 0.2], a random
background with a 5 x 5 dot of one colour at every joint. Positives are drawn
with their anchor, not searched for: crops 2k and 2k + 1 hold the same pose,
the second moved by ``positive_noise``, and each is the other's positive,
as a mining job pairs near-identical hands of two videos.

The corpus does not depend on a run's ``--seed``: it stands for the data set
on disk, and the seed picks the order the feed reads it in and the weights.
It is built once per checkout, in a directory named by a digest of its
parameters, and reused by every later run.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

FINGERS, SEGMENTS = 5, 4


def _draw_joints(g: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 21, 3) normalised joints: wrist, then ait order (mcp 1-5, pip
    6-10, dip 11-15, tip 16-20)."""
    wrist = 0.35 + 0.3 * torch.rand(n, 2, generator=g, device=device)
    angle = (torch.rand(n, FINGERS, generator=g, device=device) * 2 - 1) * np.pi
    direction = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)      # (n, 5, 2)
    steps = 0.08 * torch.arange(1, SEGMENTS + 1, device=device, dtype=torch.float32)
    fingers = wrist[:, None, None] + direction[:, None] * steps[None, :, None, None]
    xy = torch.cat([wrist[:, None], fingers.reshape(n, SEGMENTS * FINGERS, 2)], dim=1)
    z = 0.4 * torch.rand(n, 21, 1, generator=g, device=device) - 0.2
    return torch.cat([xy.clamp(0.02, 0.98), z], dim=-1)


def draw_corpus(traffic: dict, device) -> dict:
    """The corpus of ``traffic`` as host arrays: images (N, S, S, 3) uint8,
    joints_raw (N, 21, 3) normalised (left hands mirrored), joints3d (N, 21,
    3) in pixels with depth 1, positive_idx (N,) and distance (N,)."""
    n, side = int(traffic["corpus_size"]), int(traffic["crop_side"])
    if n % 2:
        raise ValueError(f"corpus_size {n} is odd: positives come in pairs")
    g = torch.Generator(device=device).manual_seed(int(traffic["corpus_seed"]))
    anchors = _draw_joints(g, n // 2, device)
    noise = float(traffic["positive_noise"]) * torch.randn(
        n // 2, 21, 2, generator=g, device=device)
    partners = anchors.clone()
    partners[..., :2] = (anchors[..., :2] + noise).clamp(0.02, 0.98)
    partners[..., 2] = 0.4 * torch.rand(n // 2, 21, generator=g, device=device) - 0.2
    joints = torch.stack([anchors, partners], dim=1).reshape(n, 21, 3)

    images = torch.randint(0, 255, (n, side, side, 3), generator=g, device=device,
                           dtype=torch.uint8)
    color = torch.randint(100, 255, (n, 3), generator=g, device=device, dtype=torch.uint8)
    # a 5 x 5 dot at each joint (rows y - 2 .. y + 2, columns x - 2 .. x + 2)
    px = (joints[..., :2] * side).to(torch.int64)                              # (n, 21, 2)
    off = torch.arange(-2, 3, device=device)
    xs = (px[..., 0, None, None] + off[None, :]).clamp(0, side - 1)             # (n, 21, 1, 5)
    ys = (px[..., 1, None, None] + off[:, None]).clamp(0, side - 1)             # (n, 21, 5, 1)
    flat = (ys * side + xs).reshape(n, -1)                                      # (n, 525)
    images.view(n, side * side, 3).scatter_(
        1, flat[..., None].expand(-1, -1, 3), color[:, None].expand(-1, flat.shape[1], 3))

    left = torch.rand(n, generator=g, device=device) < float(traffic["left_share"])
    joints[left, :, 0] = 1.0 - joints[left, :, 0]
    images[left] = images[left].flip(2)

    pos = torch.arange(n, device=device) ^ 1
    xy = joints[..., :2]
    distance = (xy - xy[pos]).norm(dim=-1).mean(dim=-1)
    joints3d = joints.clone()
    joints3d[..., :2] *= side
    joints3d[..., 2] = 1.0
    return {"images": images.cpu().numpy(), "joints_raw": joints.cpu().numpy(),
            "joints3d": joints3d.cpu().numpy(), "positive_idx": pos.cpu().numpy(),
            "distance": distance.cpu().numpy()}


class _ArraySource:
    """The corpus as a Hand100M-style source, which the port's cache builder
    takes sample by sample."""

    def __init__(self, corpus: dict):
        self.c = corpus

    def __len__(self) -> int:
        return len(self.c["images"])

    def __getitem__(self, i: int) -> dict:
        c = self.c
        return {"image": c["images"][i], "joints3D": c["joints3d"][i],
                "joints_raw": c["joints_raw"][i],
                "positive_sample_idx": int(c["positive_idx"][i]), "hand_id": i,
                "distance": float(c["distance"][i])}


def corpus_dir(traffic: dict, work_dir: str) -> str:
    """The fixed directory of ``traffic``'s corpus under ``work_dir``."""
    keys = ("corpus_size", "crop_side", "corpus_seed", "shard_size", "positive_noise",
            "left_share")
    digest = hashlib.sha256(json.dumps({k: traffic[k] for k in keys}, sort_keys=True)
                            .encode()).hexdigest()[:12]
    return os.path.join(work_dir, f"hand_corpus-{digest}")


def ensure_corpus(traffic: dict, work_dir: str, device) -> str:
    """The corpus's cache directory, built through the port's
    ``data.cache.build_crop_cache`` when it is not there yet."""
    from simhand_tpu_torch.data.cache import build_crop_cache

    out = corpus_dir(traffic, work_dir)
    if os.path.exists(os.path.join(out, "index.json")):
        return out
    partial = out + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    build_crop_cache(_ArraySource(draw_corpus(traffic, device)), partial,
                     shard_size=int(traffic["shard_size"]))
    shutil.rmtree(out, ignore_errors=True)
    os.replace(partial, out)
    return out
