"""Batch embedding over the serving forward (counterpart of the device part
of ``simhand_tpu/serving/embed.py``).

Crops travel to the device as uint8 (4x less host-to-device traffic than
float32); scaling, the bilinear resize and the ImageNet normalization run
there, and every batch is padded to the same shape.

Not in this module yet (ROADMAP Queue 1 item 13, with the ``torch.export``
artifacts and the data slice): the crop-cache and image-glob readers and the
``main`` CLI.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from simhand_tpu_torch.device import resolve_device

# data/augment.py:41-42 of the JAX package
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _preprocess_fn(side: int, device=None):
    """-> preprocess(crops): (N, H, W, 3) uint8 -> (N, side, side, 3) float32
    on the device, (x / 255 resized, then normalized). The resize is
    ``jax.image.resize(..., "bilinear")``'s: half-pixel centres, a triangle
    filter widened by the scale when it shrinks (``antialias=True``)."""
    dev = resolve_device(device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)

    def preprocess(crops_u8):
        x = torch.as_tensor(crops_u8).to(dev).float() / 255.0
        if tuple(x.shape[1:3]) != (side, side):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(side, side), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
        return (x - mean) / std

    return preprocess


def embed_stream(call, batches, side: int, batch: int, what: str, device=None):
    """Pads every chunk of ``batches`` ((total, (k, H, W, 3) uint8) pairs) to
    ``batch`` rows (one shape), runs ``call`` on it and strips the pad rows
    on the host. Returns (N, D) float32."""
    preprocess = _preprocess_fn(side, device)
    out, total = [], None
    for total, crops in batches:
        k = crops.shape[0]
        if k < batch:
            crops = np.concatenate(
                [crops, np.zeros((batch - k,) + crops.shape[1:], crops.dtype)])
        out.append(call(preprocess(crops))[what][:k].float().cpu().numpy())
    emb = np.concatenate(out)
    if total is not None and emb.shape[0] != total:
        raise ValueError(f"the batches held {emb.shape[0]} rows, not the {total} they announced")
    return emb
