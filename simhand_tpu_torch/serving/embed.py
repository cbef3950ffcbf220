"""Offline batch embedding: run an encoder artifact over a corpus
(counterpart of ``simhand_tpu/serving/embed.py``).

The pre-training product is the encoder; its serving job is bulk feature
extraction (retrieval, re-mining, downstream probes). This CLI (console
script ``simhand-torch-embed``) streams a packed crop cache
(``data/cache.py``) or an image glob through a serving artifact
(``export.py``) and writes ``(N, D)`` float32 embeddings; it runs on the
card unless given ``--device cpu``:

  simhand-torch-export-serving --surface encoder --pth resnet50_simhand.pth \\
      --out enc.pt2
  python -m simhand_tpu_torch.serving.embed --artifact enc.pt2 \\
      --cache /data/crop_cache --out embeddings.npy

Crops travel to the device as uint8 (4x less host-to-device traffic than
float32); scaling, the bilinear resize and the ImageNet normalization run
there, and every batch is padded to the same shape. The image route needs
``cv2``, imported inside ``_iter_images``; the cache route does not.
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import time

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


def _iter_cache(cache_dir: str, batch: int):
    from simhand_tpu_torch.data.cache import CachedHand100MSource

    src = CachedHand100MSource(cache_dir)
    n = len(src)
    for lo in range(0, n, batch):
        yield n, src.gather_crops(np.arange(lo, min(lo + batch, n)))


def _iter_images(pattern: str, batch: int):
    import cv2

    paths = sorted(globlib.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no files match {pattern!r}")
    n = len(paths)
    for lo in range(0, n, batch):
        imgs = []
        for p in paths[lo:lo + batch]:
            img = cv2.imread(p, cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"unreadable image: {p}")
            imgs.append(img[:, :, ::-1])  # BGR -> RGB (training convention)
        side = max(i.shape[0] for i in imgs)
        imgs = [i if i.shape[:2] == (side, side) else cv2.resize(i, (side, side))
                for i in imgs]
        yield n, np.stack(imgs)


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


def main(argv=None, device=None):
    """Embeds a corpus; ``device`` overrides ``--device``. Prints the
    reference's JSON line and returns it (its numbers unrounded)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--artifact", required=True, help="encoder serving artifact")
    p.add_argument("--cache", default=None, help="packed crop cache directory (data/cache.py)")
    p.add_argument("--images", default=None, help="glob of image files (e.g. 'crops/*.jpg')")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--what", choices=("embedding", "projection"), default="embedding")
    p.add_argument("--shard_devices", action="store_true",
                   help="split each batch over every card, one copy of the program on each "
                        "(--batch must divide by the card count)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", required=True, help=".npy output path")
    args = p.parse_args(argv)
    if bool(args.cache) == bool(args.images):
        raise SystemExit("exactly one of --cache / --images is required")

    from simhand_tpu_torch.serving.export import load_artifact, shard_over_devices

    dev = resolve_device(device or args.device)
    call, meta = load_artifact(args.artifact, dev)
    if args.shard_devices:
        call, n_dev = shard_over_devices(call, None if dev.type == "cuda" else [dev])
        if args.batch % n_dev:
            raise SystemExit(f"--batch {args.batch} not divisible by {n_dev} devices")
    side = int(meta.get("side", 128))
    batches = (_iter_cache(args.cache, args.batch) if args.cache
               else _iter_images(args.images, args.batch))
    t0 = time.perf_counter()
    emb = embed_stream(call, batches, side, args.batch, args.what, device=dev)
    dt = time.perf_counter() - t0
    np.save(args.out, emb)
    info = {"out": args.out, "shape": list(emb.shape), "what": args.what,
            "images_per_sec": emb.shape[0] / dt, "seconds": dt}
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
