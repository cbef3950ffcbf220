"""Data-integrity scanner (counterpart of ``simhand_tpu/data/validate.py``).

Equivalent of the reference's validity tooling
(src/data_loader/valid_youtube_samples.py and YTB_DB's per-split validity
CSV, youtube_loader.py:180-206): iterates a source, records indices whose
samples fail to load or carry non-finite values, writes a CSV. Host only.

  python -m simhand_tpu_torch.data.validate --root $DATA --source ego4d \
      --scale 1m --out invalid.csv
"""
from __future__ import annotations

import argparse
import csv

import numpy as np


def scan_source(source, limit: int | None = None):
    """Returns (n_checked, list of (idx, reason))."""
    bad = []
    n = len(source) if limit is None else min(limit, len(source))
    for i in range(n):
        try:
            s = source[i]
        except Exception as e:  # noqa: BLE001 — any load failure is the point
            bad.append((i, f"load_error: {type(e).__name__}: {e}"))
            continue
        img = s.get("image")
        if img is None or getattr(img, "size", 0) == 0:
            bad.append((i, "empty_image"))
            continue
        j = np.asarray(s.get("joints3D", np.zeros(1)))
        if not np.isfinite(j).all():
            bad.append((i, "non_finite_joints"))
    return n, bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--source", default="ego4d", choices=["ego4d", "100doh"])
    p.add_argument("--scale", default="1m")
    p.add_argument("--out", default="invalid_samples.csv")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)

    from simhand_tpu_torch.data.sources import Hand100MSource

    src = Hand100MSource(args.root, source=args.source, scale=args.scale)
    n, bad = scan_source(src, args.limit)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "reason"])
        w.writerows(bad)
    print(f"checked {n} samples: {len(bad)} invalid -> {args.out}")


if __name__ == "__main__":
    main()
