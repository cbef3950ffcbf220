"""Similar-pair sanity-check grid (counterpart of
``simhand_tpu/mining/visualize.py``).

Equivalent of the reference's Hand100M/similar_hand_vis.py: renders an
NxN grid of (anchor, mined positive) crop pairs from a Hand100M
annotation JSON so pairing quality can be eyeballed. Host only; ``cv2`` is
imported inside the functions.

  python -m simhand_tpu_torch.mining.visualize --root /data --source 100doh \
      --scale 1m --out grid.jpg --n 10
"""
from __future__ import annotations

import argparse

import numpy as np


def pair_grid(source, n: int = 10, cell: int = 112, seed: int = 0) -> np.ndarray:
    """(n*cell, 2*n*cell, 3) uint8 grid: each row holds n anchor|positive
    pairs side by side."""
    import cv2

    rng = np.random.default_rng(seed)
    idxs = rng.choice(len(source), size=n * n, replace=False)
    grid = np.zeros((n * cell, 2 * n * cell, 3), np.uint8)
    for k, idx in enumerate(idxs):
        r, c = divmod(k, n)
        anchor = source[int(idx)]
        positive = source[int(anchor["positive_sample_idx"])]
        a = cv2.resize(anchor["image"], (cell, cell))
        p = cv2.resize(positive["image"], (cell, cell))
        grid[r * cell:(r + 1) * cell, 2 * c * cell:(2 * c + 1) * cell] = a
        grid[r * cell:(r + 1) * cell, (2 * c + 1) * cell:(2 * c + 2) * cell] = p
    return grid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--source", default="100doh", choices=["ego4d", "100doh"])
    p.add_argument("--scale", default="1m")
    p.add_argument("--out", default="similar_pairs_grid.jpg")
    p.add_argument("--n", type=int, default=10)
    args = p.parse_args(argv)

    import cv2

    from simhand_tpu_torch.data.sources import Hand100MSource

    src = Hand100MSource(args.root, source=args.source, scale=args.scale)
    grid = pair_grid(src, n=args.n)
    cv2.imwrite(args.out, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
