"""Training-curve plotting over the detnet trainer's npy logs (counterpart
of ``simhand_tpu/finetune/plot.py``; the port's trainer writes the same
npy files).

Reference: minimal-hand/plot.py — reads ``lossD/lossH/lossL.npy``
([epoch, value] rows) plus the ``auc_all.npy`` / ``acc_hm_all.npy``
per-dataset dicts from the output directory and renders one figure of
loss + AUC + heatmap-accuracy curves. The reference hardcodes its four
eval sets (rhd/stb/do/eo) and calls ``plt.show()``; here the panels are
driven by whatever keys the dicts contain and the figure is saved to
disk (headless-friendly — the reference's own ``savefig`` line is
commented out at plot.py:79).

  python -m simhand_tpu_torch.finetune.plot -p /tmp/detnet [--out vis.png]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def load_curves(path: str):
    losses = {}
    for name in ("lossH", "lossD", "lossL"):
        f = os.path.join(path, f"{name}.npy")
        if os.path.exists(f):
            arr = np.load(f)
            if arr.size:
                losses[name] = arr.reshape(-1, 2)
    dicts = {}
    for name in ("auc_all", "acc_hm_all"):
        f = os.path.join(path, f"{name}.npy")
        dicts[name] = (
            np.load(f, allow_pickle=True).item() if os.path.exists(f) else {}
        )
    return losses, dicts["auc_all"], dicts["acc_hm_all"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-p", "--out_path", default="out_loss_auc",
                   help="detnet trainer --out_dir containing the npy logs")
    p.add_argument("--out", default=None,
                   help="figure path (default <out_path>/vis_train.png)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    losses, auc_all, acc_hm_all = load_curves(args.out_path)
    # one loss panel + (AUC, ACC_HM) panel per eval dataset
    metric_panels = [("AUC", k, np.asarray(v, np.float64).reshape(-1, 2))
                     for k, v in sorted(auc_all.items())]
    metric_panels += [("ACC_HM", k, np.asarray(v, np.float64).reshape(-1, 2))
                      for k, v in sorted(acc_hm_all.items())]
    n_panels = 1 + len(metric_panels)
    cols = min(4, max(n_panels, 1))
    rows = (n_panels + cols - 1) // cols
    plt.figure(figsize=(5 * cols, 4 * rows))

    plt.subplot(rows, cols, 1)
    markers = {"lossH": "o", "lossD": "*", "lossL": "h"}
    for name, arr in losses.items():
        plt.plot(arr[:, 0], arr[:, 1], marker=markers[name], label=name)
    plt.title("LOSSES")
    if losses:
        plt.legend(title="Losses Category:")

    for i, (kind, name, arr) in enumerate(metric_panels, start=2):
        plt.subplot(rows, cols, i)
        plt.plot(arr[:, 0], arr[:, 1], marker="d")
        best = int(np.argmax(arr[:, 1]))
        plt.title("{}_eval || (EPOCH={} , {}={:0.4f})".format(
            name.upper(), int(arr[best, 0]), kind, arr[best, 1]))

    plt.tight_layout()
    out = args.out or os.path.join(args.out_path, "vis_train.png")
    plt.savefig(out)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
