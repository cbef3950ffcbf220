"""What W8A8 serving costs in task metrics on a trained detnet: the port's
copy of the JAX package's ``scripts/int8_quality.py``.

``run_int8_quality`` fine-tunes a detnet on ``synthetic-hand`` through the
port's ``finetune.train.main`` (the transfer miniature's recipe), reloads
the ``detnet.pth`` it ships through ``convert.load_detnet_state_dict`` (the
weights that serving quantizes), and measures three forwards of it on the
same held-out split (synthetic-hand val, n = 64) with the same meters
(``finetune.train.evaluate_detnet_forward``, the reference's
evalutils measures):

  eval      the float32 model's eval-mode forward (the JAX script's "flax")
  fold_f32  ``serving.int8_infer.fold_detnet_f32``: BatchNorm folded, float32
  int8      ``build_detnet_int8``, its activation scales calibrated on two
            train batches through the val-style builder (the preprocessing
            of the serving input path)

It returns, and the command prints as one JSON line, each arm's meters
(hm_pck, hm_pck_loose, hm_dist, epe_mean, epe_median, auc), ``int8_sites``
and ``delta_int8_vs_f32`` (int8 less fold_f32, null for a meter that one
arm lacks), the JAX script's keys. It runs on the card unless given
``device="cpu"``; without a card it raises. The mains' logs go where
``BASE_PATH`` says; the command line sets it to ``<workdir>/runs`` unless it
is set.

    python -m simhand_tpu_torch.int8_quality [--train_steps 150] \\
        [--backbone 18] [--workdir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

#: the meters ``delta_int8_vs_f32`` compares
DELTA_METERS = ("hm_pck", "hm_pck_loose", "hm_dist", "epe_mean", "auc")
#: the held-out split: synthetic-hand val at the trainer's size
VAL_N = 64


def calibration_batches(dataset, batch_size: int, n: int = 2) -> list:
    """The first ``n`` batches of ``dataset`` through the val-style builder,
    in order, as float32 numpy images."""
    from simhand_tpu_torch.finetune.datasets import DetnetSampleBuilder, detnet_batch_iterator

    batches = detnet_batch_iterator(dataset, DetnetSampleBuilder(train=False), batch_size,
                                    shuffle=False, drop_remainder=True, device="cpu")
    return [b["img"].numpy() for _, b in zip(range(n), batches)]


def measure_arms(model, backbone: str, calib_batches, val_ds, batch_size: int,
                 device=None) -> dict:
    """The three arms of float32 ``model`` (a port ``DetNet`` on ``device``)
    on ``val_ds``, with ``int8_sites`` and ``delta_int8_vs_f32``."""
    import torch

    from simhand_tpu_torch.finetune.datasets import DetnetSampleBuilder
    from simhand_tpu_torch.finetune.train import evaluate_detnet_forward
    from simhand_tpu_torch.serving.int8_infer import build_detnet_int8, fold_detnet_f32

    def no_grad(fn):
        def forward(images):
            with torch.no_grad():
                return fn(images)
        return forward

    model.eval()
    qforward, report = build_detnet_int8(model, backbone, calib_batches=calib_batches)
    arms = {"eval": no_grad(model), "fold_f32": fold_detnet_f32(model, backbone),
            "int8": no_grad(qforward)}
    result = {name: evaluate_detnet_forward(fn, val_ds, DetnetSampleBuilder(train=False),
                                            batch_size, device)
              for name, fn in arms.items()}
    result["int8_sites"] = report["sites"]
    f32, q = result["fold_f32"], result["int8"]
    # a meter that one arm lacks (no 3D joints in the split) is null, not NaN
    result["delta_int8_vs_f32"] = {k: (q[k] - f32[k]) if (k in q and k in f32) else None
                                   for k in DELTA_METERS}
    return result


def run_int8_quality(workdir: str, train_steps: int = 150, batch_size: int = 16,
                     backbone: str = "18", lr: float = 3e-4, device=None) -> dict:
    """Fine-tunes in ``workdir`` (new or empty) on ``device`` (the card unless
    "cpu") and measures the three arms of the shipped weights."""
    import torch

    from simhand_tpu_torch.convert import load_detnet_state_dict
    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.finetune import train as finetune
    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.finetune.registry import build_composed_dataset
    from simhand_tpu_torch.transfer_check import _fresh, finetune_argv

    dev = resolve_device(device)
    _fresh(workdir)
    out_dir = os.path.join(workdir, "ft")
    finetune.main(finetune_argv(out_dir, train_steps, batch_size, lr, backbone),
                  device=str(dev))

    # serving quantizes the shipped weights: reload them from detnet.pth
    model = DetNet(resnet_size=backbone, dtype=torch.float32)
    load_detnet_state_dict(model, torch.load(os.path.join(out_dir, "detnet.pth"),
                                             map_location="cpu", weights_only=True))
    model.to(dev)
    # calibration on train images (the seed-0 draw, disjoint from the val split)
    train_ds = build_composed_dataset("synthetic-hand", None, "train",
                                      synthetic_n=max(batch_size * 2, 64))
    val_ds = build_composed_dataset("synthetic-hand", None, "val", synthetic_n=VAL_N)
    return measure_arms(model, backbone, calibration_batches(train_ds, batch_size), val_ds,
                        batch_size, dev)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_steps", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--backbone", default="18")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.INFO)
    workdir = args.workdir or tempfile.mkdtemp(prefix="int8_quality_")
    os.environ.setdefault("BASE_PATH", os.path.join(workdir, "runs"))
    result = run_int8_quality(workdir, args.train_steps, args.batch_size, args.backbone,
                              args.lr, device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
