"""Eval-only CLI: run a trained detnet over a registry dataset (counterpart of
``simhand_tpu/finetune/evaluate.py``):

  python -m simhand_tpu_torch.finetune.evaluate \\
      --dataset freihand --data_dir /data/freihand --split test \\
      --checkpoint /tmp/detnet/checkpoints [--backbone 50]

3D sets: the predicted root-relative bone-normalized joints are globally
aligned to gt (root 0, ref bone 0-9 — utils/align.py:12-25), then metric
EPE (mm) + PCK AUC over 20..50mm, and the normalized-frame EPE/AUC like
train-time eval. 2D / tip-only sets: heatmap-argmax 2D PCK in input-space
pixels over the valid joints (tip slots only for do/eo), and for do/eo
with their 3D tips the masked-tip metric EPE and AUC.

``--checkpoint`` reads the trainer's checkpoints (``CheckpointManager``),
``--pretrain`` a detnet ``.pth`` in the reference's keys. ``--device``:
``cuda`` (the default) or ``cpu``; without a card and without ``--device
cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from simhand_tpu_torch.convert import load_detnet_state_dict
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.finetune.benchmarks import FINGERTIP_IDS
from simhand_tpu_torch.finetune.datasets import DetnetSampleBuilder, detnet_batch_iterator
from simhand_tpu_torch.finetune.detnet import DetNet
from simhand_tpu_torch.finetune.evaluation import EvalUtil, global_align
from simhand_tpu_torch.finetune.registry import build_composed_dataset
from simhand_tpu_torch.finetune.train import init_detnet
from simhand_tpu_torch.train.checkpoint import CheckpointManager

logger = logging.getLogger("simhand_tpu_torch.finetune.evaluate")

TIP_ONLY = ("do", "eo", "dexter_object", "egodexter")
SETS_2D = ("cmu", "hand_labels", "hand143", "panoptic", "ganerated", "gan",
           "ego4d", "ego4d_hands") + TIP_ONLY


@torch.no_grad()
def evaluate_dataset(model, dataset, key: str, batch_size: int = 64,
                     max_batches: int | None = None, dump_pre_joints: str | None = None,
                     device=None) -> dict:
    """The JAX ``evaluate_dataset``'s metrics for ``model`` (eval mode) on
    ``dataset``, its batches' images made on ``device``."""
    builder = DetnetSampleBuilder(train=False)
    model.eval()

    key = key.lower()
    is_2d = key in SETS_2D
    metric_eval = EvalUtil()       # aligned metric EPE (m)
    norm_eval = EvalUtil()         # normalized-frame EPE
    px_eval = EvalUtil()           # 2D pixel PCK
    tip3d_eval = EvalUtil(num_kp=1)  # DO/EO masked 3D-tip protocol
    pre_joints = [] if dump_pre_joints else None
    n_batches = 0
    for batch in detnet_batch_iterator(dataset, builder, batch_size, shuffle=False,
                                       drop_remainder=False, device=device):
        preds = {k: v.cpu().numpy() for k, v in model(batch["img"]).items()}
        if pre_joints is not None:
            pre_joints.append(preds["xyz"].astype(np.float32))
        if is_2d or "joint" not in batch:
            # heatmap argmax -> input-space 2D keypoints
            uv = preds["uv"].astype(np.float64)                       # (N,21,2) rc @32
            uv = uv[..., ::-1] * (builder.inp_res / builder.hm_res)   # -> xy
            gt = np.asarray(batch["kp2d"], np.float64)
            vis = np.asarray(batch["hm_veil"], bool)
            if key in TIP_ONLY:
                mask = np.zeros_like(vis)
                mask[:, FINGERTIP_IDS] = vis[:, FINGERTIP_IDS]
                # raw-annotation validity from the builder: zero-filled
                # rows are no longer zero after the affine transform
                vis = mask & np.asarray(batch["kp2d_valid"], bool)
            px_eval.feed(gt, uv, vis)
            if "tips_3d" in batch:
                # the reference's headline DO/EO metric: masked
                # centroid/scale alignment of predicted tips onto the
                # valid 3D gt tips, then metric EPE (align.py:27-57)
                gt3, p3, counts = global_align(np.asarray(batch["tips_3d"], np.float64),
                                               preds["xyz"].astype(np.float64), "do")
                if len(gt3):
                    tip3d_eval.feed(gt3.reshape(-1, 1, 3), p3.reshape(-1, 1, 3))
        else:
            xyz = preds["xyz"].astype(np.float64)                     # normalized
            gt = np.asarray(batch["joint"], np.float64)
            root = batch["joint_root"][:, None]
            bone = batch["joint_bone"].reshape(-1, 1, 1)
            norm_eval.feed((gt - root) / bone, xyz)
            # de-normalize through the reference global alignment
            gt_a, pred_a = global_align(gt, xyz, "fh")
            metric_eval.feed(gt_a, pred_a)
        n_batches += 1
        if max_batches and n_batches >= max_batches:
            break

    if pre_joints is not None:
        # the reference's out_testset/<data>_pre_joints.npy artifact:
        # (N, 21, 3) freihand-order normalized predictions
        np.save(dump_pre_joints, np.concatenate(pre_joints))
        logger.info("dumped predictions: %s", dump_pre_joints)

    out: dict = {"dataset": key, "batches": n_batches}
    if is_2d:
        # PCK curve over pixel thresholds; report PCK@{8,16}px + mean EPE
        epe_mean, _, epe_median, _, curve, th = px_eval.get_measures(0.0, 32.0, 33)
        out.update({
            "epe_px_mean": epe_mean,
            "epe_px_median": epe_median,
            "pck@8px": float(curve[np.searchsorted(th, 8.0)]),
            "pck@16px": float(curve[np.searchsorted(th, 16.0)]),
        })
        if tip3d_eval._dists:
            epe_mean, _, epe_median, auc, _, _ = tip3d_eval.get_measures(0.020, 0.050, 20)
            out.update({"epe_mm_mean": epe_mean * 1000.0,
                        "epe_mm_median": epe_median * 1000.0, "auc_20_50mm": auc})
    else:
        epe_mean, _, epe_median, auc, _, _ = metric_eval.get_measures(0.020, 0.050, 20)
        out.update({"epe_mm_mean": epe_mean * 1000.0, "epe_mm_median": epe_median * 1000.0,
                    "auc_20_50mm": auc})
        epe_mean, _, epe_median, auc, _, _ = norm_eval.get_measures(0.0, 0.05, 20)
        out.update({"epe_norm_mean": epe_mean, "epe_norm_median": epe_median,
                    "auc_norm": auc})
    return out


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, help="one registry key (finetune/registry.py)")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--setup", default="s1", choices=["s1", "s2"])
    p.add_argument("--backbone", default="50", choices=["18", "50", "152"])  # 18: smoke/tests
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir written by finetune.train")
    p.add_argument("--pretrain", default=None,
                   help=".pth detnet (torch interop) instead of --checkpoint")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--out_json", default=None)
    p.add_argument("--dump_pre_joints", default=None,
                   help="save predicted (N,21,3) joints npy — the "
                        "reference's out_testset/<data>_pre_joints.npy")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)
    dev = resolve_device(device or args.device)

    logging.basicConfig(level=logging.INFO)

    model = DetNet(resnet_size=args.backbone, dtype=torch.bfloat16)
    init_detnet(model, 0)
    if args.pretrain:
        load_detnet_state_dict(model, torch.load(args.pretrain, map_location="cpu",
                                                 weights_only=True))
        logger.info("loaded torch detnet from %s", args.pretrain)
    if args.checkpoint:
        manager = CheckpointManager(args.checkpoint, metric="det_total")
        raw = manager.restore_tree(map_location="cpu")
        manager.close()
        if raw is None:
            raise FileNotFoundError(f"no checkpoint steps under {args.checkpoint}")
        model.load_state_dict(raw["model"], strict=True)
        logger.info("restored checkpoint from %s", args.checkpoint)
    model.to(dev)

    dataset = build_composed_dataset(args.dataset, args.data_dir, args.split, setup=args.setup,
                                     synthetic_n=max(args.batch_size, 64))
    metrics = evaluate_dataset(model, dataset, args.dataset, args.batch_size, args.max_batches,
                               dump_pre_joints=args.dump_pre_joints, device=dev)
    print(json.dumps(metrics))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
