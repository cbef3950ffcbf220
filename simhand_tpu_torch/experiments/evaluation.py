"""Downstream evaluation of 2.5D predictions (counterpart of
``simhand_tpu/experiments/evaluation.py``).

Replicates src/experiments/evaluation_utils.py `evaluate()` (lines
162-227): batched forward over a supervised dataset, 2.5D -> 3D lifting
via the z-root quadratic, EPE 2D/3D mean/median, AUC of the PCK curve
(thresholds 0..0.5 step 0.005), and Procrustes-aligned statistics.
"""
from __future__ import annotations

import numpy as np
import torch

from simhand_tpu_torch.core.geometry import convert_2_5d_to_3d
from simhand_tpu_torch.finetune.evaluation import auc_joints, procrustes_align


def calculate_epe_statistics(pred, gt, dim: int = 3) -> dict:
    d = np.sqrt(np.sum((np.asarray(pred)[..., :dim] - np.asarray(gt)[..., :dim]) ** 2, -1))
    return {"mean": d.mean(), "median": np.median(d), "eucledian_dist": d}


def evaluate_25d(predict_fn, batches) -> dict:
    """Full downstream evaluation.

    Args:
      predict_fn: batch["image"] -> (B, 21, 3) predicted 2.5D joints.
      batches: iterable of supervised batch dicts with keys
        image, joints (2.5D gt), joints3D (gt camera space), K, scale,
        and optionally joints_raw (for Procrustes).

    Returns:
      metric dict mirroring the reference's `evaluate()` keys.
    """
    preds, gts25, gts3d, Ks, scales, raws = [], [], [], [], [], []
    for batch in batches:
        preds.append(np.asarray(predict_fn(batch["image"])))
        gts25.append(np.asarray(batch["joints"]))
        gts3d.append(np.asarray(batch["joints3D"]))
        Ks.append(np.asarray(batch["K"]))
        scales.append(np.asarray(batch["scale"]))
        raws.append(np.asarray(batch.get("joints_raw", batch["joints3D"])))
    pred = np.concatenate(preds)
    gt25 = np.concatenate(gts25)
    gt3d = np.concatenate(gts3d)
    K = np.concatenate(Ks)
    scale = np.concatenate(scales)
    raw = np.concatenate(raws)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    pred3d = convert_2_5d_to_3d(f32(pred), f32(scale), f32(K)).numpy()

    epe_2d = calculate_epe_statistics(pred, gt25, dim=2)
    epe_3d = calculate_epe_statistics(pred3d, gt3d, dim=3)
    auc_3d = float(np.mean(auc_joints(epe_3d["eucledian_dist"])))

    aligned, _, _, _ = procrustes_align(raw, pred3d)
    epe_3d_t = calculate_epe_statistics(aligned, raw, dim=3)
    auc_t = float(np.mean(auc_joints(epe_3d_t["eucledian_dist"])))

    return {
        "Mean_EPE_2D": float(epe_2d["mean"]),
        "Median_EPE_2D": float(epe_2d["median"]),
        "Mean_EPE_3D": float(epe_3d["mean"]),
        "Median_EPE_3D": float(epe_3d["median"]),
        "auc": auc_3d,
        "Mean_EPE_3D_procrustes": float(epe_3d_t["mean"]),
        "Median_EPE_3D_procrustes": float(epe_3d_t["median"]),
        "auc_procrustes": auc_t,
    }
