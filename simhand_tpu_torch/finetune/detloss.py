"""DetNet loss (counterpart of ``simhand_tpu/finetune/detloss.py``;
reference: minimal-hand/losses/detloss.py), on one device or over a data
axis (``parallel.mesh``).

  L = lambda_hm * sum_j 0.5 * MSE(hm_j * veil_j, hm_gt_j * veil_j)
    + lambda_dm * || (dm - dm_gt) * hm_tile ||_F / n_3d
    + lambda_lm * || (lm - lm_gt) * hm_tile ||_F / n_3d

3D terms are gated per-sample by flag_3d (2D-only datasets contribute only
the heatmap term), maskwise, as the JAX function computes them.
"""
from __future__ import annotations

import torch


def det_loss(preds: dict, hm_gt, dm_gt, lm_gt, hm_veil, flag_3d,
             lambda_hm: float = 100.0, lambda_dm: float = 1.0, lambda_lm: float = 1.0,
             axis=None):
    """Returns ``(total, parts)`` with the JAX function's arithmetic, the
    ``sqrt`` of the squared sums included.

    With an ``axis`` each rank holds its rows: the flagged count and the
    squared sums are psum'd before the ``sqrt``, so the dm/lm terms are the
    global batch's on every rank (a mean of per-rank norms would weigh them
    by sqrt(W)); the heatmap term stays this rank's mean. psum's backward
    is psum, so each rank's gradient is W times the single-device
    per-sample gradient and the trainer's pmean gives the single-device
    gradient, as JAX's does under ``shard_map``.

    The reference's fault is kept with it: when ``flag_3d`` is 0 for every
    sample, both squared sums are exactly 0 and the ``sqrt``'s gradient
    there makes NaN gradients for ``d_map``, ``l_map`` and everything
    upstream (in both packages; ROADMAP.md Queue 3, "faults of the
    reference"). A batch with one 3D sample has finite gradients.
    """
    n, j = hm_gt.shape[0], hm_gt.shape[-1]

    # heatmap: per-joint 0.5 * MSE over veiled maps, summed over joints
    veil = hm_veil.T[:, :, None]                                  # (21, N, 1)
    pred = preds["h_map"].permute(3, 0, 1, 2).reshape(j, n, -1)
    targ = hm_gt.permute(3, 0, 1, 2).reshape(j, n, -1)
    per_joint_mse = torch.mean((pred * veil - targ * veil) ** 2, dim=(1, 2))
    hm_loss = 0.5 * torch.sum(per_joint_mse)

    # 3D maps: Frobenius norm over flagged samples / count of flagged
    n3d = torch.sum(flag_3d)
    tile = hm_gt[..., None] * flag_3d.reshape(-1, 1, 1, 1, 1)     # (N, 32, 32, 21, 1)
    sq_dm = torch.sum(((preds["d_map"] - dm_gt) * tile) ** 2)
    sq_lm = torch.sum(((preds["l_map"] - lm_gt) * tile) ** 2)
    if axis is not None:
        n3d, sq_dm, sq_lm = axis.psum(torch.stack([n3d.to(sq_dm.dtype), sq_dm, sq_lm]))
    n3d = torch.clamp_min(n3d, 1.0)
    dm_loss = torch.sqrt(sq_dm) / n3d
    lm_loss = torch.sqrt(sq_lm) / n3d

    total = lambda_hm * hm_loss + lambda_dm * dm_loss + lambda_lm * lm_loss
    return total, {"det_hm": hm_loss, "det_dm": dm_loss, "det_lm": lm_loss,
                   "det_total": total}
