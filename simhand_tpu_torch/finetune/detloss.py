"""DetNet loss on one device (counterpart of
``simhand_tpu/finetune/detloss.py``; reference: minimal-hand/losses/detloss.py).

  L = lambda_hm * sum_j 0.5 * MSE(hm_j * veil_j, hm_gt_j * veil_j)
    + lambda_dm * || (dm - dm_gt) * hm_tile ||_F / n_3d
    + lambda_lm * || (lm - lm_gt) * hm_tile ||_F / n_3d

3D terms are gated per-sample by flag_3d (2D-only datasets contribute only
the heatmap term), maskwise, as the JAX function computes them.
"""
from __future__ import annotations

import torch


def det_loss(preds: dict, hm_gt, dm_gt, lm_gt, hm_veil, flag_3d,
             lambda_hm: float = 100.0, lambda_dm: float = 1.0, lambda_lm: float = 1.0):
    """Returns ``(total, parts)`` with the JAX function's arithmetic, the
    ``sqrt`` of the squared sums included.

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
    n3d = torch.clamp_min(torch.sum(flag_3d), 1.0)
    tile = hm_gt[..., None] * flag_3d.reshape(-1, 1, 1, 1, 1)     # (N, 32, 32, 21, 1)
    dm_loss = torch.sqrt(torch.sum(((preds["d_map"] - dm_gt) * tile) ** 2)) / n3d
    lm_loss = torch.sqrt(torch.sum(((preds["l_map"] - lm_gt) * tile) ** 2)) / n3d

    total = lambda_hm * hm_loss + lambda_dm * dm_loss + lambda_lm * lm_loss
    return total, {"det_hm": hm_loss, "det_dm": dm_loss, "det_lm": lm_loss,
                   "det_total": total}
