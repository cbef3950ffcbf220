"""Levenberg–Marquardt MANO shape fitting (the JAX package's
``finetune/lm_fit.py``).

Alternative to the PSO fitter (reference: minimal-hand/utils/LM.py,
LM_new.py, optimize_shape.py): minimizes the relative-bone-length residual
r(beta) = bone_len(beta) - target with Tikhonov-damped Gauss-Newton steps.
The Jacobian comes from ``torch.func.jacfwd``, exact, no finite
differences; the residual and Jacobian run on the MANO model's device, the
damping schedule on the host. The bone helpers are numpy copies.
"""
from __future__ import annotations

import numpy as np
import torch

from simhand_tpu_torch.finetune.mano import ManoModel, relative_bone_lengths


def align_bone_len(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean absolute relative-bone-length error
    (reference: optimize_shape.py:10-21)."""
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(gt))))


def align_bone_len_ratio(opt: np.ndarray, pre: np.ndarray) -> np.ndarray:
    """The dl_shape_estimate variant (dl_shape_estimate.py:12-24): rescale
    ``opt`` per sample so its bone 6 matches ``pre``'s, then per-bone MAE.
    Returns the (15,) per-bone error vector (the reference sums it)."""
    opt = np.asarray(opt, np.float64).copy()
    pre = np.asarray(pre, np.float64)
    ratio = pre[:, 6:7] / np.maximum(opt[:, 6:7], 1e-12)
    return np.abs(opt * ratio - pre).mean(axis=0)


def ref_bones_from_joints(joints: np.ndarray,
                          normalize: bool = True) -> np.ndarray:
    """(B, 21, 3) freihand/snap-order joints -> (B, 15) bone lengths, the
    reference's ``cal_ref_bone`` (create_data.py:66-87): the mcp/pip/dip
    bones of each finger (tips excluded), thumb..pinky chain order —
    matching ``relative_bone_lengths``'s output order.

    Deliberate deviation: ``normalize=True`` divides by the
    wrist->middle_mcp reference bone (output bone 6), matching the
    normalized distribution ShapeNet is trained on — the reference's own
    ``/ ref_len`` line is commented out, silently feeding raw metric
    lengths into a network trained on relative ones (its ratio-aligned
    error metric hides the scale mismatch). ``normalize=False``
    reproduces the reference bytes. (Its parent table's joint-12 entry
    is a typo the excluded-index list makes unreachable.)"""
    joints = np.asarray(joints, np.float64)
    parent = [0,
              0, 1, 2, 3,
              0, 5, 6, 7,
              0, 9, 10, 8,
              0, 13, 14, 15,
              0, 17, 18, 19]
    index = [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19]
    rel = joints - joints[:, parent, :]
    bones = np.linalg.norm(rel[:, index, :], axis=-1)
    if normalize:
        bones = bones / np.maximum(bones[:, 6:7], 1e-12)
    return bones


def lm_fit_shape(
    mano: ManoModel,
    rel_bone_len: np.ndarray,
    n_iters: int = 20,
    damping: float = 1e-2,
    reg: float = 1e-3,
    beta0: np.ndarray | None = None,
):
    """Fits beta (10,) to 15 target relative bone lengths.

    Returns (beta, final cost) with cost = |r|^2 + reg |beta|^2.
    """
    dev = mano.device
    target = torch.from_numpy(np.array(rel_bone_len, np.float32)).to(dev)

    def residual(beta):
        return relative_bone_lengths(mano, beta[None])[0] - target

    jac_fn = torch.func.jacfwd(residual)

    def cost_of(beta) -> float:
        return float(torch.sum(residual(beta) ** 2) + reg * torch.sum(beta**2))

    beta = (torch.zeros(10, device=dev) if beta0 is None
            else torch.from_numpy(np.array(beta0, np.float32)).to(dev))
    eye = torch.eye(10, device=dev)
    lam = damping
    with torch.no_grad():
        prev_cost = cost_of(beta)
        for _ in range(n_iters):
            r = residual(beta)
            J = jac_fn(beta)                                   # (15, 10)
            A = J.T @ J + (lam + reg) * eye
            g = J.T @ r + reg * beta
            step = torch.linalg.solve(A, g)
            new_beta = torch.clip(beta - step, -3.0, 3.0)
            cost = cost_of(new_beta)
            if cost < prev_cost:
                beta, prev_cost = new_beta, cost
                lam = max(lam * 0.5, 1e-6)
            else:
                lam = min(lam * 4.0, 1e3)
    return beta.cpu().numpy(), prev_cost
