"""Evaluation: EPE / PCK / AUC and batched Procrustes alignment
(counterpart of ``simhand_tpu/finetune/evaluation.py``, in numpy; the
Procrustes alignment in float64).

Replicates both reference evaluators:
  * minimal-hand's EvalUtil (utils/eval/zimeval.py) — per-joint distance
    store -> EPE mean/median, PCK curve, trapezoid AUC;
  * src/experiments/evaluation_utils.py — PCK curves on thresholds
    0..0.5 step 0.005, per-joint AUC, batched SVD Procrustes.

Vectorized numpy, no per-sample Python loops.
"""
from __future__ import annotations

import numpy as np

# np.trapz was renamed to trapezoid in numpy 2; support both
_trapz = getattr(np, "trapezoid", None) or np.trapz


class EvalUtil:
    """Accumulates per-joint euclidean distances; reference-shaped output."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self._dists: list[np.ndarray] = []
        self._vis: list[np.ndarray] = []

    def feed(self, keypoint_gt, keypoint_pred, keypoint_vis=None):
        gt = np.asarray(keypoint_gt, np.float64)
        pr = np.asarray(keypoint_pred, np.float64)
        if gt.ndim == 2:
            gt, pr = gt[None], pr[None]
        if keypoint_vis is None:
            vis = np.ones(gt.shape[:2], bool)
        else:
            vis = np.asarray(keypoint_vis).astype(bool).reshape(gt.shape[:2])
        d = np.sqrt(np.sum((gt - pr) ** 2, axis=-1))
        self._dists.append(d)
        self._vis.append(vis)

    def _stacked(self):
        return np.concatenate(self._dists), np.concatenate(self._vis)

    def get_measures(self, val_min: float, val_max: float, steps: int):
        """(epe_mean_all, epe_mean_joint, epe_median_all, auc_all,
        pck_curve_all, thresholds) — zimeval.py:90-139 contract."""
        d, vis = self._stacked()
        thresholds = np.linspace(val_min, val_max, steps)
        norm = _trapz(np.ones_like(thresholds), thresholds)

        epe_mean_joint, epe_median, aucs, pcks = [], [], [], []
        for k in range(self.num_kp):
            dk = d[:, k][vis[:, k]]
            if dk.size == 0:
                continue
            epe_mean_joint.append(dk.mean())
            epe_median.append(np.median(dk))
            curve = np.stack([(dk <= t).mean() for t in thresholds])
            pcks.append(curve)
            aucs.append(_trapz(curve, thresholds) / norm)
        return (
            float(np.mean(epe_mean_joint)),
            epe_mean_joint,
            float(np.mean(epe_median)),
            float(np.mean(aucs)),
            np.mean(np.stack(pcks), axis=0),
            thresholds,
        )


def epe_statistics(pred: np.ndarray, gt: np.ndarray, dim: int = 3) -> dict:
    """Mean/median EPE over (N, 21, dim) joints."""
    d = np.sqrt(np.sum((pred[..., :dim] - gt[..., :dim]) ** 2, axis=-1))
    return {
        "mean": float(d.mean()),
        "median": float(np.median(d)),
        "eucledian_dist": d,
    }


def pck_curve(
    dists: np.ndarray,
    threshold_min: float = 0.0,
    threshold_max: float = 0.5,
    step: float = 0.005,
    per_joint: bool = False,
):
    """PCK over a threshold sweep (evaluation_utils.py:230-270: strict <)."""
    thresholds = np.arange(threshold_min, threshold_max, step)
    under = dists[None, ...] < thresholds.reshape(-1, *([1] * dists.ndim))
    if per_joint:
        curve = under.mean(axis=1).T  # (21, T)
    else:
        curve = under.reshape(len(thresholds), -1).mean(axis=1)
    return curve, thresholds


def auc_joints(dists: np.ndarray, per_joint: bool = True):
    """AUC of the 0..0.5/0.005 PCK curve (evaluation_utils.py:273-301)."""
    curves, thresholds = pck_curve(dists, 0.0, 0.5, 0.005, per_joint=True)
    norm = _trapz(np.ones(len(thresholds)), thresholds)
    auc = _trapz(curves, thresholds, axis=-1) / norm
    return auc if per_joint else float(auc.mean())


def procrustes_align(X, Y):
    """Batched similarity-transform alignment of Y onto X, in float64.

    minimizes ||s * Y @ R + t - X||_F (evaluation_utils.py:304-351).

    Args:
      X: (B, N, 3) targets; Y: (B, N, 3) points to align.

    Returns:
      (Y_aligned, R, scale, translation)
    """
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    muX = X.mean(axis=1, keepdims=True)
    muY = Y.mean(axis=1, keepdims=True)
    X0, Y0 = X - muX, Y - muY
    normX = np.linalg.norm(X0, axis=(1, 2), keepdims=True)
    normY = np.linalg.norm(Y0, axis=(1, 2), keepdims=True)
    X0n, Y0n = X0 / normX, Y0 / normY

    A = np.einsum("bnp,bnk->bpk", X0n, Y0n)
    U, s, Vt = np.linalg.svd(A)
    V = np.swapaxes(Vt, 1, 2).copy()
    det = np.linalg.det(np.einsum("bik,bjk->bij", V, U))
    sign = np.sign(det)[:, None]
    V[:, :, -1] *= sign
    s = s.copy()
    s[:, -1] *= sign[:, 0]
    R = np.einsum("bik,bjk->bij", V, U)

    scale_ratio = s.sum(axis=1).reshape(-1, 1, 1)
    scale = scale_ratio * normX / normY
    translation = muX - scale * np.einsum("bnk,bkp->bnp", muY, R)
    Y_aligned = normX * scale_ratio * np.einsum("bnk,bkp->bnp", Y0n, R) + muX
    return Y_aligned, R, scale, translation


def global_align(gtj: np.ndarray, prj: np.ndarray, key: str):
    """The reference's eval-time global alignment (utils/align.py:4-57).

    3D sets (stb/rhd/ah-ego/ah-exo/fh/dy and aliases): shift the prediction
    to the gt wrist (root 0) and rescale by the wrist->middle_mcp reference
    bone (0, 9). Returns (gt (B,21,3), pred_aligned (B,21,3)).

    Tip-only sets (do/eo): the prediction's 5 fingertips [4,8,12,16,20] are
    aligned to the valid (non-NaN) gt tips by matching their centroids and
    mean center-distance scale; samples with <2 valid tips are dropped.
    Returns ragged lists (gt_valid, pred_valid_aligned) flattened to
    (sum_m, 3) arrays plus a per-sample count, matching the reference's
    masked semantics.
    """
    gtj = np.asarray(gtj, np.float64)
    prj = np.asarray(prj, np.float64)
    if key in ("do", "eo", "dexter_object", "egodexter"):
        tips = prj[:, [4, 8, 12, 16, 20], :]
        gt_out, pred_out, counts = [], [], []
        for i in range(tips.shape[0]):
            mask = ~np.isnan(gtj[i][:, 0])
            if mask.sum() < 2:
                continue
            p, g = tips[i][mask], gtj[i][mask]
            gc, pc = g.mean(0), p.mean(0)
            scale = (
                np.linalg.norm(g - gc, axis=1).mean()
                / max(np.linalg.norm(p - pc, axis=1).mean(), 1e-12)
            )
            gt_out.append(g)
            pred_out.append(gc + scale * (p - pc))
            counts.append(int(mask.sum()))
        if not gt_out:
            return (np.zeros((0, 3)), np.zeros((0, 3)), [])
        return np.concatenate(gt_out), np.concatenate(pred_out), counts

    # 21-joint 3D sets: root 0, ref bone (0, 9) — align.py:12-25
    root, (a, b) = 0, (0, 9)
    pred_len = np.linalg.norm(prj[:, a] - prj[:, b], axis=-1, keepdims=True)
    gt_len = np.linalg.norm(gtj[:, a] - gtj[:, b], axis=-1, keepdims=True)
    scale = (gt_len / np.maximum(pred_len, 1e-12))[:, :, None]
    aligned = gtj[:, root : root + 1] + scale * (prj - prj[:, root : root + 1])
    return gtj, aligned


class AverageMeter:
    """Running mean meter (reference: utils/eval/evalutils.py:10-26)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def _heatmap_dists(pred_hm: np.ndarray, gt_hm: np.ndarray,
                   veil: np.ndarray):
    """Normalized argmax distances + validity mask shared by the heatmap
    metrics (the reference's calc_dists, utils/eval/evalutils.py:29-47).
    Returns (d (B, J) in units of W/10 px, valid (B, J) bool)."""
    B, H, W, J = pred_hm.shape
    norm = W / 10.0                           # reference: output.size(3)/10

    def argmax2d(hm):
        flat = hm.reshape(B, H * W, J).argmax(axis=1)
        return np.stack([flat // W, flat % W], axis=-1)  # (B, J, 2)

    p = argmax2d(pred_hm)
    g = argmax2d(gt_hm)
    d = np.linalg.norm((p - g).astype(np.float64), axis=-1) / norm
    valid = veil.astype(bool) & (g >= 1).all(axis=-1)
    return d, valid


def heatmap_pck(pred_hm: np.ndarray, gt_hm: np.ndarray, veil: np.ndarray,
                threshold: float = 0.5) -> float:
    """Heatmap-space PCK, the reference's exact protocol
    (utils/eval/evalutils.py:29-76 accuracy_heatmap/calc_dists/dist_acc):
    per-joint fraction of valid samples whose predicted argmax lies
    within ``threshold * W / 10`` pixels of the GT argmax, MACRO-averaged
    over joints with at least one valid sample. A sample-joint is
    invalid when the veil is 0 OR its GT argmax row/col < 1 (empty or
    border heatmap). Shapes: (B, H, W, J); veil (B, J)."""
    d, valid = _heatmap_dists(pred_hm, gt_hm, veil)
    J = d.shape[1]
    accs = []
    for j in range(J):
        dj = d[:, j][valid[:, j]]
        if len(dj):
            accs.append(float((dj < threshold).mean()))
    return float(np.mean(accs)) if accs else 0.0


def heatmap_metrics(pred_hm: np.ndarray, gt_hm: np.ndarray,
                    veil: np.ndarray, loose_threshold: float = 2.0) -> dict:
    """The strict reference PCK plus two signals that do NOT degenerate
    to 0.0 at miniature fine-tune budgets (round-4 VERDICT #4: every
    bn_grid / int8_quality cell read hm_pck=0.0, leaving one loss scalar
    carrying the whole quality program):

    * ``hm_pck_loose`` — PCK at ``loose_threshold`` (default 2.0 =
      within 2*W/10 px). Even a uniform-random argmax scores ~pi*(2W/10)^2
      / (H*W) ≈ 0.13 on 32x32 maps, so the column is never all-zero and
      localization progress moves it long before the strict 0.5 gate.
    * ``hm_dist`` — mean normalized argmax distance (continuous; lower
      is better), macro-averaged over joints like the PCK.
    """
    d, valid = _heatmap_dists(pred_hm, gt_hm, veil)
    J = d.shape[1]
    strict, loose, dists = [], [], []
    for j in range(J):
        dj = d[:, j][valid[:, j]]
        if len(dj):
            strict.append(float((dj < 0.5).mean()))
            loose.append(float((dj < loose_threshold).mean()))
            dists.append(float(dj.mean()))
    if not strict:
        return {"hm_pck": 0.0, "hm_pck_loose": 0.0, "hm_dist": float("nan")}
    return {
        "hm_pck": float(np.mean(strict)),
        "hm_pck_loose": float(np.mean(loose)),
        "hm_dist": float(np.mean(dists)),
    }
