"""MANO reconstruction evaluation: detnet joints -> shape fit -> AIK ->
MANO forward -> reconstruction EPE (the JAX package's ``finetune/recon.py``).

Reference: minimal-hand/aik_pose.py (:13-60) and dl_shape_estimate.py —
compares the analytic-IK + MANO reconstruction against the detnet joint
predictions themselves. The MANO forward runs on the model's device, AIK
and the metric on the host.

  python -m simhand_tpu_torch.finetune.recon --mano MANO_RIGHT.pkl --n 8
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from simhand_tpu_torch.core.joints import JointMap
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.finetune.aik import adaptive_ik
from simhand_tpu_torch.finetune.evaluation import EvalUtil
from simhand_tpu_torch.finetune.mano import ManoModel
from simhand_tpu_torch.finetune.shape_net import pso_fit_shape

_JM = JointMap()


def _identity_pose(mano: ManoModel) -> torch.Tensor:
    return torch.eye(3, device=mano.device).expand(1, 16, 3, 3)


def reconstruct(
    mano: ManoModel,
    joints_fh: np.ndarray,
    beta: np.ndarray | None = None,
    rel_bones: np.ndarray | None = None,
):
    """One hand: predicted joints -> (verts, joints21, pose_R, beta) via
    AIK + MANO.

    Args:
      joints_fh: (21, 3) predicted joints, freihand/snap order (detnet
        output order), root-relative/scale-normalized or metric — AIK is
        scale-equivariant through the template normalization.
      beta: optional precomputed MANO shape; fitted via PSO if absent.
    """
    joints_fh = np.asarray(joints_fh, np.float64)

    if beta is None:
        if rel_bones is None:
            # relative bone lengths from the prediction itself
            joints_mano = _JM.freihand_to_mano(joints_fh)
            parent = [0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14]
            j16 = joints_mano[:16]
            rel = j16 - j16[parent]
            ref = np.linalg.norm(j16[4] - j16[0]) + 1e-9
            lengths = np.linalg.norm(rel, axis=-1) / ref
            reorder = [13, 14, 15, 1, 2, 3, 4, 5, 6, 10, 11, 12, 7, 8, 9]
            rel_bones = lengths[reorder]
        beta = pso_fit_shape(mano, rel_bones, n_particles=60, n_iters=20)

    beta_t = torch.from_numpy(np.array(beta, np.float32)).to(mano.device)[None]
    with torch.no_grad():
        _, template21 = mano(_identity_pose(mano), beta_t)
    # the IK runs entirely in freihand/snap order: aik.py's SNAP_PARENT/
    # KINEMATIC_TREE/ID2ROT/mcp tables are snap-ordered (the reference
    # feeds manopth joints, which manolayer emits in snap order) —
    # MANO-native ordering scrambles the chain (~30x worse recon error)
    template = _JM.mano_to_freihand(template21[0].cpu().numpy())

    # scale-match prediction to the template skeleton (ref bone: wrist ->
    # middle_mcp, snap indices 0/9)
    ref_pred = np.linalg.norm(joints_fh[9] - joints_fh[0]) + 1e-9
    ref_temp = np.linalg.norm(template[9] - template[0])
    target = (joints_fh - joints_fh[0]) * (ref_temp / ref_pred) + template[0]

    pose_R = adaptive_ik(template, target)
    with torch.no_grad():
        verts, joints21 = mano(torch.as_tensor(pose_R, dtype=torch.float32).to(mano.device),
                               beta_t)
    return verts[0].cpu().numpy(), joints21[0].cpu().numpy(), pose_R, beta


def recon_epe(mano: ManoModel, predictions_fh: np.ndarray) -> dict:
    """Reconstruction EPE over a batch of predictions (aik_pose.py)."""
    evaluator = EvalUtil()
    for joints in predictions_fh:
        _, rec, _, _ = reconstruct(mano, joints)
        rec_fh = _JM.mano_to_freihand(rec)
        # compare in the prediction's normalized frame
        ref_pred = np.linalg.norm(
            _JM.freihand_to_mano(joints)[4] - _JM.freihand_to_mano(joints)[0]
        ) + 1e-9
        target = _JM.mano_to_freihand(
            (_JM.freihand_to_mano(joints) - _JM.freihand_to_mano(joints)[0])
        ) / ref_pred
        rec_norm = _JM.mano_to_freihand(
            (_JM.freihand_to_mano(rec_fh) - _JM.freihand_to_mano(rec_fh)[0])
        )
        ref_rec = np.linalg.norm(
            _JM.freihand_to_mano(rec_fh)[4] - _JM.freihand_to_mano(rec_fh)[0]
        ) + 1e-9
        evaluator.feed(target, rec_norm / ref_rec)
    epe_mean, _, epe_median, auc, _, _ = evaluator.get_measures(0.0, 0.05, 20)
    return {"recon_epe_mean": epe_mean, "recon_epe_median": epe_median,
            "recon_auc": auc}


def main(argv=None, device=None):
    """CLI: reconstruction EPE over random or provided predictions
    (reference: minimal-hand/aik_pose.py). Returns the metrics it prints."""
    p = argparse.ArgumentParser()
    p.add_argument("--mano", required=True)
    p.add_argument("--predictions", default=None,
                   help="npy of (N, 21, 3) freihand-order joints; random if absent")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    mano = ManoModel(args.mano, device=resolve_device(device or args.device))
    if args.predictions:
        preds = np.load(args.predictions)
    else:
        with torch.no_grad():
            _, base = mano(_identity_pose(mano), torch.zeros((1, 10), device=mano.device))
        base = _JM.mano_to_freihand(base[0].cpu().numpy())
        rng = np.random.default_rng(0)
        preds = base[None] + rng.normal(scale=0.002, size=(args.n, 21, 3))
    metrics = recon_epe(mano, preds)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
