"""Batch MANO shape fitting: PSO vs LM vs ShapeNet comparison (the
JAX package's ``finetune/optimize_shape.py``).

Reference: minimal-hand/optimize_shape.py + dl_shape_estimate.py — fits
betas to a set of relative-bone-length targets with each method and
reports the bone-length reconstruction error (align_bone_len). MANO, the
fitters' costs and ShapeNet run on the card unless ``--device cpu``.

  python -m simhand_tpu_torch.finetune.optimize_shape \\
      --mano mano/models/MANO_RIGHT.pkl --n 32 [--shapenet shape_net.pt]

The dl_shape_estimate workflow (minimal-hand/dl_shape_estimate.py:26-60)
regresses betas from PREDICTED joints instead of synthetic targets:

  python -m simhand_tpu_torch.finetune.optimize_shape \\
      --mano MANO_RIGHT.pkl --shapenet shape_net.pt \\
      --pre_joints out_testset/stb_pre_joints.npy --out_beta stb_dl.npy

``--shapenet`` takes the port's file (train_shape_net.py's ``--out``) or
the JAX package's flax msgpack.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, device=None):
    """Runs one mode; returns what it printed as a dict (the betas too)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mano", required=True)
    p.add_argument("--n", type=int, default=32, help="number of synthetic targets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shapenet", default=None,
                   help="trained ShapeNet (the port's .pt or a flax msgpack)")
    p.add_argument("--pre_joints", default=None,
                   help="npy of (N, 21, 3) predicted freihand-order joints: "
                        "run the dl_shape_estimate regression instead of "
                        "the synthetic comparison (requires --shapenet)")
    p.add_argument("--out_beta", default=None,
                   help="with --pre_joints: save the regressed (N, 10) "
                        "betas here (the reference's <data>_dl.npy)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    from simhand_tpu_torch.device import resolve_device

    dev = resolve_device(device or args.device)
    if args.pre_joints:
        if not args.shapenet:
            p.error("--pre_joints requires --shapenet")
        return _dl_shape_estimate(args, dev)
    return _synthetic_comparison(args, dev)


def _bones_of(mano, betas: np.ndarray) -> np.ndarray:
    from simhand_tpu_torch.finetune.mano import relative_bone_lengths

    with torch.no_grad():
        b = torch.from_numpy(np.array(betas, np.float32)).to(mano.device)
        return relative_bone_lengths(mano, b).cpu().numpy()


def _regress(model, bones: np.ndarray, dev) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(np.array(bones, np.float32)).to(dev)).cpu().numpy()


def _dl_shape_estimate(args, dev) -> dict:
    """Predicted joints -> ShapeNet betas + bone-length regression error
    (reference: dl_shape_estimate.py:26-60 — load <data>_pre_joints.npy,
    cal_ref_bone, model(x)['beta'], save <data>_dl.npy, report err)."""
    from simhand_tpu_torch.finetune.lm_fit import align_bone_len_ratio, ref_bones_from_joints
    from simhand_tpu_torch.finetune.mano import ManoModel
    from simhand_tpu_torch.finetune.shape_net import load_shape_net

    joints = np.load(args.pre_joints)
    if joints.ndim != 3 or joints.shape[1:] != (21, 3):
        raise ValueError(f"--pre_joints must hold (N, 21, 3) joints, not {joints.shape}")
    bones = ref_bones_from_joints(joints)

    beta = _regress(load_shape_net(args.shapenet, dev), bones, dev)
    if args.out_beta:
        np.save(args.out_beta, beta)
        print(f"saved betas: {args.out_beta}")

    mano = ManoModel(args.mano, device=dev)
    err = align_bone_len_ratio(_bones_of(mano, beta), bones)
    print(f"dl regression error (sum per-bone MAE): {err.sum():.5f}")
    print("per-bone:", np.array2string(err, precision=4))
    return {"beta": beta, "per_bone": err}


def _synthetic_comparison(args, dev) -> dict:
    """PSO vs LM vs ShapeNet on synthetic targets (optimize_shape.py)."""
    from simhand_tpu_torch.finetune.lm_fit import align_bone_len, lm_fit_shape
    from simhand_tpu_torch.finetune.mano import ManoModel
    from simhand_tpu_torch.finetune.shape_net import (
        load_shape_net,
        pso_fit_shape,
        sample_shape_dataset,
    )

    mano = ManoModel(args.mano, device=dev)
    targets, _ = sample_shape_dataset(mano, args.n, seed=args.seed)

    def recon_err(betas):
        return align_bone_len(_bones_of(mano, betas), targets)

    out = {}
    out["pso_beta"] = np.stack([
        pso_fit_shape(mano, t, n_particles=80, n_iters=25, seed=i)
        for i, t in enumerate(targets)
    ])
    out["pso_mae"] = recon_err(out["pso_beta"])
    print(f"PSO   bone-length MAE: {out['pso_mae']:.5f}")

    out["lm_beta"] = np.stack([lm_fit_shape(mano, t)[0] for t in targets])
    out["lm_mae"] = recon_err(out["lm_beta"])
    print(f"LM    bone-length MAE: {out['lm_mae']:.5f}")

    if args.shapenet:
        out["shapenet_beta"] = _regress(load_shape_net(args.shapenet, dev), targets, dev)
        out["shapenet_mae"] = recon_err(out["shapenet_beta"])
        print(f"ShapeNet bone-length MAE: {out['shapenet_mae']:.5f}")
    out["targets"] = targets
    return out


if __name__ == "__main__":
    main()
