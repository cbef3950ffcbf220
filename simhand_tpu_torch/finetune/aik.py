"""Analytic inverse kinematics: 21 predicted joints -> 16 MANO rotations
(a copy of the JAX package's ``finetune/aik.py``, the same numpy float64
arithmetic on the host).

Reference: minimal-hand/utils/AIK.py (after Arun et al. 1987 for the
global rotation, swing-only decomposition down the kinematic chain —
bone twist is assumed zero). numpy host-side, matching the reference's
CPU execution in the demo loop; no transforms3d dependency (Rodrigues
formula inlined).
"""
from __future__ import annotations

import numpy as np

SNAP_PARENT = [
    0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19
]
KINEMATIC_TREE = [2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20]
ID2ROT = {
    2: 13, 3: 14, 4: 15,
    6: 1, 7: 2, 8: 3,
    10: 4, 11: 5, 12: 6,
    14: 10, 15: 11, 16: 12,
    18: 7, 19: 8, 20: 9,
}


def axangle2mat(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix (axis need not be normalized)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(3)
    x, y, z = axis / n
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def adaptive_ik(template: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Pose parameters from a template skeleton and predicted joints.

    Args:
      template: (21, 3) rest-pose joints in FREIHAND/SNAP order (wrist,
        then thumb..pinky mcp/pip/dip/tip) — the order SNAP_PARENT /
        KINEMATIC_TREE / ID2ROT / the mcp list index into (the reference
        feeds manopth joints, which manolayer reorders to snap). A
        MANO-native-ordered input scrambles the kinematic chain.
      target: (21, 3) predicted joints, same order/scale-normalization.

    Returns:
      (1, 16, 3, 3) rotation matrices (global root + 15 relative),
      MANO parameter order — feed straight into ManoModel.
    """
    T = template.astype(np.float64).T  # (3, 21)
    P = target.astype(np.float64).T

    R: dict[int, np.ndarray] = {}
    R_pa_k: dict[int, np.ndarray] = {}
    q: dict[int, np.ndarray] = {0: T[:, [0]]}

    # global rotation from the 5 MCP directions (Arun et al.)
    mcp = [1, 5, 9, 13, 17]
    P0 = np.concatenate([P[:, [m]] - P[:, [0]] for m in mcp], axis=-1)
    T0 = np.concatenate([T[:, [m]] - T[:, [0]] for m in mcp], axis=-1)
    H = T0 @ P0.T
    U, S, Vt = np.linalg.svd(H)
    V = Vt.T
    R0 = V @ U.T
    if abs(np.linalg.det(R0) + 1) < 1e-6 and (np.abs(S) < 1e-4).sum():
        V = V.copy()
        V[:, 2] = -V[:, 2]
        R0 = V @ U.T
    for j in [0] + mcp:
        R[j] = R0.copy()

    for k in KINEMATIC_TREE:
        pa = SNAP_PARENT[k]
        pa_pa = SNAP_PARENT[pa]
        q[pa] = R[pa] @ (T[:, [pa]] - T[:, [pa_pa]]) + q[pa_pa]
        delta_p = (np.linalg.inv(R[pa]) @ (P[:, [k]] - q[pa])).reshape(3)
        delta_t = (T[:, [k]] - T[:, [pa]]).reshape(3)
        axis = np.cross(delta_t, delta_p)
        axis = axis / (np.linalg.norm(axis) + 1e-8)
        denom = (np.linalg.norm(delta_t) + 1e-8) * (np.linalg.norm(delta_p) + 1e-8)
        cos_a = np.clip(np.dot(delta_t, delta_p) / denom, -1.0, 1.0)
        R_pa_k[k] = axangle2mat(axis, np.arccos(cos_a))
        R[k] = R[pa] @ R_pa_k[k]

    pose_R = np.zeros((1, 16, 3, 3))
    pose_R[0, 0] = R[0]
    for k, value in ID2ROT.items():
        pose_R[0, value] = R_pa_k[k]
    return pose_R
