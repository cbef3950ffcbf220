"""Distance-adaptive contrastive weights (counterpart of
``simhand_tpu/losses/weights.py``).

min, max and mean are statistics of the global batch: with an ``axis``
(``parallel.mesh``) they are pmin / pmax / pmean over the ranks, the
columns of the negative weights are all-gathered (this rank's rows
against the global columns), and PCA takes its basis from the psum of the
second moments. Pairwise distances accumulate joint by joint, so the peak
intermediate is one (rows, cols) plane and not a (rows, cols, 21, 2)
broadcast.
"""
from __future__ import annotations

import torch

DIFF_TYPES = ("w_o_abs", "w_abs", "mpjpe")


def _pair_distance(j1: torch.Tensor, j2: torch.Tensor, diff_type: str) -> torch.Tensor:
    """Per-sample distance between paired joint sets (B, 21, 2) -> (B,)."""
    if diff_type == "w_o_abs":
        return torch.linalg.vector_norm(torch.mean(j1 - j2, dim=1), dim=1)
    if diff_type == "w_abs":
        return torch.linalg.vector_norm(torch.mean(torch.abs(j1 - j2), dim=1), dim=1)
    if diff_type == "mpjpe":
        return torch.mean(torch.linalg.vector_norm(j1 - j2, dim=-1), dim=1)
    raise ValueError(f"unknown diff_type {diff_type!r}")


def _pair_distance_flat(j1: torch.Tensor, j2: torch.Tensor, diff_type: str) -> torch.Tensor:
    """Distances between PCA-reduced vectors (B, q) -> (B,); all three types
    reduce to a euclidean norm."""
    if diff_type not in DIFF_TYPES:
        raise ValueError(f"unknown diff_type {diff_type!r}")
    return torch.linalg.vector_norm(j1 - j2, dim=1)


def _pairwise_matrix(rows: torch.Tensor, cols: torch.Tensor, diff_type: str) -> torch.Tensor:
    """(R, 21, 2) x (C, 21, 2) -> (R, C) pairwise distance matrix."""
    n_joints = rows.shape[1]
    acc = rows.new_zeros((rows.shape[0], cols.shape[0]))
    if diff_type == "w_o_abs":
        # the mean over coordinates is linear: reduce to (R, 21) / (C, 21)
        # first, then accumulate exact squared differences (the
        # |u|^2 + |v|^2 - 2uv matmul loses ~1e-3 to float32 cancellation)
        u, v = rows.mean(dim=-1), cols.mean(dim=-1)
        for j in range(n_joints):
            d = u[:, j, None] - v[None, :, j]
            acc = acc + d * d
        return torch.sqrt(acc)
    if diff_type == "w_abs":
        for j in range(n_joints):
            dx = torch.abs(rows[:, j, 0, None] - cols[None, :, j, 0])
            dy = torch.abs(rows[:, j, 1, None] - cols[None, :, j, 1])
            t = 0.5 * (dx + dy)
            acc = acc + t * t
        return torch.sqrt(acc)
    if diff_type == "mpjpe":
        for j in range(n_joints):
            dx = rows[:, j, 0, None] - cols[None, :, j, 0]
            dy = rows[:, j, 1, None] - cols[None, :, j, 1]
            acc = acc + torch.sqrt(dx * dx + dy * dy)
        return acc / n_joints
    raise ValueError(f"unknown diff_type {diff_type!r}")


def _pairwise_matrix_flat(rows: torch.Tensor, cols: torch.Tensor, diff_type: str) -> torch.Tensor:
    """(R, q) x (C, q) -> (R, C) euclidean distances of PCA-reduced vectors,
    accumulated dimension by dimension."""
    if diff_type not in DIFF_TYPES:
        raise ValueError(f"unknown diff_type {diff_type!r}")
    acc = rows.new_zeros((rows.shape[0], cols.shape[0]))
    for j in range(rows.shape[1]):
        d = rows[:, j, None] - cols[None, :, j]
        acc = acc + d * d
    return torch.sqrt(acc)


def _gmin(x: torch.Tensor, axis) -> torch.Tensor:
    m = x.min()
    return m if axis is None else axis.pmin(m)


def _gmax(x: torch.Tensor, axis) -> torch.Tensor:
    m = x.max()
    return m if axis is None else axis.pmax(m)


def _gmean(x: torch.Tensor, axis) -> torch.Tensor:
    m = x.mean()
    return m if axis is None else axis.pmean(m)


def _gather_rows_cols(j1: torch.Tensor, j2: torch.Tensor, axis):
    """Local rows [j1; j2] and global columns [j1_all; j2_all]."""
    local = torch.cat([j1, j2], dim=0)
    if axis is None:
        return local, local
    return local, torch.cat([axis.all_gather(j1), axis.all_gather(j2)], dim=0)


def linear_weights(
    joints1: torch.Tensor,
    joints2: torch.Tensor,
    diff_type: str = "mpjpe",
    axis=None,
    flat: bool = False,
):
    """Min/max-normalised, inverted adaptive weights.

    joints: (B, 21, 2) of this rank, or (B, q) when ``flat`` (PCA-reduced).
    Returns pos_weights (B,) and neg_weights (2B, 2N).
    """
    pdist = _pair_distance_flat if flat else _pair_distance
    pmat = _pairwise_matrix_flat if flat else _pairwise_matrix

    pos_d = pdist(joints1, joints2, diff_type)
    pos_max, pos_min = _gmax(pos_d, axis), _gmin(pos_d, axis)
    pos_w = (pos_max - pos_d) / (pos_max - pos_min)

    rows, cols = _gather_rows_cols(joints1, joints2, axis)
    neg_d = pmat(rows, cols, diff_type)
    neg_max, neg_min = _gmax(neg_d, axis), _gmin(neg_d, axis)
    neg_w = (neg_max - neg_d) / (neg_max - neg_min)
    return pos_w, neg_w


def nonlinear_weights(
    joints1: torch.Tensor,
    joints2: torch.Tensor,
    lambda_pos: float,
    lambda_neg: float,
    diff_type: str = "mpjpe",
    axis=None,
    flat: bool = False,
):
    """Sigmoid adaptive weights: 1/(1+exp(lambda*(d - mean(d))))."""
    pdist = _pair_distance_flat if flat else _pair_distance
    pmat = _pairwise_matrix_flat if flat else _pairwise_matrix

    pos_d = pdist(joints1, joints2, diff_type)
    pos_w = 1.0 / (1.0 + torch.exp(lambda_pos * (pos_d - _gmean(pos_d, axis))))

    rows, cols = _gather_rows_cols(joints1, joints2, axis)
    neg_d = pmat(rows, cols, diff_type)
    neg_w = 1.0 / (1.0 + torch.exp(lambda_neg * (neg_d - _gmean(neg_d, axis))))
    return pos_w, neg_w


def apply_pca(joints: torch.Tensor, target_dim: int = 14, axis=None) -> torch.Tensor:
    """Projects (B, 21, 2) joints onto the top principal axes -> (B, q).

    The directions come from the centred data, but the uncentred joints are
    projected. An exact eigendecomposition of the 42x42 second moment, with
    the largest-magnitude component of each axis made positive. With an
    axis, the mean is a pmean and the second moment and count psums, so
    every rank projects onto the same global basis.
    """
    b = joints.shape[0]
    x = joints.reshape(b, -1).to(torch.float32)
    mean = x.mean(dim=0)
    if axis is not None:
        mean = axis.pmean(mean)
    xc = x - mean
    cov = xc.T @ xc
    n = torch.tensor(float(b), device=x.device)
    if axis is not None:
        cov, n = axis.psum(cov), axis.psum(n)
    cov = cov / n
    _, vecs = torch.linalg.eigh(cov)
    v = vecs.flip(-1)[:, :target_dim]
    idx = torch.argmax(torch.abs(v), dim=0)
    signs = torch.sign(v[idx, torch.arange(target_dim, device=v.device)])
    return x @ (v * signs[None, :])


def pairwise_minmax(joints: torch.Tensor, diff_type: str = "mpjpe", chunk: int = 2048,
                    axis=None):
    """(min, max) of the pairwise distance matrix, as tensors on the
    joints' device, without holding more than one (rows, chunk) plane.

    joints: (N, 21, 2) rows of this rank. With an axis the columns are the
    all-gathered global set (the ranks' rows against them cover every pair
    once) and the extrema are pmin / pmax over the ranks."""
    cols = joints if axis is None else axis.all_gather(joints)
    d_min = d_max = None
    for start in range(0, cols.shape[0], chunk):
        d = _pairwise_matrix(joints, cols[start:start + chunk], diff_type)
        lo, hi = d.min(), d.max()
        d_min = lo if d_min is None else torch.minimum(d_min, lo)
        d_max = hi if d_max is None else torch.maximum(d_max, hi)
    if axis is not None:
        d_min, d_max = axis.pmin(d_min), axis.pmax(d_max)
    return d_min, d_max
