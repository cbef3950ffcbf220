"""Dense NT-Xent losses (counterpart of ``simhand_tpu/losses/contrastive.py``):
the route that autograd differentiates.

With an ``axis`` (``parallel.mesh``) each rank holds its rows of the
global batch: the projections are all-gathered, each rank computes its
row shard of the (2N, 2N) similarity matrix against the global columns,
and the mean over rows is a ``pmean``. The global rows are ordered
[z1_rank0; z1_rank1; ...; z2_rank0; ...], as ``cat([z1, z2])`` is on one
device. Autograd through the axis's collectives gives each rank the
gradient of the sum of the ranks' losses, W times the global gradient, as
JAX's ``shard_map`` does.

Quirks of the reference kept on purpose:
  * only the self-similarity diagonal leaves the denominator: the positive
    pair stays in the negative sum;
  * in the weighted variants the negative weights multiply the whole
    covariance matrix before the exp (positives included).

The similarity matmul is float32 at full precision: callers on the card
keep ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default).
"""
from __future__ import annotations

import torch


def _row_col_ids(n_local: int, axis, device):
    """Global ids of the local [z1; z2] rows and of all global columns."""
    if axis is None:
        rows = torch.arange(2 * n_local, device=device)
        return rows, rows
    n_global = n_local * axis.size
    local = torch.arange(n_local, device=device) + axis.index * n_local
    return torch.cat([local, local + n_global]), torch.arange(2 * n_global, device=device)


def _gather_z(z1: torch.Tensor, z2: torch.Tensor, axis):
    """Local rows (2B, D) and global columns (2N, D) of the z matrix."""
    z_local = torch.cat([z1, z2], dim=0)
    if axis is None:
        return z_local, z_local
    return z_local, torch.cat([axis.all_gather(z1), axis.all_gather(z2)], dim=0)


def _negatives(cov: torch.Tensor, n_local: int, axis) -> torch.Tensor:
    """Row sums of exp(cov) with the self pair masked out."""
    rows, cols = _row_col_ids(n_local, axis, cov.device)
    diag = rows[:, None] == cols[None, :]
    return torch.sum(torch.where(diag, 0.0, torch.exp(cov)), dim=-1)


def _loss(pos: torch.Tensor, neg: torch.Tensor, axis) -> torch.Tensor:
    pos = torch.cat([pos, pos], dim=0)
    m = torch.mean(-torch.log(pos / neg))
    return m if axis is None else axis.pmean(m)


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.5,
            axis=None) -> torch.Tensor:
    """SimCLR NT-Xent over the (global) batch; z1, z2 are (B, D)
    L2-normalised rows of this rank."""
    z, cols = _gather_z(z1, z2, axis)
    neg = _negatives((z @ cols.T) / temperature, z1.shape[0], axis)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) / temperature)
    return _loss(pos, neg, axis)


def weighted_nt_xent(z1, z2, pos_weights, neg_weights, temperature: float = 0.5,
                     axis=None):
    """NT-Xent with adaptive positive (B,) and negative (2B, 2N) weights:
    the negative weights are this rank's rows against the global columns."""
    z, cols = _gather_z(z1, z2, axis)
    neg = _negatives((z @ cols.T) * neg_weights / temperature, z1.shape[0], axis)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) * pos_weights / temperature)
    return _loss(pos, neg, axis)


def pos_weighted_nt_xent(z1, z2, pos_weights, temperature: float = 0.5, axis=None):
    """NT-Xent with positive-pair weights only (``pos_neg="pos"``)."""
    z, cols = _gather_z(z1, z2, axis)
    neg = _negatives((z @ cols.T) / temperature, z1.shape[0], axis)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) * pos_weights / temperature)
    return _loss(pos, neg, axis)


def neg_weighted_nt_xent(z1, z2, neg_weights, temperature: float = 0.5, axis=None):
    """NT-Xent with negative-matrix weights only (``pos_neg="neg"``)."""
    z, cols = _gather_z(z1, z2, axis)
    neg = _negatives((z @ cols.T) * neg_weights / temperature, z1.shape[0], axis)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) / temperature)
    return _loss(pos, neg, axis)
