"""Dense NT-Xent losses, single device (counterpart of
``simhand_tpu/losses/contrastive.py``): the route that autograd
differentiates.

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


def _negatives(cov: torch.Tensor) -> torch.Tensor:
    """Row sums of exp(cov) with the self pair masked out."""
    sim = torch.exp(cov)
    diag = torch.eye(cov.shape[0], dtype=torch.bool, device=cov.device)
    return torch.sum(torch.where(diag, 0.0, sim), dim=-1)


def _loss(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    pos = torch.cat([pos, pos], dim=0)
    return torch.mean(-torch.log(pos / neg))


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent over the batch; z1, z2 are (B, D) L2-normalised."""
    z = torch.cat([z1, z2], dim=0)
    neg = _negatives((z @ z.T) / temperature)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) / temperature)
    return _loss(pos, neg)


def weighted_nt_xent(z1, z2, pos_weights, neg_weights, temperature: float = 0.5):
    """NT-Xent with adaptive positive (B,) and negative (2B, 2B) weights."""
    z = torch.cat([z1, z2], dim=0)
    neg = _negatives((z @ z.T) * neg_weights / temperature)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) * pos_weights / temperature)
    return _loss(pos, neg)


def pos_weighted_nt_xent(z1, z2, pos_weights, temperature: float = 0.5):
    """NT-Xent with positive-pair weights only (``pos_neg="pos"``)."""
    z = torch.cat([z1, z2], dim=0)
    neg = _negatives((z @ z.T) / temperature)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) * pos_weights / temperature)
    return _loss(pos, neg)


def neg_weighted_nt_xent(z1, z2, neg_weights, temperature: float = 0.5):
    """NT-Xent with negative-matrix weights only (``pos_neg="neg"``)."""
    z = torch.cat([z1, z2], dim=0)
    neg = _negatives((z @ z.T) * neg_weights / temperature)
    pos = torch.exp(torch.sum(z1 * z2, dim=-1) / temperature)
    return _loss(pos, neg)
