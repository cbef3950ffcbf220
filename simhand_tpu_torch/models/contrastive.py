"""The contrastive model family (counterpart of
``simhand_tpu/models/contrastive.py``): one encoder + head module, eight
experiment types realised as loss pipelines, on one device or, with an
``axis`` (``parallel.mesh``), on the global batch.

The route gates are the JAX package's: the kernel route needs
``use_pallas`` and, for the weighted family, the flagship
linear/mpjpe/pos_neg configuration without PCA; on one device
``2B % 512 == 0``, on an axis ``2B_local % 256 == 0`` and, for the plain
family, a global column count that is a multiple of 512. The CUDA kernels
need no divisibility; the gates stay so that both packages take the same
route for the same batch.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simhand_tpu_torch.losses.contrastive import (
    neg_weighted_nt_xent,
    nt_xent,
    pos_weighted_nt_xent,
    weighted_nt_xent,
)
from simhand_tpu_torch.losses.ntxent_kernels import (
    make_sharded_nt_xent_kernel,
    make_sharded_weighted_nt_xent_kernel,
    nt_xent_kernel,
    weighted_nt_xent_kernel,
)
from simhand_tpu_torch.losses.supervised import torch_median
from simhand_tpu_torch.losses.weights import (
    _pair_distance,
    apply_pca,
    linear_weights,
    nonlinear_weights,
    pairwise_minmax,
)
from simhand_tpu_torch.models.equivariance import (
    _l2_normalize,
    inverse_transform_projections,
)
from simhand_tpu_torch.models.layers import frozen_running_stats
from simhand_tpu_torch.models.projection import ProjectionHead
from simhand_tpu_torch.models.resnet import FEATURE_DIMS, RESNETS

EXPERIMENT_TYPES = (
    "simclr", "simclr_w", "peclr", "peclr_w", "simhand-base", "simhand",
    "simhand_w", "simhand_vis",
)
_EQUIVARIANT = {"peclr", "peclr_w", "simhand-base", "simhand", "simhand_w", "simhand_vis"}
_WEIGHTED = {"simclr_w", "peclr_w", "simhand_w"}
_FLAGSHIP_WEIGHTS = ("linear", "mpjpe", "pos_neg", False)


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """Static configuration of a contrastive experiment."""

    experiment_type: str = "simclr"
    augmentation: tuple[str, ...] = ()
    temperature: float = 0.5
    image_side: float = 128.0
    weight_type: str = "linear"               # "linear" | "non_linear"
    diff_type: str = "mpjpe"                  # "w_o_abs" | "w_abs" | "mpjpe"
    pos_neg: str = "pos_neg"                  # "pos" | "neg" | "pos_neg"
    joints_type: str = "aug"                  # "original" | "aug"
    use_pca: bool = False
    pca_dim: int = 14
    non_linear_lambda_pos: float = 5.0
    non_linear_lambda_neg: float = 0.05
    # the NT-Xent kernels (losses/ntxent_kernels.py) instead of the dense
    # route, for 2B % 512 == 0 on one device and 2B_local % 256 == 0 on an
    # axis: plain NT-Xent and the flagship weighted loss
    use_pallas: bool = False

    def __post_init__(self):
        if self.experiment_type not in EXPERIMENT_TYPES:
            raise ValueError(f"unknown experiment_type {self.experiment_type!r}")


class ContrastiveModel(nn.Module):
    """ResNet encoder + projection head (the pre-training network).

    ``forward`` takes (N, H, W, 3) images and returns (embedding,
    projection), both float32; ``train()``/``eval()`` pick the BatchNorm
    mode. ``bn_axis``, ``stem``, ``bn_fused``, ``bn_subsample``,
    ``bn_stop_gradient_stats``, ``conv1x1_fuse_min_cin`` and ``maxpool`` go
    to the encoder (``models/resnet.py``); the projection head's BatchNorm
    stays exact and per-replica, as the reference's.

    ``remat=True`` recomputes the encoder's activations in the backward
    (``torch.utils.checkpoint``, the reference's ``nn.remat``) when it
    trains with gradients on. Its BatchNorm running statistics are updated
    by the forward only, not again by the recomputation, as flax's are.
    """

    def __init__(self, resnet_size: str = "50", proj_hidden_dim: int = 512,
                 proj_output_dim: int = 128, dtype: torch.dtype = torch.float32,
                 remat: bool = False, bn_axis=None, stem: str = "conv7",
                 bn_fused=False, bn_subsample: int = 1,
                 bn_stop_gradient_stats: bool = False, conv1x1_fuse_min_cin: int = 0,
                 maxpool: str = "xla"):
        super().__init__()
        self.resnet_size, self.remat = resnet_size, remat
        self.encoder = RESNETS[resnet_size](
            dtype=dtype, bn_axis=bn_axis, stem=stem, bn_fused=bn_fused,
            bn_subsample=bn_subsample, bn_stop_gradient_stats=bn_stop_gradient_stats,
            conv1x1_fuse_min_cin=conv1x1_fuse_min_cin, maxpool=maxpool)
        self.projection_head = ProjectionHead(
            FEATURE_DIMS[resnet_size], proj_hidden_dim, proj_output_dim, dtype=dtype
        )

    def forward(self, images: torch.Tensor):
        if self.remat and self.training and torch.is_grad_enabled():
            emb = checkpoint(self.encoder, images, use_reentrant=False,
                             context_fn=_remat_contexts)
        else:
            emb = self.encoder(images)
        return emb, self.projection_head(emb)

    @property
    def feature_dim(self) -> int:
        return FEATURE_DIMS[self.resnet_size]


def _remat_contexts():
    """The forward runs as it is; the recomputation leaves the running
    statistics alone."""
    return contextlib.nullcontext(), frozen_running_stats()


def projection_stats(projections: torch.Tensor, axis=None) -> dict[str, torch.Tensor]:
    """Per-axis mean/median/min/max of the raw projections viewed as
    (B, D/2, 2) points, batch-averaged, for each view; with an axis, each
    rank's averages are pmean'd, as the reference averages its replicas'
    metrics."""
    two_b, d = projections.shape
    b = two_b // 2
    pts = projections.detach().reshape(two_b, d // 2, 2)
    out: dict[str, torch.Tensor] = {}
    for name, half in (("proj1", pts[:b]), ("proj2", pts[b:])):
        stats = {
            "mean": half.mean(dim=1),
            "median": torch_median(half, dim=1),
            "min": half.amin(dim=1),
            "max": half.amax(dim=1),
        }
        for stat, v in stats.items():
            batch_avg = v.mean(dim=0)
            if axis is not None:
                batch_avg = axis.pmean(batch_avg)
            out[f"{name}x_{stat}"] = batch_avg[0]
            out[f"{name}y_{stat}"] = batch_avg[1]
    return out


def transformed_projections(projections: torch.Tensor, batch: dict,
                            cfg: ContrastiveConfig):
    """Raw head outputs -> normalised (z1, z2) per the experiment type."""
    b = projections.shape[0] // 2
    if cfg.experiment_type in _EQUIVARIANT:
        jx = jy = ang = None
        if "crop" in cfg.augmentation:
            jx = torch.cat([batch["jitter_x_1"], batch["jitter_x_2"]])
            jy = torch.cat([batch["jitter_y_1"], batch["jitter_y_2"]])
        if "rotate" in cfg.augmentation:
            ang = torch.cat([batch["angle_1"], batch["angle_2"]])
        return inverse_transform_projections(projections, jx, jy, ang, cfg.image_side)
    return _l2_normalize(projections[:b]), _l2_normalize(projections[b:])


def _joints(batch: dict, cfg: ContrastiveConfig):
    key = "ori" if cfg.joints_type == "original" else "aug"
    return batch[f"joints1_{key}"][..., :2], batch[f"joints2_{key}"][..., :2]


def adaptive_weights(batch: dict, cfg: ContrastiveConfig, axis=None):
    """(pos_weights, neg_weights) from the per-sample joints."""
    j1, j2 = _joints(batch, cfg)
    flat = False
    if cfg.use_pca:
        j1, j2 = apply_pca(j1, cfg.pca_dim, axis), apply_pca(j2, cfg.pca_dim, axis)
        flat = True
    if cfg.weight_type == "linear":
        return linear_weights(j1, j2, cfg.diff_type, axis, flat=flat)
    return nonlinear_weights(j1, j2, cfg.non_linear_lambda_pos,
                             cfg.non_linear_lambda_neg, cfg.diff_type, axis, flat=flat)


def contrastive_loss_from_projections(projections: torch.Tensor, batch: dict,
                                      cfg: ContrastiveConfig, axis=None):
    """The per-step contrastive loss of any experiment type.

    projections: (2B, D) raw head outputs of this rank, [view1; view2];
    ``axis``: the data axis of the global negative set (None: one device).
    Returns (loss, (z1, z2)).
    """
    z1, z2 = transformed_projections(projections, batch, cfg)
    weights_cfg = (cfg.weight_type, cfg.diff_type, cfg.pos_neg, cfg.use_pca)
    n_rows = 2 * z1.shape[0]

    if cfg.use_pallas and axis is not None and n_rows % 256 == 0:
        if cfg.experiment_type not in _WEIGHTED and (n_rows * axis.size) % 512 == 0:
            return make_sharded_nt_xent_kernel(axis, cfg.temperature)(z1, z2), (z1, z2)
        if cfg.experiment_type in _WEIGHTED and weights_cfg == _FLAGSHIP_WEIGHTS:
            loss_fn = make_sharded_weighted_nt_xent_kernel(axis, cfg.temperature)
            return loss_fn(z1, z2, *_joints(batch, cfg)), (z1, z2)
        # other configurations take the dense route

    if cfg.use_pallas and axis is None and n_rows % 512 == 0:
        if cfg.experiment_type not in _WEIGHTED:
            return nt_xent_kernel(z1, z2, cfg.temperature), (z1, z2)
        if weights_cfg == _FLAGSHIP_WEIGHTS:
            j1, j2 = _joints(batch, cfg)
            pos_d = _pair_distance(j1, j2, "mpjpe")
            # statistics as tensors on the device: no host synchronisation
            d_min, d_max = pairwise_minmax(torch.cat([j1, j2]), "mpjpe")
            pw = (pos_d.max() - pos_d) / (pos_d.max() - pos_d.min())
            loss = weighted_nt_xent_kernel(
                z1, z2, torch.cat([j1, j2]), pw, torch.stack([d_max, d_min]),
                cfg.temperature)
            return loss, (z1, z2)
        # other weighted configurations take the dense route

    if cfg.experiment_type in _WEIGHTED:
        pw, nw = adaptive_weights(batch, cfg, axis)
        if cfg.pos_neg == "pos_neg":
            loss = weighted_nt_xent(z1, z2, pw, nw, cfg.temperature, axis)
        elif cfg.pos_neg == "pos":
            loss = pos_weighted_nt_xent(z1, z2, pw, cfg.temperature, axis)
        elif cfg.pos_neg == "neg":
            loss = neg_weighted_nt_xent(z1, z2, nw, cfg.temperature, axis)
        else:
            raise ValueError(f"unknown pos_neg {cfg.pos_neg!r}")
    else:
        loss = nt_xent(z1, z2, cfg.temperature, axis)
    return loss, (z1, z2)
