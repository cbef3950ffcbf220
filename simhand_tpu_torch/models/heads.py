"""Downstream 2.5D regression head with MLP root-depth refinement
(counterpart of ``simhand_tpu/models/heads.py``).

Reference: src/models/rn_25D_wMLPref.py (the PeCLR-paper downstream
model): ResNet -> 21*3+1 linear head; the scale-normalized root depth is
recovered analytically from the unit-bone constraint (arXiv:1804.09534 eq.
6/7, bone indices 3->8) and refined by an MLP (arXiv:2003.09282). Module
names are the JAX model's, so ``convert.from_flax_variables`` carries its
variables over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from simhand_tpu_torch.core.geometry import opencv_rotation_matrix
from simhand_tpu_torch.models.layers import BatchNorm1d, Linear
from simhand_tpu_torch.models.resnet import FEATURE_DIMS, RESNETS

DEFAULT_K = torch.tensor(
    [
        [388.9018310596544, 0.0, 112.0],
        [0.0, 388.71231836584275, 112.0],
        [0.0, 0.0, 1.0],
    ],
    dtype=torch.float32,
)


class ZrootMLPRef(nn.Module):
    """zroot_refined = zroot_analytic + MLP(2D, zrel, zroot)."""

    def __init__(self, dtype: torch.dtype = torch.float32, norm_bone_idx=(3, 8)):
        super().__init__()
        self.dtype, self.norm_bone_idx = dtype, norm_bone_idx
        self.fc0, self.bn0 = Linear(21 + 42 + 1, 128, dtype=dtype), BatchNorm1d(128)
        self.fc1, self.bn1 = Linear(128, 128, dtype=dtype), BatchNorm1d(128)
        self.fc_out = Linear(128, 1, dtype=dtype)

    def forward(self, kp3d_unnorm: torch.Tensor, zrel: torch.Tensor) -> torch.Tensor:
        eps = 1e-8
        m, n = self.norm_bone_idx
        X_m, Y_m = kp3d_unnorm[:, m, 0], kp3d_unnorm[:, m, 1]
        X_n, Y_n = kp3d_unnorm[:, n, 0], kp3d_unnorm[:, n, 1]
        z_m, z_n = zrel[:, m, 0], zrel[:, n, 0]

        a = (X_n - X_m) ** 2 + (Y_n - Y_m) ** 2
        b = 2.0 * (
            z_n * (X_n**2 + Y_n**2 - X_n * X_m - Y_n * Y_m)
            + z_m * (X_m**2 + Y_m**2 - X_n * X_m - Y_n * Y_m)
        )
        c = (
            (X_n * z_n - X_m * z_m) ** 2
            + (Y_n * z_n - Y_m * z_m) ** 2
            + (z_n - z_m) ** 2
            - 1.0
        )
        d = torch.clamp_min(b * b - 4.0 * a * c, eps)
        a = torch.clamp_min(a, eps)
        zroot = ((-b + torch.sqrt(d)) / (2.0 * a)).detach()
        zroot = torch.clamp(zroot, 4.0, 50.0)

        mlp_in = torch.cat([zrel.reshape(-1, 21), kp3d_unnorm[..., :2].reshape(-1, 42),
                            zroot.reshape(-1, 1)], dim=1)
        x = mlp_in.to(self.dtype)
        for fc, bn in ((self.fc0, self.bn0), (self.fc1, self.bn1)):
            x = F.leaky_relu(bn(fc(x)), 0.01)
        x = self.fc_out(x)
        return zroot + x.reshape(zroot.shape).float()


class RN25DWithMLPRef(nn.Module):
    """ResNet -> (21, 3)+1 regression -> analytic+MLP zroot -> 3D joints.
    Images are (N, H, W, C)."""

    def __init__(self, resnet_size: str = "50", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = RESNETS[resnet_size](dtype=dtype)
        self.fc = Linear(FEATURE_DIMS[resnet_size], 3 * 21 + 1)
        self.zroot_ref = ZrootMLPRef(dtype=dtype)

    def forward(self, img: torch.Tensor, K: torch.Tensor | None = None) -> dict:
        B = img.shape[0]
        if K is None:
            K = DEFAULT_K.to(img.device).expand(B, 3, 3)
        out = self.fc(self.encoder(img))
        kp25d = out[:, :-1].reshape(-1, 21, 3)
        kp2d = kp25d[..., :2]
        # the root's relative depth is zero; the reference's in-place
        # `zrel[:, 0] = 0` mutates the aliased kp25d view too
        # (rn_25D_wMLPref.py), so the output carries it
        zrel = torch.cat([torch.zeros_like(kp25d[:, :1, 2:3]), kp25d[:, 1:, 2:3]], dim=1)
        kp25d = torch.cat([kp2d, zrel], dim=-1)

        kp2d_h = torch.cat([kp2d, torch.ones((B, 21, 1), dtype=kp2d.dtype, device=kp2d.device)],
                           dim=2)
        K_inv = torch.linalg.inv(K)
        kp3d_unnorm = torch.einsum("bnk,bjk->bnj", kp2d_h, K_inv)
        zroot = self.zroot_ref(kp3d_unnorm, zrel)
        kp3d = kp3d_unnorm * (zrel + zroot[:, None, None])
        return {"kp3d": kp3d, "zrel": zrel, "kp2d": kp2d, "kp25d": kp25d}


def normalize_heatmap(heatmap: torch.Tensor, beta: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax-style per-channel heatmap normalization of (N, C, H, W)
    (reference: src/models/utils.py:704-713)."""
    if beta is None:
        beta = torch.ones((1, heatmap.shape[1], 1, 1), dtype=heatmap.dtype,
                          device=heatmap.device)
    h = torch.exp(heatmap) * beta
    return h / torch.sum(h, dim=(2, 3), keepdim=True)


def heatmap_transformation_matrix(jitter_x, jitter_y, scale, angle, heatmap_dim) -> torch.Tensor:
    """Batched (B, 2, 3) affine that reverts heatmap augmentation: a pixel
    translation composed with a scaled rotation about the heatmap centre
    (reference: src/models/utils.py:766-806)."""
    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32).reshape(-1)

    jx, jy = vec(jitter_x), vec(jitter_y)
    cx = torch.full_like(jx, heatmap_dim[1] / 2.0)
    cy = torch.full_like(jy, heatmap_dim[0] / 2.0)
    rot = opencv_rotation_matrix(cx, cy, vec(angle), vec(scale))      # (B, 2, 3)
    # rot @ [[1,0,jx],[0,1,jy],[0,0,1]]: the translation folds into col 2
    t = rot[..., 0] * jx[:, None] + rot[..., 1] * jy[:, None] + rot[..., 2]
    return torch.cat([rot[..., :2], t[..., None]], dim=-1)


def affine_mat_to_theta(affine_mat, w: float, h: float) -> torch.Tensor:
    """A pixel-space (B, 2, 3) affine -> the normalized [-1, 1]-grid theta
    of grid-sample warps (reference: src/models/utils.py:808-835)."""
    m = torch.as_tensor(affine_mat, dtype=torch.float32)
    row0 = torch.stack([m[:, 0, 0], m[:, 0, 1] * h / w,
                        m[:, 0, 2] * 2.0 / w + m[:, 0, 0] + m[:, 0, 1] - 1.0], dim=-1)
    row1 = torch.stack([m[:, 1, 0] * w / h, m[:, 1, 1],
                        m[:, 1, 2] * 2.0 / h + m[:, 1, 0] + m[:, 1, 1] - 1.0], dim=-1)
    return torch.stack([row0, row1], dim=-2)


class Denoiser(nn.Module):
    """zroot denoiser MLP (reference: src/models/utils.py:716-725)."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc0, self.bn0 = Linear(cin, 128, dtype=dtype), BatchNorm1d(128)
        self.fc1, self.bn1 = Linear(128, 128, dtype=dtype), BatchNorm1d(128)
        self.fc_out = Linear(128, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for fc, bn in ((self.fc0, self.bn0), (self.fc1, self.bn1)):
            x = torch.relu(bn(fc(x)))
        return self.fc_out(x).float()
