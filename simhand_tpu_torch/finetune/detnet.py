"""DetNet: heatmap + delta-map + location-map 3D hand-pose head
(counterpart of ``simhand_tpu/finetune/detnet.py``).

Reference: minimal-hand/model/detnet/detnet.py. Architecture:

  ResNet-50/152 features (N, 4, 4, 2048)
  -> 3x deconv [256, 256, 256] (4x4 stride 2, BN, ReLU)   -> (N, 32, 32, 256)
  -> concat 2-ch coordinate tile (linspace -1..1 grids)    -> 258 ch
  -> hmap head: conv3x3+BN+ReLU -> 1x1 conv -> sigmoid     -> (N, 32, 32, 21)
  -> concat -> dmap head (279 in)                          -> (N, 32, 32, 21*3)
  -> concat -> lmap head (342 in)                          -> (N, 32, 32, 21*3)
  uv = argmax(hmap); xyz = lmap gathered at argmax; delta likewise.

Module and parameter names are the reference's minimal-hand keys
(``encoder.resnet.*``, ``deconv.{0..8}``, ``{hmap,dmap,lmap}_0.project.{0,1}``
and ``.prediction``), so the ``.pth`` export is the model's state dict. The
deconv and head BatchNorms are flax ``nn.BatchNorm`` in the JAX package:
here the flax-exact ``layers.BatchNorm2d`` (momentum 0.9, biased variance,
float32 statistics), whatever ``bn_fused`` the encoder takes. Images are
(N, H, W, C), the outputs' layout is the JAX package's.
"""
from __future__ import annotations

import torch
from torch import nn

from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d
from simhand_tpu_torch.models.resnet import RESNETS


def pose_tile(n: int, res: int = 32, dtype=torch.float32, device=None) -> torch.Tensor:
    """(N, 2, res, res) coordinate tile: ch0 = x (−1..1 across width), ch1 =
    y (−1..1 down height), the reference's get_pose_tile_torch. The ramp is
    ``jnp.linspace``'s formula in ``dtype``: start * (1 - step) + stop *
    step, step = iota / (res - 1), the end point set."""
    div = res - 1
    step = torch.arange(div, dtype=dtype, device=device) / torch.tensor(div, dtype=dtype,
                                                                       device=device)
    start = torch.tensor(-1.0, dtype=dtype, device=device)
    stop = torch.tensor(1.0, dtype=dtype, device=device)
    lin = torch.cat([start * (1 - step) + stop * step, stop[None]])
    tile = torch.stack([lin[None, :].expand(res, res), lin[:, None].expand(res, res)])
    return tile[None].expand(n, 2, res, res)


class _MapHead(nn.Module):
    """conv3x3 + BN + ReLU -> 1x1 conv prediction."""

    def __init__(self, cin: int, hidden: int, out: int, sigmoid: bool, dtype: torch.dtype):
        super().__init__()
        self.project = nn.Sequential(Conv2d(cin, hidden, 3, dtype=dtype), BatchNorm2d(hidden),
                                     nn.ReLU())
        self.prediction = Conv2d(hidden, out, 1, dtype=dtype, bias=True)
        self.sigmoid = sigmoid

    def forward(self, x):
        x = self.prediction(self.project(x))
        return torch.sigmoid(x) if self.sigmoid else x


class ResNetModel(nn.Module):
    """The reference's encoder wrapper: the ResNet under ``resnet``."""

    def __init__(self, resnet: nn.Module):
        super().__init__()
        self.resnet = resnet

    def forward(self, x):
        return self.resnet(x)


class DetNet(nn.Module):
    """Full detnet. Input (N, 128, 128, 3), outputs dict of maps + joints.

    ``bn_stop_gradient_stats``, ``bn_fused`` and ``maxpool`` go to the
    encoder, as the JAX ``DetNet`` passes them.
    """

    def __init__(self, resnet_size: str = "50", njoints: int = 21, hm_res: int = 32,
                 dtype: torch.dtype = torch.float32, bn_stop_gradient_stats: bool = False,
                 bn_fused=False, maxpool: str = "xla"):
        super().__init__()
        self.njoints, self.hm_res, self.dtype = njoints, hm_res, dtype
        resnet = RESNETS[resnet_size](dtype=dtype, pool=False,
                                      bn_stop_gradient_stats=bn_stop_gradient_stats,
                                      bn_fused=bn_fused, maxpool=maxpool)
        self.encoder = ResNetModel(resnet)
        # I2L-MeshNet deconv stack: features -> 256 -> 256 -> 256, each 2x up
        layers, cin = [], resnet.num_features
        for _ in range(3):
            layers += [ConvTranspose2d(cin, 256, dtype=dtype), BatchNorm2d(256), nn.ReLU()]
            cin = 256
        self.deconv = nn.Sequential(*layers)
        j = njoints
        self.hmap_0 = _MapHead(256 + 2, 256, j, sigmoid=True, dtype=dtype)
        self.dmap_0 = _MapHead(256 + 2 + j, 256, j * 3, sigmoid=False, dtype=dtype)
        self.lmap_0 = _MapHead(256 + 2 + 4 * j, 256, j * 3, sigmoid=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> dict:
        n = x.shape[0]
        feats = self.encoder(x).to(self.dtype).permute(0, 3, 1, 2)
        feats = self.deconv(feats)
        x = torch.cat([feats, pose_tile(n, self.hm_res, self.dtype, feats.device)], dim=1)

        hmap = self.hmap_0(x).float()
        x = torch.cat([x, hmap.to(self.dtype)], dim=1)
        dmap = self.dmap_0(x).float()
        x = torch.cat([x, dmap.to(self.dtype)], dim=1)
        lmap = self.lmap_0(x).float()

        j, r = self.njoints, self.hm_res
        hmap = hmap.permute(0, 2, 3, 1)
        dmap = dmap.permute(0, 2, 3, 1).reshape(n, r, r, j, 3)
        lmap = lmap.permute(0, 2, 3, 1).reshape(n, r, r, j, 3)

        uv, idx = map_to_uv(hmap)
        return {
            "h_map": hmap,                          # (N, 32, 32, 21)
            "d_map": dmap,                          # (N, 32, 32, 21, 3)
            "l_map": lmap,                          # (N, 32, 32, 21, 3)
            "delta": gather_at_argmax(dmap, idx),   # (N, 21, 3)
            "xyz": gather_at_argmax(lmap, idx),     # (N, 21, 3)
            "uv": uv,                               # (N, 21, 2): (row, col)
        }


def map_to_uv(hmap: torch.Tensor):
    """Argmax of each joint heatmap (N, H, W, J), the first of equal maxima.

    Returns uv (N, J, 2) as (row, col) — the reference's (argmax // w,
    argmax % w) — and the flat index (N, J) (the JAX package's one-hot
    matmul selects the same element)."""
    n, h, w, j = hmap.shape
    idx = hmap.permute(0, 3, 1, 2).reshape(n, j, h * w).argmax(dim=-1)
    return torch.stack([idx // w, idx % w], dim=-1), idx


def gather_at_argmax(vmap: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, H, W, J, 3) at the per-joint flat index (N, J) -> (N, J, 3)."""
    n, h, w, j, c = vmap.shape
    flat = vmap.permute(0, 3, 1, 2, 4).reshape(n, j, h * w, c)
    return torch.gather(flat, 2, idx[:, :, None, None].expand(n, j, 1, c))[:, :, 0]
