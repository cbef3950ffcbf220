"""ShapeNet: an MLP regressing the MANO shape (beta) from relative bone
lengths, its SIK loss and the PSO baseline fitter (the JAX package's
``finetune/shape_net.py``).

Reference: minimal-hand/model/shape_net.py (MLP 15->[128,256,512,256,128]
->10, tanh-bounded), losses/shape_loss.py (bone-length L2 + 1e-3 beta
reg), op_pso.py (particle swarm over beta in [-3,3]^10). The network and
the bone model run on the MANO model's device; PSO's particle update stays
numpy on the host, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from simhand_tpu_torch.finetune.mano import ManoModel, relative_bone_lengths


HIDDEN, OUT_DIM = (128, 256, 512, 256, 128), 10


class ShapeNet(nn.Module):
    """The layers keep the flax module's names: ``fc0``-``fc4``, ``fc_out``;
    float32 parameters and compute, as the JAX module at its defaults."""

    def __init__(self):
        super().__init__()
        widths = (15,) + HIDDEN
        for i in range(len(HIDDEN)):
            setattr(self, f"fc{i}", nn.Linear(widths[i], widths[i + 1]))
        self.fc_out = nn.Linear(widths[-1], OUT_DIM)

    def forward(self, bone_len: torch.Tensor) -> torch.Tensor:
        x = bone_len
        for i in range(len(HIDDEN)):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return torch.tanh(self.fc_out(x))


def load_shape_net(path: str, device) -> ShapeNet:
    """A trained ShapeNet in eval mode on ``device``, from the port's file or
    the JAX package's flax msgpack (``convert.read_shape_net``), loaded
    with ``strict=True``."""
    from simhand_tpu_torch.convert import read_shape_net

    model = ShapeNet()
    model.load_state_dict(read_shape_net(path), strict=True)
    return model.to(device).eval()


def sik_loss(mano: ManoModel, beta: torch.Tensor, rel_bone_len: torch.Tensor,
             reg: float = 1e-3):
    """||bone_len(beta) - target||^2 + reg * ||beta||^2
    (reference: losses/shape_loss.py:32-53). Returns (loss, bone_hat)."""
    bone_hat = relative_bone_lengths(mano, beta)
    fit = torch.sum((bone_hat - rel_bone_len) ** 2, dim=-1)
    return torch.mean(fit + reg * torch.sum(beta**2, dim=-1)), bone_hat


def sample_shape_dataset(mano: ManoModel, n: int, seed: int = 0):
    """(bone_len, beta) pairs for ShapeNet training, beta ~ 3*N(0,1) drawn by
    numpy (reference: minimal-hand/create_data.py:55-60); the bones are
    computed on the MANO model's device."""
    rng = np.random.default_rng(seed)
    beta = (3.0 * rng.standard_normal((n, 10))).astype(np.float32)
    with torch.no_grad():
        bones = relative_bone_lengths(mano, torch.from_numpy(beta).to(mano.device))
    return bones.cpu().numpy(), beta


def pso_fit_shape(
    mano: ManoModel,
    rel_bone_len: np.ndarray,
    n_particles: int = 100,
    n_iters: int = 30,
    reg: float = 1e-3,
    seed: int = 0,
    w: float = 0.7298,
    c1: float = 1.49618,
    c2: float = 1.49618,
):
    """Particle-swarm beta fit (reference: op_pso.py:15-170): the JAX
    package's host loop, the particles' costs on the MANO model's device.

    Args:
      rel_bone_len: (15,) target relative bone lengths.

    Returns:
      (10,) best beta.
    """
    rng = np.random.default_rng(seed)
    dev = mano.device
    target = torch.from_numpy(np.array(rel_bone_len, np.float32)).to(dev)[None]

    @torch.no_grad()
    def cost(betas: np.ndarray) -> np.ndarray:
        b = torch.from_numpy(betas).to(dev)
        bones = relative_bone_lengths(mano, b)
        c = torch.sum((bones - target) ** 2, dim=-1) + reg * torch.sum(b**2, dim=-1)
        return c.cpu().numpy()

    x = rng.uniform(-3, 3, (n_particles, 10)).astype(np.float32)
    v = np.zeros_like(x)
    pbest = x.copy()
    pbest_cost = cost(x)
    g = pbest[pbest_cost.argmin()].copy()
    g_cost = pbest_cost.min()

    for _ in range(n_iters):
        r1 = rng.random((n_particles, 10)).astype(np.float32)
        r2 = rng.random((n_particles, 10)).astype(np.float32)
        v = w * v + c1 * r1 * (pbest - x) + c2 * r2 * (g[None] - x)
        x = np.clip(x + v, -3.0, 3.0)
        c = cost(x)
        better = c < pbest_cost
        pbest[better] = x[better]
        pbest_cost[better] = c[better]
        if pbest_cost.min() < g_cost:
            g = pbest[pbest_cost.argmin()].copy()
            g_cost = pbest_cost.min()
    return g
