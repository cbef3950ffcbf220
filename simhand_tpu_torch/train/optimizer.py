"""Optimizer stack (counterpart of ``simhand_tpu/train/optimizer.py``):
LARS trust ratio (pl_bolts 0.2.2) -> Adam -> learning rate, in the order of
the optax chain, with linear warmup then cosine decay, weight decay as L2
into the gradient except on biases and BatchNorm parameters, and gradient
accumulation as optax.MultiSteps does it (running mean, every k-th call).

Written by hand: ``torch.optim.Adam(weight_decay=...)`` is not this chain.
The learning rate is computed on the host in float32 from a step count the
host keeps, so the step never waits for the card.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-6
    optimizer: str = "LARS"              # "LARS" | "adam"
    warmup_epochs: int = 10
    epochs: int = 100
    accumulate_grad_batches: int = 1
    train_iters_per_epoch: int = 1000
    lars_eta: float = 0.02
    lars_clip: bool = True
    lars_eps: float = 1e-8

    @property
    def base_lr(self) -> float:
        return self.lr * math.sqrt(1024 * self.accumulate_grad_batches)

    @property
    def warmup_steps(self) -> int:
        return (self.warmup_epochs * self.train_iters_per_epoch
                // self.accumulate_grad_batches)

    @property
    def total_steps(self) -> int:
        return self.epochs * self.train_iters_per_epoch // self.accumulate_grad_batches


def _cosine(base: np.float32, count: int, decay_steps: int) -> np.float32:
    f32 = np.float32
    c = f32(min(count, decay_steps))
    return base * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps))))


def make_schedule(cfg: OptimizerConfig):
    """count -> learning rate (a float32 value), as optax computes it."""
    f32 = np.float32
    base = f32(cfg.base_lr)
    if cfg.optimizer != "LARS":
        return lambda count: float(_cosine(base, count, max(cfg.total_steps, 1)))
    warm = cfg.warmup_steps
    decay_steps = max(cfg.total_steps - warm, 1)

    def schedule(count: int) -> float:
        if count >= warm:
            return float(_cosine(base, count - warm, decay_steps))
        frac = f32(1) - f32(count) / f32(warm)
        return float((f32(0) - base) * frac + base)

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False):
    """count -> learning rate (a float32 value), as
    ``optax.exponential_decay(init_value, transition_steps, decay_rate,
    staircase=staircase)`` computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if count <= 0:
            return float(f32(init_value))
        p = f32(count) / f32(transition_steps)
        if staircase:
            p = np.floor(p)
        return float(f32(init_value) * np.power(f32(decay_rate), p))

    return schedule


@torch.no_grad()
def adam_direction(mu, nu, grads, count: int) -> list[torch.Tensor]:
    """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 outside the root):
    updates the moments in place and returns mu_hat / (sqrt(nu_hat) + eps)
    for the ``count``-th update (counted from 1)."""
    torch._foreach_mul_(mu, _B1)
    torch._foreach_add_(mu, grads, alpha=1 - _B1)
    torch._foreach_mul_(nu, _B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - _B2)
    f32 = np.float32
    bc1 = float(f32(1) - f32(_B1) ** f32(count))
    bc2 = float(f32(1) - f32(_B2) ** f32(count))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _ADAM_EPS)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    return update


class Adam:
    """``optax.adam(schedule)``, or ``optax.multi_transform`` of such over
    labelled groups: ``groups`` is a list of (parameters, schedule), each
    schedule taken at the update count before its increment, as optax does.
    Updated in place; ``state_dict`` holds the moments and the count."""

    def __init__(self, groups):
        self.groups = [(list(params), schedule) for params, schedule in groups]
        self.count = 0
        self.mu = [torch.zeros_like(p) for params, _ in self.groups for p in params]
        self.nu = [torch.zeros_like(p) for params, _ in self.groups for p in params]

    @property
    def params(self) -> list[torch.Tensor]:
        """The parameters in the groups' order, the order ``step`` takes
        their gradients in."""
        return [p for params, _ in self.groups for p in params]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(saved) != len(mine) or any(t.shape != v.shape for t, v in zip(mine, saved)):
                raise ValueError("the saved moments do not fit these parameters")
            for t, v in zip(mine, saved):
                t.copy_(v)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update of every group's parameters by ``grads`` (in the
        groups' order)."""
        start = 0
        self.count += 1
        for params, schedule in self.groups:
            k = slice(start, start + len(params))
            start += len(params)
            update = adam_direction(self.mu[k], self.nu[k], grads[k], self.count)
            torch._foreach_add_(params, update, alpha=-schedule(self.count - 1))


def decay_mask(model: nn.Module) -> list[bool]:
    """Per parameter of ``model.parameters()``: True where weight decay
    applies. Decided by module type (every BatchNorm parameter, including
    ``downsample.1``) and by "bias" in the parameter's name."""
    decide = {}
    for module in model.modules():
        is_bn = isinstance(module, nn.modules.batchnorm._BatchNorm)
        for name, p in module.named_parameters(recurse=False):
            decide[id(p)] = not (is_bn or "bias" in name)
    return [decide[id(p)] for p in model.parameters()]


class Optimizer:
    """The optimizer chain over a fixed list of parameters, updated in place."""

    def __init__(self, cfg: OptimizerConfig, params: list[torch.Tensor],
                 mask: list[bool]):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0              # updates applied (the chain's step count)
        self.mini_step = 0          # calls since the last update
        self.decay = [cfg.weight_decay if m else 0.0 for m in mask]
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.acc = ([torch.zeros_like(p) for p in params]
                    if cfg.accumulate_grad_batches > 1 else None)
        # FSDP: the axis whose ranks hold the pieces of each ``sharded`` leaf
        self.norm_axis, self.sharded = None, None

    def shard_norms(self, axis, sharded: list[bool]) -> None:
        """The parameters are this rank's pieces of whole leaves where
        ``sharded`` is set: LARS takes those leaves' norms over ``axis``
        (sqrt of the psum of the squared piece norms)."""
        self.norm_axis, self.sharded = axis, list(sharded)

    def _global_norms(self, p_norm, g_norm):
        mask = torch.tensor(self.sharded, device=p_norm.device)
        sq = torch.where(mask, torch.stack([p_norm, g_norm]).square(), 0.0)
        whole = self.norm_axis.reduce_raw(sq, "sum").sqrt()
        return torch.where(mask, whole[0], p_norm), torch.where(mask, whole[1], g_norm)

    def state_dict(self) -> dict:
        """The moments, the accumulator and the two counters (the chain's
        state; its configuration is the caller's)."""
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": list(self.mu), "nu": list(self.nu),
                "acc": None if self.acc is None else list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copies ``state`` (of ``state_dict``) into this chain's tensors."""
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the saved optimizer accumulates gradients differently")
        for mine, saved in (("mu", state["mu"]), ("nu", state["nu"]), ("acc", state["acc"])):
            tensors = getattr(self, mine)
            if tensors is None:
                continue
            if len(saved) != len(tensors):
                raise ValueError(f"{mine}: {len(saved)} saved tensors for {len(tensors)}")
            for t, v in zip(tensors, saved):
                if t.shape != v.shape:
                    raise ValueError(f"{mine}: shape {tuple(v.shape)} for {tuple(t.shape)}")
                t.copy_(v)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        k = self.cfg.accumulate_grad_batches
        if k > 1:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return
            self._update(params, self.acc)
            torch._foreach_zero_(self.acc)
            return
        self._update(params, list(grads))

    def _lars(self, params, grads, lr: float):
        cfg = self.cfg
        wd = torch.tensor(self.decay, dtype=torch.float32, device=params[0].device)
        p_norm = torch.stack(torch._foreach_norm(params))
        g_norm = torch.stack(torch._foreach_norm(grads))
        if self.norm_axis is not None:
            p_norm, g_norm = self._global_norms(p_norm, g_norm)
        trust = (cfg.lars_eta * p_norm) / (g_norm + p_norm * wd + cfg.lars_eps)
        if cfg.lars_clip:
            # lr == 0 at the first warmup step: x / 0 = inf, clipped to 1
            trust = torch.clamp(trust / lr, max=1.0)
        # pl_bolts leaves the gradient untouched when either norm is 0
        ok = (p_norm > 0) & (g_norm > 0)
        scale = torch.where(ok, trust, 1.0).unbind()
        wd = torch.where(ok, wd, 0.0).unbind()
        out = torch._foreach_mul(params, list(wd))
        torch._foreach_add_(out, grads)
        torch._foreach_mul_(out, list(scale))
        return out

    def _update(self, params, grads) -> None:
        lr = self.schedule(self.count)
        if self.cfg.optimizer == "LARS":
            grads = self._lars(params, grads, lr)
        else:
            grads = [g + w * p if w else g
                     for g, p, w in zip(grads, params, self.decay)]
        self.count += 1
        update = adam_direction(self.mu, self.nu, grads, self.count)
        torch._foreach_add_(params, update, alpha=-lr)
