#!/usr/bin/env python3
"""How far the bf16 step of each encoder variant of the PyTorch port departs
from the exact one, on the CPU.

    PYTHONPATH=. python scripts/torch_bf16_departure.py [--pairs 96] [--side 64]

Builds the ResNet-50 ContrastiveModel of each variant from one seed and
computes the simhand_w step-0 loss (dense route) and its parameter
gradients on one synthetic batch: exact BatchNorm in float32 and in bf16,
bn_fused="epilogue", bn_fused="pallas", conv1x1_fuse_min_cin=512, and
bn_fused="pallas" with its affine rounded once in float32 instead of the
reference's two roundings (A and B rounded to bf16 per channel). Prints
each loss's departure from the exact bf16 loss, and each variant's
gradients' distance from the exact float32 and exact bf16 gradients,
relative to their norm. On the CPU every kernel wrapper runs its plain
version.
"""
from __future__ import annotations

import argparse

import torch

from simhand_tpu_torch.models import (
    ContrastiveConfig,
    ContrastiveModel,
    contrastive_loss_from_projections,
)
from simhand_tpu_torch.models import bn_epilogue
from simhand_tpu_torch.train.state import init_weights


def synthetic_batch(pairs: int, side: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    batch = {f"transformed_image{i}": torch.randn(pairs, side, side, 3, generator=gen)
             for i in (1, 2)}
    for key, (lo, hi) in (("jitter_x", (-10, 0)), ("jitter_y", (-10, 0)), ("angle", (-45, 45))):
        for i in (1, 2):
            batch[f"{key}_{i}"] = uniform(lo, hi, pairs)
    for i in (1, 2):
        batch[f"joints{i}_aug"] = uniform(0, side, pairs, 21, 3)
    return batch


def affine_rounded_once(x, mu, inv, scale, bias):
    A = inv * scale.float()
    B = bias.float() - mu * A
    return (x.float() * bn_epilogue._channel(A, x) + bn_epilogue._channel(B, x)).to(x.dtype)


def step0(dtype, batch, cfg, seed, **model_kw):
    model = ContrastiveModel("50", dtype=dtype, **model_kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.train()
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    loss, _ = contrastive_loss_from_projections(model(images)[1], batch, cfg)
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()))


def distance(got, want) -> float:
    num = sum(float((a - b).double().norm()) ** 2 for a, b in zip(got, want))
    return (num / sum(float(b.double().norm()) ** 2 for b in want)) ** 0.5


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=96)
    parser.add_argument("--side", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    batch = synthetic_batch(args.pairs, args.side, args.seed)
    cfg = ContrastiveConfig(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
                            image_side=float(args.side))
    bf16 = torch.bfloat16
    runs = {"exact_f32": step0(torch.float32, batch, cfg, args.seed),
            "exact_bf16": step0(bf16, batch, cfg, args.seed),
            "epilogue": step0(bf16, batch, cfg, args.seed, bn_fused="epilogue"),
            "pallas": step0(bf16, batch, cfg, args.seed, bn_fused="pallas"),
            "conv1x1": step0(bf16, batch, cfg, args.seed, conv1x1_fuse_min_cin=512)}
    two_roundings = bn_epilogue.bn_affine
    bn_epilogue.bn_affine = affine_rounded_once
    try:
        runs["pallas_one_rounding"] = step0(bf16, batch, cfg, args.seed, bn_fused="pallas")
    finally:
        bn_epilogue.bn_affine = two_roundings
    exact_loss, exact_grads = runs["exact_bf16"]
    _, f32_grads = runs["exact_f32"]
    print(f"ResNet-50, {args.pairs} pairs at {args.side}x{args.side}, seed {args.seed}, CPU")
    for name, (loss, grads) in runs.items():
        print(f"{name:20s} loss {loss:.7f} rel to exact bf16 {abs(loss - exact_loss) / exact_loss:.2e}; "
              f"gradients from exact float32 {distance(grads, f32_grads):.3f}, "
              f"from exact bf16 {distance(grads, exact_grads):.3f} of their norm")


if __name__ == "__main__":
    main()
