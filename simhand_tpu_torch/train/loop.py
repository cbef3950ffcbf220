"""The pre-training step (counterpart of ``simhand_tpu/train/loop.py``), on
one device or data-parallel over an axis (``parallel.mesh``).

The step updates the model and the optimizer state in place and returns
the state with its metrics as tensors on the device: nothing in it waits
for the card. With ``augment=(flags, params, out_size)`` it takes a raw
batch (uint8 crops and joints, ``data.pipeline.PretrainDataset.raw_batch``
moved to the card) and augments both views on the card first. Its phases
are the spans ``simhand.step.augment``, ``.forward``, ``.loss``,
``.backward`` and ``.optimizer`` (``utils/trace.py``); the data-parallel
means lie outside them.

With an ``axis`` each rank takes its rows of the global batch, the loss is
the global-batch loss, the gradients are pmean'd over the ranks before the
update, and the BatchNorm running statistics are pmean'd after it: the
replicas' average, a no-op where the model's ``bn_axis`` already syncs
them. The state stays replicated.
"""
from __future__ import annotations

from typing import Callable

import torch

from simhand_tpu_torch.data.augment import prepare_views, seeded_generator
from simhand_tpu_torch.models.contrastive import (
    _EQUIVARIANT,
    ContrastiveConfig,
    contrastive_loss_from_projections,
    projection_stats,
)
from simhand_tpu_torch.utils import trace

#: the fixed seed of the evaluation's augmentation (distinct from the train
#: step's (0, step) stream): every evaluation sees the same views
EVAL_AUGMENT_SEED = 1729


def _images(batch: dict) -> torch.Tensor:
    return torch.cat([batch["transformed_image1"], batch["transformed_image2"]])


def _check_state(state, model) -> None:
    if state.model is not model:
        raise ValueError("the state holds another model than this step's")


def _augmented(batch: dict, augment, *key: int) -> dict:
    """The raw ``batch`` with both views augmented by draws from a generator
    seeded from ``key`` on the batch's device."""
    flags, params, out_size = augment
    generator = seeded_generator(batch["image1"].device, *key)
    return prepare_views(batch, generator, flags, params, out_size)


def _rank_key(axis) -> tuple:
    """The rank folded into an augmentation key (nothing on one device)."""
    return () if axis is None else (axis.index,)


@torch.no_grad()
def pmean_tensors(axis, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ranks' mean of each tensor, through one flat collective."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = axis.reduce_raw(flat, "sum") / axis.size
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def running_stats(model) -> list[torch.Tensor]:
    """Every BatchNorm running mean and variance of ``model``."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(model, cfg: ContrastiveConfig, augment=None, axis=None) -> Callable:
    """(state, batch) -> (state, metrics): one optimizer step. The BatchNorm
    running statistics come from the train-mode forward; the equivariant
    family adds the projection statistics to the metrics. With ``augment``,
    the step's draws come from a generator seeded from (0, state.step), the
    counterpart of the reference's ``fold_in(key(0), step)``, and (0,
    state.step, rank) with an ``axis``."""

    def train_step(state, batch):
        _check_state(state, model)
        if augment is not None:
            with trace.span("simhand.step.augment"):
                batch = _augmented(batch, augment, 0, state.step, *_rank_key(axis))
        with trace.span("simhand.step.forward"):
            model.train()
            _, proj = model(_images(batch))
        with trace.span("simhand.step.loss"):
            loss, _ = contrastive_loss_from_projections(proj, batch, cfg, axis)
        with trace.span("simhand.step.backward"):
            params = state.params
            grads = torch.autograd.grad(loss, params)
        if axis is not None:
            grads = pmean_tensors(axis, list(grads))
            stats = running_stats(model)
            with torch.no_grad():
                for s, m in zip(stats, pmean_tensors(axis, stats)):
                    s.copy_(m)
        with trace.span("simhand.step.optimizer"):
            state.optimizer.step(params, grads)
        state.step += 1
        metrics = {"contrastive_loss": loss.detach()}
        if cfg.experiment_type in _EQUIVARIANT:
            metrics.update(projection_stats(proj, axis))
        return state, metrics

    return train_step


def make_eval_step(model, cfg: ContrastiveConfig, augment=None, axis=None) -> Callable:
    """(state, batch) -> metrics: the loss with frozen BatchNorm statistics.
    With ``augment``, the views come from the fixed EVAL_AUGMENT_SEED (and
    the rank, with an ``axis``), so every call on the same raw batch sees
    the same views."""

    @torch.no_grad()
    def eval_step(state, batch):
        _check_state(state, model)
        if augment is not None:
            batch = _augmented(batch, augment, EVAL_AUGMENT_SEED, *_rank_key(axis))
        model.eval()
        _, proj = model(_images(batch))
        loss, _ = contrastive_loss_from_projections(proj, batch, cfg, axis)
        return {"contrastive_loss": loss}

    return eval_step
