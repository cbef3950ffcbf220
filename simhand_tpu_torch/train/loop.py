"""The pre-training step on one device (counterpart of
``simhand_tpu/train/loop.py``).

The step updates the model and the optimizer state in place and returns
the state with its metrics as tensors on the device: nothing in it waits
for the card. With ``augment=(flags, params, out_size)`` it takes a raw
batch (uint8 crops and joints, ``data.pipeline.PretrainDataset.raw_batch``
moved to the card) and augments both views on the card first.
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


def make_train_step(model, cfg: ContrastiveConfig, augment=None) -> Callable:
    """(state, batch) -> (state, metrics): one optimizer step. The BatchNorm
    running statistics come from the train-mode forward; the equivariant
    family adds the projection statistics to the metrics. With ``augment``,
    the step's draws come from a generator seeded from (0, state.step), the
    counterpart of the reference's ``fold_in(key(0), step)``."""

    def train_step(state, batch):
        _check_state(state, model)
        if augment is not None:
            batch = _augmented(batch, augment, 0, state.step)
        model.train()
        _, proj = model(_images(batch))
        loss, _ = contrastive_loss_from_projections(proj, batch, cfg)
        params = state.params
        grads = torch.autograd.grad(loss, params)
        state.optimizer.step(params, grads)
        state.step += 1
        metrics = {"contrastive_loss": loss.detach()}
        if cfg.experiment_type in _EQUIVARIANT:
            metrics.update(projection_stats(proj))
        return state, metrics

    return train_step


def make_eval_step(model, cfg: ContrastiveConfig, augment=None) -> Callable:
    """(state, batch) -> metrics: the loss with frozen BatchNorm statistics.
    With ``augment``, the views come from the fixed EVAL_AUGMENT_SEED, so
    every call on the same raw batch sees the same views."""

    @torch.no_grad()
    def eval_step(state, batch):
        _check_state(state, model)
        if augment is not None:
            batch = _augmented(batch, augment, EVAL_AUGMENT_SEED)
        model.eval()
        _, proj = model(_images(batch))
        loss, _ = contrastive_loss_from_projections(proj, batch, cfg)
        return {"contrastive_loss": loss}

    return eval_step
