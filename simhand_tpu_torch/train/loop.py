"""The pre-training step on one device (counterpart of
``simhand_tpu/train/loop.py``), on a batch of already augmented views.

The step updates the model and the optimizer state in place and returns
the state with its metrics as tensors on the device: nothing in it waits
for the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from simhand_tpu_torch.models.contrastive import (
    _EQUIVARIANT,
    ContrastiveConfig,
    contrastive_loss_from_projections,
    projection_stats,
)


def _images(batch: dict) -> torch.Tensor:
    return torch.cat([batch["transformed_image1"], batch["transformed_image2"]])


def _check_state(state, model) -> None:
    if state.model is not model:
        raise ValueError("the state holds another model than this step's")


def make_train_step(model, cfg: ContrastiveConfig) -> Callable:
    """(state, batch) -> (state, metrics): one optimizer step. The BatchNorm
    running statistics come from the train-mode forward; the equivariant
    family adds the projection statistics to the metrics."""

    def train_step(state, batch):
        _check_state(state, model)
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


def make_eval_step(model, cfg: ContrastiveConfig) -> Callable:
    """(state, batch) -> metrics: the loss with frozen BatchNorm statistics."""

    @torch.no_grad()
    def eval_step(state, batch):
        _check_state(state, model)
        model.eval()
        _, proj = model(_images(batch))
        loss, _ = contrastive_loss_from_projections(proj, batch, cfg)
        return {"contrastive_loss": loss}

    return eval_step
