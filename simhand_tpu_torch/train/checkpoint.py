"""Checkpoints and the torch-format encoder export (counterpart of
``simhand_tpu/train/checkpoint.py``).

One directory per step, named by the step number as orbax names it (the
``-checkpoint`` flag takes the digits of a name), holding ``state.pt``:
``torch.save`` of the model's ``state_dict`` (parameters and BatchNorm
statistics), the optimizer's state (moments and counters), the step and
the metric; and ``metrics.json``, the metric alone, which the retention
reads. Each save is written under a temporary name in the same directory
and then ``os.replace``d into place, so a save cut short never leaves a
half checkpoint.

The file does not depend on the layout: an FSDP state's ``payload``
gathers whole tensors, and its ``load_payload`` keeps this rank's pieces,
so a replicated run's checkpoint restores under FSDP and back. In a run of
several ranks one rank calls ``save`` and every other calls the state's
``payload`` at the same point (an FSDP state's gather takes every rank).

The retention is orbax's with ``max_to_keep=max(save_top_k, 1)``,
``best_fn=metric`` and ``best_mode="min"``: a save of a step at or below
the latest saved step is skipped; after each save the checkpoints are
ordered from worst to best (the larger metric is worse; of equal metrics
the older is worse) and the worst beyond ``max_to_keep`` are deleted, the
new one too if it is among them. ``latest_step``, ``all_steps`` and
``best_step`` give orbax's answers for the same saves.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile

import torch

logger = logging.getLogger("simhand_tpu_torch")

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    """Keeps ``save_top_k`` checkpoints ordered by ``metric`` (lower is
    better), as the JAX package's orbax manager does."""

    def __init__(self, directory: str, save_top_k: int = 1, metric: str = "contrastive_loss"):
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        self.metric = metric
        self.directory = directory
        self.max_to_keep = max(save_top_k, 1)

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def _metric_of(self, step: int) -> float:
        with open(self._path(step, METRICS_FILE)) as f:
            return float(json.load(f)[self.metric])

    def save(self, step: int, state, metrics: dict[str, float]) -> bool:
        """Writes ``state`` (a ``TrainState``) as checkpoint ``step``; returns
        False, writing nothing, when ``step`` is not past the latest one.
        The state's ``payload`` is taken first, whether or not it is
        written."""
        tensors = state.payload()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            logger.info("not saving step %d: checkpoint %d exists at %s",
                        step, latest, self.directory)
            return False
        value = float(metrics[self.metric])
        logger.info("Saving checkpoint at %s (step %d, %s=%.6f)",
                    self.directory, step, self.metric, value)
        payload = {**tensors, "step": int(state.step), "metrics": {self.metric: value}}
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump({self.metric: value}, f)
            os.replace(tmp, self._path(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return True

    def _prune(self) -> None:
        steps = self.all_steps()
        # worst first: the larger metric; of equal ones the older (a stable
        # sort in reverse keeps the steps' ascending order among equals)
        ranked = sorted(steps, key=self._metric_of, reverse=True)
        for step in ranked[:max(len(ranked) - self.max_to_keep, 0)]:
            shutil.rmtree(self._path(step))

    def restore_tree(self, step: int | None = None, map_location=None) -> dict | None:
        """The saved payload of ``step`` (the latest when None): ``model``,
        ``optimizer``, ``step`` and ``metrics``; None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step, STATE_FILE), map_location=map_location,
                          weights_only=True)

    def restore(self, state, step: int | None = None):
        """Loads checkpoint ``step`` (the latest when None) into ``state``, in
        place, and returns it; None when there is no checkpoint."""
        device = next(state.model.parameters()).device
        saved = self.restore_tree(step, map_location=device)
        if saved is None:
            return None
        state.load_payload(saved)
        state.step = int(saved["step"])
        return state

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def best_step(self) -> int | None:
        steps = self.all_steps()
        if not steps:
            return None
        return sorted(steps, key=self._metric_of, reverse=True)[-1]

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""


def export_state_dict(module, path: str) -> None:
    """Writes ``module``'s state dict without ``num_batches_tracked`` as
    contiguous float32 tensors on the CPU, under a temporary name then
    ``os.replace``d into ``path``."""
    sd = {k: v.detach().to("cpu", copy=True).contiguous()
          for k, v in module.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".export.", dir=directory)
    os.close(fd)
    try:
        torch.save(sd, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def export_torch_encoder(state, path: str) -> None:
    """Writes the encoder in the released ``resnet50_simhand.pth`` layout:
    torchvision's keys, the key set the JAX package's export writes."""
    export_state_dict(state.model.encoder, path)
