"""The whole run of a cell on the CPU at toy size, past the harness's look for
a card: the last line's keys, a sound run that comes out correct, and the
timed path broken underneath, once for each fault a one-chip training cell
can have, coming out not correct. And the control: the plain reference in
float8 put in the program's place fails the toy limits."""
from __future__ import annotations

import os

import pytest
import torch

import simhand_tpu_torch.train as train_pkg
from perfbench import compare
from perfbench.spec import load_module, load_spec
from perfbench.tests.toy import TOY_LIMITS, run_toy, toy_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy_root(str(tmp_path_factory.mktemp("faults")))


def test_sound_run(root):
    result = run_toy(root)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"samples_per_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(TOY_LIMITS)
    assert result["correct"], result["checks"]


def _state_unchanged(make):
    """A step that computes its loss and returns its state as it found it."""
    def wrapped(model, cfg, augment=None, axis=None):
        step = make(model, cfg, augment=augment, axis=axis)

        def run(state, batch):
            saved = {k: v.clone() for k, v in model.state_dict().items()}
            opt = state.optimizer
            moments = [t.clone() for t in opt.mu + opt.nu]
            count = opt.count
            state, metrics = step(state, batch)
            with torch.no_grad():
                model.load_state_dict(saved)
                for t, v in zip(opt.mu + opt.nu, moments):
                    t.copy_(v)
            opt.count = count
            return state, metrics
        return run
    return wrapped


def _half_batch(make):
    """A step that leaves out half of its batch and takes the mean over the rest."""
    def wrapped(model, cfg, augment=None, axis=None):
        step = make(model, cfg, augment=augment, axis=axis)

        def run(state, batch):
            half = batch["image1"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return run
    return wrapped


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(train_pkg, "make_train_step", fault(train_pkg.make_train_step))
    result = run_toy(root, seed=12)
    assert not result["correct"], result["checks"]


def test_control_fails_the_limits(root):
    """The control: the reference computed in float8 in the program's place."""
    spec = load_spec(root, "toy")
    cell = load_module(root, "drivers", "pretrain").Cell(
        spec, 13, torch.device("cpu"), os.path.join(root, "build", "perfbench"))
    cell.corpus = cell.generator.ensure_corpus(cell.traffic, cell.work_dir, cell.device)
    gaps = compare.gaps(cell.reference_readings(compute="fp8"), cell.reference_readings())
    assert any(gaps[k] > limit for k, limit in TOY_LIMITS.items()), gaps
