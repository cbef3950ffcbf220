"""The port's checkpoints (``simhand_tpu_torch.train.checkpoint``) against the
JAX package's orbax manager and torch export, on the CPU.

The retention is compared save by save with orbax's for the same metric
sequences; a save and restore is bit-equal; a run cut by a save and a
restore steps as the run that was not cut, bit for bit; the exported
encoder equals the JAX package's export of the same weights.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train import create_train_state as jcreate
from simhand_tpu.train.checkpoint import CheckpointManager as JManager
from simhand_tpu.train.checkpoint import export_torch_encoder as jexport
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
from simhand_tpu_torch.models.resnet import RESNETS
from simhand_tpu_torch.train import (
    Optimizer,
    OptimizerConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
from simhand_tpu_torch.train.checkpoint import CheckpointManager, export_torch_encoder
from simhand_tpu_torch.train.optimizer import decay_mask
from test_torch_train_step import SIDE, synthetic_batch

torch.set_num_threads(2)
B = 8
LOSSES = ([5.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0],
          [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0], [2.0, 2.0, 2.0], [1.0, 5.0, 1.0, 5.0])


def tiny_state() -> TrainState:
    model = nn.Linear(3, 2)
    params = list(model.parameters())
    return TrainState(model, Optimizer(OptimizerConfig(), params, decay_mask(model)))


def retention(mgr) -> tuple:
    return mgr.all_steps(), mgr.latest_step(), mgr.best_step()


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("losses", LOSSES, ids=lambda l: "-".join(str(int(v)) for v in l))
def test_retention_matches_orbax(tmp_path, losses, top_k):
    """The same saves into orbax's manager and into the port's leave the
    same steps, latest step and best step after every save (ties included);
    a save at or below the latest step is skipped by both; a manager
    reopened on the directory answers the same and prunes on its next save."""
    jmgr = JManager(str(tmp_path / "jax"), save_top_k=top_k)
    mgr = CheckpointManager(str(tmp_path / "port"), save_top_k=top_k)
    jstate, state = {"w": np.zeros(2, np.float32)}, tiny_state()
    saves = [(i, v) for i, v in enumerate(losses, 1)] + [(len(losses), 0.5), (2, 0.1)]
    for step, loss in saves:
        jmgr.save(step, jstate, {"contrastive_loss": loss})
        jmgr.wait()
        mgr.save(step, state, {"contrastive_loss": loss})
        assert retention(mgr) == retention(jmgr), (step, loss)
    jmgr.close()
    assert sorted(n for n in os.listdir(tmp_path / "port") if n.isdigit()) == \
        sorted(n for n in os.listdir(tmp_path / "jax") if n.isdigit())
    jmgr = JManager(str(tmp_path / "jax"), save_top_k=1)
    mgr = CheckpointManager(str(tmp_path / "port"), save_top_k=1)
    assert retention(mgr) == retention(jmgr)
    step = len(losses) + 1
    jmgr.save(step, jstate, {"contrastive_loss": 0.25})
    jmgr.wait()
    mgr.save(step, state, {"contrastive_loss": 0.25})
    assert retention(mgr) == retention(jmgr) == ([step], step, step)
    jmgr.close()


def torch_batch(seed: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in synthetic_batch(B, seed).items()}


def new_state(seed: int, accumulate: int = 1):
    model = ContrastiveModel("18")
    opt = OptimizerConfig(train_iters_per_epoch=2, warmup_epochs=1, epochs=10,
                          accumulate_grad_batches=accumulate)
    state = create_train_state(model, opt, seed, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    cfg = ContrastiveConfig(experiment_type="simhand_w", augmentation=("crop", "rotate"),
                            image_side=float(SIDE))
    return state, make_train_step(model, cfg)


def run(state, step, batches):
    for batch in batches:
        state, _ = step(state, batch)
    return state


def assert_states_equal(got: TrainState, want: TrainState):
    gsd, wsd = got.model.state_dict(), want.model.state_dict()
    assert gsd.keys() == wsd.keys()
    for k in wsd:
        assert torch.equal(gsd[k], wsd[k]), k
    go, wo = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert (go["count"], go["mini_step"]) == (wo["count"], wo["mini_step"])
    for name in ("mu", "nu", "acc"):
        if wo[name] is None:
            assert go[name] is None
            continue
        assert all(torch.equal(a, b) for a, b in zip(go[name], wo[name])), name
    assert got.step == want.step


@pytest.mark.parametrize("accumulate", [1, 2])
def test_save_restore_round_trip_and_resume(tmp_path, accumulate):
    """ResNet-18 simhand_w on the CPU: 2 steps, a save, a restore into a
    fresh state of another seed (every parameter, BatchNorm statistic,
    moment, accumulator, counter and the step bit-equal), then 1 more step
    equals 3 uninterrupted steps bit for bit. With accumulate=2 the save
    falls between two calls of one update."""
    batches = [torch_batch(i) for i in range(3)]
    state, step = new_state(0, accumulate)
    state = run(state, step, batches[:2])
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)
    assert mgr.save(2, state, {"contrastive_loss": 1.5})
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    assert sorted(os.listdir(tmp_path / "ckpt" / "2")) == ["metrics.json", "state.pt"]
    with open(tmp_path / "ckpt" / "2" / "metrics.json") as f:
        assert json.load(f) == {"contrastive_loss": 1.5}

    fresh, fresh_step = new_state(1, accumulate)
    assert not torch.equal(fresh.params[0], state.params[0])
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert restored is fresh
    assert_states_equal(fresh, state)
    if accumulate > 1:
        assert fresh.optimizer.mini_step == 0 and fresh.optimizer.count == 1
    tree = mgr.restore_tree()
    assert tree["step"] == 2 and tree["metrics"] == {"contrastive_loss": 1.5}

    resumed = run(fresh, fresh_step, batches[2:])
    straight, straight_step = new_state(0, accumulate)
    straight = run(straight, straight_step, batches)
    assert_states_equal(resumed, straight)
    assert resumed.step == 3


def test_restore_refuses_another_model_and_finds_nothing_in_an_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = tiny_state()
    assert mgr.restore(state) is None and mgr.restore_tree() is None
    assert mgr.best_step() is None and mgr.latest_step() is None
    mgr.save(1, state, {"contrastive_loss": 1.0})
    other = TrainState(nn.Linear(4, 2), state.optimizer)
    with pytest.raises(RuntimeError, match="size mismatch"):
        mgr.restore(other)
    # a save that fails leaves no step directory and no temporary one
    with pytest.raises(KeyError):
        mgr.save(2, state, {"loss": 1.0})
    assert os.listdir(tmp_path / "ckpt") == ["1"]


def test_export_matches_the_jax_export(tmp_path):
    """The .pth of export_torch_encoder equals, in keys and values, the one
    the JAX package writes for the same weights (carried over with
    from_flax_variables), and loads into a fresh port ResNet with
    strict=True."""
    jm = JModel(resnet_size="18")
    jstate = jax.device_get(jcreate(jm, JOpt(), jax.random.key(3),
                                    input_shape=(2, SIDE, SIDE, 3)))
    # non-trivial statistics, so a swapped mean and variance would show
    stats = jax.tree.map(lambda v: np.random.default_rng(0).uniform(0.5, 2, v.shape)
                         .astype(np.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    jexport(jstate, str(tmp_path / "jax.pth"))

    model = ContrastiveModel("18")
    model.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, jstate.params),
                                              jax.tree.map(np.asarray, stats)), strict=True)
    model.to(memory_format=torch.channels_last)
    state = TrainState(model, Optimizer(OptimizerConfig(), list(model.parameters()),
                                        decay_mask(model)))
    export_torch_encoder(state, str(tmp_path / "out" / "port.pth"))
    got = torch.load(tmp_path / "out" / "port.pth", weights_only=True)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], w), k
    fresh = RESNETS["18"]()
    fresh.load_state_dict(got, strict=True)
    assert torch.equal(fresh.conv1.weight, model.encoder.conv1.weight)
    assert os.listdir(tmp_path / "out") == ["port.pth"]
