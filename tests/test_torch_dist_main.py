"""The port's pre-training entry point on two ranks: two processes joined
by ``torch.distributed`` over gloo on the CPU (the torchrun-style
environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
``experiments/main.py`` taking its data-parallel route, against the
thread-axis step of ``torch_thread_axis`` on the batches each rank took.

The two processes share one deadline and are killed when it passes: a
gloo run can hang (ROUND5.md, section 2, records one in the JAX smoke).
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from simhand_tpu_torch.data.sources import generate_synthetic_hand100m
from simhand_tpu_torch.models import ContrastiveModel
from simhand_tpu_torch.train import create_train_state, make_train_step
from torch_thread_axis import run_ranks

pytest.importorskip("cv2")
torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
W, B, SIDE, STEPS, DEADLINE_S = 2, 8, 32, 2, 240

# one rank: main() with the small config, recording what its steps saw
RANK = textwrap.dedent("""
    import copy, sys
    import torch
    import simhand_tpu_torch.constants as constants
    import simhand_tpu_torch.experiments.config as cfg
    import simhand_tpu_torch.experiments.main as m

    cfg.TRAINING_CONFIG_PATH, out = sys.argv[1], sys.argv[2]
    constants.TENSORBOARD_LOGS = ""     # console logging only: no TensorBoard import
    rec = {"losses": [], "batches": []}
    make = m.make_train_step

    def recording(model, ccfg, augment=None, axis=None):
        step = make(model, ccfg, augment=augment, axis=axis)

        def run(state, batch):
            if not rec["batches"]:
                rec.update(init=copy.deepcopy(model.state_dict()), ccfg=ccfg,
                           opt_cfg=state.optimizer.cfg, rank=axis.index, size=axis.size)
            rec["batches"].append({k: v.clone() for k, v in batch.items()})
            state, metrics = step(state, batch)
            rec["losses"].append(float(metrics["contrastive_loss"]))
            return state, metrics
        return run

    m.make_train_step = recording
    state = m.main(sys.argv[3:], device="cpu")
    rec["final"] = state.model.state_dict()
    torch.save(rec, out)
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_main_matches_the_thread_axis(tmp_path):
    """simhand_w, ResNet-18, 32x32 float32, global B = 8 (4 a rank), 2
    steps and a sharded validation batch of 8 samples: both processes end with
    equal parameters and statistics (bit for bit), took disjoint rows of
    the same global batches, and their losses equal those of the thread
    axis's step from the same initial state on the same rows (rel 1e-6:
    the same arithmetic; gloo's sum of two terms is the thread axis's)."""
    with open(REPO / "simhand_tpu_torch/experiments/config/training_config.json") as f:
        tc = json.load(f)
    tc.update(precision="32", train_ratio=0.875)
    tc["augmentation_params"]["resize_shape"] = [SIDE, SIDE]
    config = tmp_path / "training_config.json"
    config.write_text(json.dumps(tc))
    data = tmp_path / "data"
    generate_synthetic_hand100m(str(data / "synthetic"), num_images=64, num_videos=16)
    argv = ["--experiment_type", "simhand_w", "--crop", "--resize", "--rotate",
            "-sources", "synthetic", "-batch_size", str(B), "-resnet_size", "18",
            "--data_dir", str(data), "-epochs", "1", "--max_steps", str(STEPS),
            "-experiment_name", "dist"]
    port = free_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), BASE_PATH=str(tmp_path / "runs"),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(config), str(tmp_path / f"rank{r}.pt"), *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * W, "\n".join(logs)[-4000:]

    recs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(W)]
    assert [(r["rank"], r["size"]) for r in recs] == [(0, W), (1, W)]
    assert recs[0]["final"].keys() == recs[1]["final"].keys()
    assert all(torch.equal(recs[0]["final"][k], recs[1]["final"][k]) for k in recs[0]["final"])
    assert all(torch.equal(recs[0]["init"][k], recs[1]["init"][k]) for k in recs[0]["init"])
    assert len(recs[0]["losses"]) == STEPS and recs[0]["losses"] == recs[1]["losses"]
    for s in range(STEPS):
        a, b = (r["batches"][s]["transformed_image1"] for r in recs)
        assert a.shape[0] == b.shape[0] == B // W and not torch.equal(a, b)

    def thread_rank(axis):
        rec = recs[axis.index]
        model = ContrastiveModel("18")
        state = create_train_state(model, rec["opt_cfg"], 0, input_shape=(2, SIDE, SIDE, 3),
                                   device="cpu")
        model.load_state_dict(rec["init"], strict=True)
        step, losses = make_train_step(model, rec["ccfg"], axis=axis), []
        for batch in rec["batches"]:
            state, metrics = step(state, batch)
            losses.append(float(metrics["contrastive_loss"]))
        return losses

    for losses in run_ranks(W, thread_rank):
        np.testing.assert_allclose(losses, recs[0]["losses"], rtol=1e-6)


@pytest.mark.parametrize("set_on", [(), (1,), (0, 2)])
def test_any_rank_agrees_on_a_host_flag(set_on):
    """The preemption flag that main agrees on at each step: set on any
    rank, every rank reads it set; set on none, none does."""
    got = run_ranks(3, lambda axis: axis.any_rank(axis.index in set_on))
    assert got == [bool(set_on)] * 3
