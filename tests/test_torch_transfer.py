"""The port's transfer check (``simhand_tpu_torch.transfer_check``) on the CPU:
its own run through the command line at a toy budget; the two mains it drives,
on its argv and cache, against the JAX package's mains from the same initial
weights; and, marked slow, the JAX package's tests/test_transfer.py on the
port at that file's budgets and margins.
"""
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import simhand_tpu.constants as jconstants
import simhand_tpu.experiments.config as jcfg
import simhand_tpu.experiments.main as jmain
import simhand_tpu.train as jtrain
import simhand_tpu_torch.constants as constants
import simhand_tpu_torch.experiments.config as cfg
import simhand_tpu_torch.experiments.main as main_mod
from simhand_tpu_torch import transfer_check as T
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.finetune import train as ft
from simhand_tpu_torch.utils.logging import MetricLogger
from test_torch_main import small_config, spy_logger

pytest.importorskip("cv2")
torch.set_num_threads(2)
METRICS = {"lossH_final", "hm_pck", "auc", "hm_pck_loose", "hm_dist"}


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """BASE_PATH under tmp_path (the constants reloaded), console logging
    only (a TensorBoard writer imports tensorflow, seconds)."""
    monkeypatch.setenv("BASE_PATH", str(tmp_path / "runs"))
    monkeypatch.setenv("TENSORBOARD_LOGS", "")
    importlib.reload(constants)
    importlib.reload(jconstants)
    yield tmp_path
    monkeypatch.undo()
    importlib.reload(constants)
    importlib.reload(jconstants)


def test_transfer_check_runs_and_lands_the_export(runs, capsys):
    """python -m simhand_tpu_torch.transfer_check at 2/2 steps, B = 8,
    ResNet-18, --device cpu: one JSON line with the JAX script's keys, every
    value finite, and the pretrained arm's encoder equal to the export bit
    for bit before its first fine-tune step."""
    workdir = runs / "w"
    export = workdir / "encoder_pretrained.pth"
    landed = []
    real = ft.make_detnet_train_step

    def landing(model, *a, **k):
        if export.exists():      # the pretrained arm (the random one runs first)
            sd = torch.load(export, weights_only=True)
            enc = {k: v for k, v in model.encoder.resnet.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
            landed.append(sd.keys() == enc.keys()
                          and all(torch.equal(sd[k], enc[k]) for k in sd))
        return real(model, *a, **k)

    ft.make_detnet_train_step = landing
    try:
        result = T.main(["--pretrain_steps", "2", "--finetune_steps", "2", "--batch_size", "8",
                         "--device", "cpu", "--workdir", str(workdir)])
    finally:
        ft.make_detnet_train_step = real
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert result.keys() == {"random", "pretrained"}
    for arm in result.values():
        assert arm.keys() == METRICS and all(np.isfinite(v) for v in arm.values())
    assert landed == [True]


def test_transfer_pretraining_matches_jax(runs, monkeypatch):
    """The transfer check's pre-training argv (2 steps, B = 8, ResNet-18, on
    its crop cache, host augmentation: the two packages draw the card's
    augmentation from other generators) through both packages' mains, from
    JAX's initial weights, in test_torch_main.py's small float32 32x32
    config: the epoch loss within that file's rel 1e-4, and both exports
    with the same keys. JAX sees one device. The fine-tune arms are held in
    test_torch_finetune_main.py (test_transfer_check_arms_match_jax), whose
    module fixture has compiled JAX's fine-tune already."""
    root = runs
    config = small_config(root / "training_config.json")
    monkeypatch.setattr(cfg, "TRAINING_CONFIG_PATH", config)
    monkeypatch.setattr(jcfg, "TRAINING_CONFIG_PATH", config)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    cache = T.build_corpus(str(root / "cache"))

    # pre-training: JAX's main, then the port's from JAX's initial weights
    init = {}
    jcreate = jtrain.create_train_state

    def recording_create(*a, **k):
        state = jcreate(*a, **k)
        init["sd"] = from_flax_variables(jax.tree.map(np.asarray, jax.device_get(state.params)),
                                         jax.tree.map(np.asarray,
                                                      jax.device_get(state.batch_stats)))
        return state

    monkeypatch.setattr(jtrain, "create_train_state", recording_create)
    jlog = importlib.import_module("simhand_tpu.utils.logging")
    jmetrics, _ = spy_logger(monkeypatch, jlog.MetricLogger)
    jax_pth = str(root / "jax.pth")
    monkeypatch.setattr(sys, "argv", ["main.py", *T.pretrain_argv(str(root / "jax"), cache,
                                                                  jax_pth, 2, 8)])
    assert int(np.asarray(jmain.main().step)) == 2
    create = main_mod.create_train_state

    def loading_create(model, *a, **k):
        state = create(model, *a, **k)
        model.load_state_dict(init["sd"], strict=True)
        return state

    monkeypatch.setattr(main_mod, "create_train_state", loading_create)
    metrics, _ = spy_logger(monkeypatch, MetricLogger)
    state = main_mod.main(T.pretrain_argv(str(root / "port"), cache, str(root / "port.pth"), 2,
                                          8) + ["--device", "cpu"])
    assert state.step == 2

    def epoch_losses(log):
        return [m["contrastive_loss_epoch"] for _, m in log if "contrastive_loss_epoch" in m]

    want, got = epoch_losses(jmetrics), epoch_losses(metrics)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (torch.load(root / "port.pth", weights_only=True).keys()
            == torch.load(jax_pth, weights_only=True).keys())


@pytest.mark.filterwarnings("ignore")
@pytest.mark.slow
def test_pretraining_transfers_on_synthetic(runs):
    """tests/test_transfer.py's first test on the port: at 40/40 steps the
    pretrained arm's lossH ends below 0.98 x the random arm's."""
    result = T.run_transfer_check(str(runs / "w"), pretrain_steps=40, finetune_steps=40,
                                  batch_size=16, device="cpu")
    rand, pre = result["random"], result["pretrained"]
    assert np.isfinite(rand["lossH_final"]) and np.isfinite(pre["lossH_final"])
    assert pre["lossH_final"] < 0.98 * rand["lossH_final"], result


@pytest.mark.filterwarnings("ignore")
@pytest.mark.slow
def test_similar_hand_positives_beat_simclr(tmp_path):
    """tests/test_transfer.py's second test on the port: at 60/60 steps,
    each arm in a fresh interpreter, simhand_w's pretrained lossH ends below
    simclr's."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def arm(expt):
        env = {**os.environ, "PYTHONPATH": repo, "BASE_PATH": str(tmp_path / f"runs_{expt}")}
        out = subprocess.run(
            [sys.executable, "-m", "simhand_tpu_torch.transfer_check",
             "--experiment_type", expt, "--pretrain_steps", "60", "--finetune_steps", "60",
             "--skip_random", "--device", "cpu", "--workdir", str(tmp_path / expt)],
            env=env, capture_output=True, text=True, timeout=3600, cwd=tmp_path,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    sim = arm("simhand_w")
    clr = arm("simclr")
    assert sim["pretrained"]["lossH_final"] < clr["pretrained"]["lossH_final"], (sim, clr)
