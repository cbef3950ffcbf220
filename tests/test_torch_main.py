"""The port's pre-training entry point (``simhand_tpu_torch.experiments.main``)
end to end on the CPU: against the JAX package's ``main`` on the same data
and weights, alone through its train / resume / eval cycle, preemption
drill, ``--vis`` dump and ``--device_augment`` validation, and on the
card's route in a process where the optional packages cannot be imported.

Every run reads a small training config (float32, 32x32 views) patched
into each package's ``TRAINING_CONFIG_PATH``, and writes under its own
``BASE_PATH``.
"""
import importlib
import json
import logging
import os
import pathlib
import subprocess
import sys
import textwrap

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
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models.resnet import RESNETS
from simhand_tpu_torch.train import OptimizerConfig, make_schedule
from simhand_tpu_torch.train.checkpoint import CheckpointManager
from simhand_tpu_torch.utils.logging import MetricLogger
from test_torch_train_step import assert_states_match

pytest.importorskip("cv2")
torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
SIDE, B = 32, 8
OPTIONAL = ("cv2", "yaml", "matplotlib", "tensorboard", "tensorflow", "orbax")
# RECIPES.md's flags without color jitter, at a toy size
RECIPE = ["--experiment_type", "simhand_w", "--weight_type", "linear", "--diff_type", "mpjpe",
          "--pos_neg", "pos_neg", "--joints_type", "original", "--crop", "--resize", "--rotate",
          "-sources", "synthetic", "-batch_size", str(B), "-resnet_size", "18"]


def small_config(path: pathlib.Path) -> str:
    with open(REPO / "simhand_tpu_torch/experiments/config/training_config.json") as f:
        tc = json.load(f)
    tc["precision"] = "32"
    tc["augmentation_params"]["resize_shape"] = [SIDE, SIDE]
    path.write_text(json.dumps(tc))
    return str(path)


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """BASE_PATH under tmp_path (the constants reloaded) and the small
    training config in both packages; yields the data dir."""
    monkeypatch.setenv("BASE_PATH", str(tmp_path / "runs"))
    importlib.reload(constants)
    importlib.reload(jconstants)
    config = small_config(tmp_path / "training_config.json")
    monkeypatch.setattr(cfg, "TRAINING_CONFIG_PATH", config)
    monkeypatch.setattr(jcfg, "TRAINING_CONFIG_PATH", config)
    yield tmp_path
    monkeypatch.undo()
    importlib.reload(constants)
    importlib.reload(jconstants)


def port_main(root, *extra, name="run"):
    return main_mod.main(RECIPE + ["--data_dir", str(root / "data"), "-experiment_name", name,
                                   "--device", "cpu", *extra])


def spy_logger(monkeypatch, cls) -> tuple[list, list]:
    """Records the metrics and figure names each MetricLogger of ``cls``
    logs."""
    metrics, figures = [], []
    log_metrics, log_figure = cls.log_metrics, cls.log_figure

    def spy_metrics(self, m, step):
        metrics.append((step, {k: float(v) for k, v in m.items()}))
        return log_metrics(self, m, step)

    def spy_figure(self, name, fig, step):
        figures.append(name)
        return log_figure(self, name, fig, step)

    monkeypatch.setattr(cls, "log_metrics", spy_metrics)
    monkeypatch.setattr(cls, "log_figure", spy_figure)
    return metrics, figures


def step_losses(metrics) -> list:
    return [m["contrastive_loss"] for _, m in metrics if "contrastive_loss" in m]


def test_main_matches_jax(runs, monkeypatch):
    """simhand_w on the host route, ResNet-18, B = 8, 32x32 float32, lr
    1e-2, 3 steps with -log_interval step, from JAX's initial weights (the
    port's create_train_state is patched to load them). JAX sees one device
    (its main would shard the batch over the test harness's 8 and run
    BatchNorm per shard). Per-step losses and the exported encoders within
    tests/test_torch_train_step.py's tolerances for the dense B = 8 step:
    losses rel 1e-4; parameters within 2 * sum(lr) elementwise, weight
    updates to 0.25 of their norm, BatchNorm statistics to 3e-2 of their
    largest."""
    root = runs
    argv = RECIPE + ["--data_dir", str(root / "data"), "-lr", "1e-2", "-epochs", "1",
                     "--max_steps", "3", "-log_interval", "step"]
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    # console logging only: JAX's TensorBoard writer (tensorflow) costs seconds
    monkeypatch.setattr(jconstants, "TENSORBOARD_LOGS", "")
    monkeypatch.setattr(constants, "TENSORBOARD_LOGS", "")
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
    monkeypatch.setattr(sys, "argv", ["main.py", *argv, "-experiment_name", "jax",
                                      "--export_torch", str(root / "jax.pth")])
    jstate = jmain.main()
    assert int(np.asarray(jstate.step)) == 3

    create = main_mod.create_train_state
    opt = {}

    def loading_create(model, opt_cfg, *a, **k):
        state = create(model, opt_cfg, *a, **k)
        model.load_state_dict(init["sd"], strict=True)
        opt["cfg"] = opt_cfg
        return state

    monkeypatch.setattr(main_mod, "create_train_state", loading_create)
    metrics, _ = spy_logger(monkeypatch, MetricLogger)
    state = main_mod.main(argv + ["-experiment_name", "port", "--device", "cpu",
                                  "--export_torch", str(root / "port.pth")])
    assert state.step == 3 and state.optimizer.count == 3

    want, got = step_losses(jmetrics), step_losses(metrics)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # 3 steps, then the epoch's mean
    assert [s for s, _ in metrics] == [s for s, _ in jmetrics] == [1, 2, 3, 3]
    stats = [m for _, m in metrics if "proj1x_mean" in m]
    jstats = [m for _, m in jmetrics if "proj1x_mean" in m]
    assert len(stats) == 3 and stats[0].keys() == jstats[0].keys()

    got_sd = torch.load(root / "port.pth", weights_only=True)
    want_sd = torch.load(root / "jax.pth", weights_only=True)
    assert sorted(got_sd) == sorted(want_sd)
    lrs = [make_schedule(opt["cfg"])(i) for i in range(3)]
    assert lrs[0] == 0.0 and lrs[2] > lrs[1] > 0
    assert_states_match(init["sd"], {f"encoder.{k}": v for k, v in want_sd.items()},
                        {f"encoder.{k}": v for k, v in got_sd.items()}, lrs,
                        update_rtol=0.25, stats_rtol=3e-2, bn_too=False)
    assert opt["cfg"] == OptimizerConfig(lr=1e-2, weight_decay=1e-6, optimizer="LARS",
                                         warmup_epochs=10, epochs=1,
                                         train_iters_per_epoch=256 // B)


def test_train_resume_eval_cycle(runs, caplog):
    """Train 2 steps and checkpoint; resume (the saved tensors restored bit
    for bit) for 2 more; evaluate the latest checkpoint twice; -checkpoint
    restores a named step and refuses a missing one."""
    root = runs
    caplog.set_level(logging.INFO, logger="simhand_tpu_torch")
    state = port_main(root, "-epochs", "1", "--max_steps", "2")
    assert state.step == 2
    ckpt = root / "runs" / "saved_models" / "run" / "checkpoints"
    mgr = CheckpointManager(str(ckpt))
    assert mgr.all_steps() == [2]
    saved = mgr.restore_tree()
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2

    resumed = {}
    create = main_mod.create_train_state

    def watching_create(*a, **k):
        resumed["state"] = state = create(*a, **k)
        return state

    real_restore = CheckpointManager.restore

    def checking_restore(self, st, step=None):
        out = real_restore(self, st, step)
        sd = out.model.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in saved["model"].items())
        assert all(torch.equal(a, b) for a, b in
                   zip(out.optimizer.state_dict()["mu"], saved["optimizer"]["mu"]))
        resumed["checked"] = out.step
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(main_mod, "create_train_state", watching_create)
    mp.setattr(CheckpointManager, "restore", checking_restore)
    try:
        state2 = port_main(root, "-epochs", "1", "--max_steps", "2", "--resume")
    finally:
        mp.undo()
    assert resumed["checked"] == 2
    assert state2.step == 4 and state2.optimizer.count == 4
    # the resumed run's own step count (2) is not past the saved step: no save
    assert mgr.all_steps() == [2]

    evals = []
    for _ in range(2):
        caplog.clear()
        state3 = port_main(root, "-epochs", "1", "--eval")
        assert state3.step == 2
        evals += [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("eval contrastive_loss")]
    assert len(evals) == 2 and evals[0] == evals[1]
    assert np.isfinite(float(evals[0].split()[-1]))

    state4 = port_main(root, "-epochs", "1", "--max_steps", "1", "-checkpoint", "epoch=2-step")
    assert state4.step == 3
    with pytest.raises(FileNotFoundError, match="step 7"):
        port_main(root, "-checkpoint", "step7")
    with pytest.raises(ValueError, match="no step number"):
        port_main(root, "-checkpoint", "last")


def test_fault_injected_preemption_checkpoints_and_exits(runs):
    """--fault_inject_preempt_step takes the SIGTERM path: a checkpoint at
    that step, then the run stops; the SIGTERM handler is put back."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    state = port_main(runs, "-epochs", "5", "--fault_inject_preempt_step", "2", name="pre")
    assert state.step == 2
    mgr = CheckpointManager(str(runs / "runs" / "saved_models" / "pre" / "checkpoints"))
    assert mgr.all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before


def test_vis_dump_profile_and_registry(runs):
    """--vis/--vis_save_dir writes the per-iteration npy of the pair;
    --profile_dir a Chrome trace; -meta_file the registry row; --debug the
    debug log."""
    vis_dir = runs / "vis"
    port_main(runs, "-epochs", "1", "--max_steps", "1", "--vis", "--vis_save_dir", str(vis_dir),
              "--profile_dir", str(runs / "prof"), "-meta_file", str(runs / "meta.csv"),
              "-experiment_key", "k1", "--debug", name="vis")
    files = sorted(os.listdir(vis_dir))
    assert files == ["iter_0000001.npy"]
    dump = np.load(vis_dir / files[0], allow_pickle=True).item()
    assert {"transformed_image1", "transformed_image2", "joints1_ori", "joints2_aug"} <= set(dump)
    assert dump["transformed_image1"].shape == (B, SIDE, SIDE, 3)
    trace = json.loads((runs / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (runs / "meta.csv").read_text().splitlines()[1].startswith("vis,k1,")
    assert (runs / "runs" / "meta" / "debug" / "vis.log").exists()
    logging.getLogger("simhand_tpu_torch.debug.vis").handlers.clear()


def test_device_augment_run_logs_val_metric_and_figure(runs, monkeypatch):
    """--device_augment with -train_ratio 0.9: a full epoch of raw batches
    augmented on the device, a finite contrastive_loss_val (24 held-out
    samples) and the sample-pair figure."""
    metrics, figures = spy_logger(monkeypatch, MetricLogger)
    state = port_main(runs, "-epochs", "1", "--device_augment", "-train_ratio", "0.9",
                      name="dev")
    assert state.step == 256 // B
    val = [m["contrastive_loss_val"] for _, m in metrics if "contrastive_loss_val" in m]
    assert len(val) == 1 and np.isfinite(val[0])
    assert figures == ["sample_pair"]
    assert os.listdir(runs / "runs" / "tb_logs" / "dev")


# the card's machine has tensorboard but none of the others
@pytest.mark.parametrize("blocked", [OPTIONAL, tuple(m for m in OPTIONAL if m != "tensorboard")],
                         ids=["none", "tensorboard"])
def test_the_cards_route_needs_no_optional_package(tmp_path, blocked):
    """In a process where importing cv2, yaml, matplotlib, tensorflow, orbax
    and (in the first case) tensorboard fails: --cache_dir on an existing
    cache with --device_augment --device cpu trains past the sample-pair
    figure's step (not drawn without matplotlib), checkpoints, resumes and
    exports."""
    from simhand_tpu_torch.data.cache import build_crop_cache
    from simhand_tpu_torch.data.sources import SyntheticHandSource

    cache = tmp_path / "cache"
    build_crop_cache(SyntheticHandSource(48, num_videos=4, side=96, seed=1), str(cache),
                     shard_size=20)
    config = small_config(tmp_path / "training_config.json")
    script = textwrap.dedent(f"""
        import sys
        for name in {blocked!r}:
            sys.modules[name] = None
        import torch
        import simhand_tpu_torch.experiments.config as cfg
        import simhand_tpu_torch.experiments.main as main_mod
        cfg.TRAINING_CONFIG_PATH = {config!r}
        argv = {RECIPE!r} + ["--cache_dir", {str(cache)!r}, "--device_augment",
                             "--device", "cpu", "-epochs", "2", "-train_ratio", "0.5",
                             "-experiment_name", "card"]
        state = main_mod.main(argv + ["--max_steps", "5"])
        assert state.step == 5, state.step
        state = main_mod.main(argv + ["--resume", "--max_steps", "2",
                                      "--export_torch", {str(tmp_path / "enc.pth")!r}])
        assert state.step == 7, state.step
        sd = torch.load({str(tmp_path / "enc.pth")!r}, weights_only=True)
        from simhand_tpu_torch.models.resnet import RESNETS
        RESNETS["18"]().load_state_dict(sd, strict=True)
        import pathlib
        ckpt = pathlib.Path({str(tmp_path / "runs" / "saved_models" / "card" / "checkpoints")!r})
        print("steps", sorted(p.name for p in ckpt.iterdir()))
        print("card route; ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO), "BASE_PATH": str(tmp_path / "runs")}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "card route; ok" in res.stdout
    assert "steps ['5']" in res.stdout
    assert ("TensorBoard logging disabled" in res.stderr) == ("tensorboard" in blocked)
    if "tensorboard" not in blocked:
        assert os.listdir(tmp_path / "runs" / "tb_logs" / "card")


def test_main_needs_a_card_unless_asked_for_the_cpu(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_mod.main(RECIPE + ["--data_dir", str(runs / "data")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_mod.main(RECIPE + ["--device", "cpu"], device="cuda")
    assert not (runs / "data").exists()
