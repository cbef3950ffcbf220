"""The port's last three tools on the CPU, against the JAX package's scripts:
``simhand_tpu_torch.bn_grid`` (``scripts/bn_grid.py``),
``simhand_tpu_torch.int8_quality`` (``scripts/int8_quality.py``) and
``simhand_tpu_torch.verify_release`` (``scripts/verify_release_artifact.py``).

- The grid: JAX's ``main`` with ``subprocess.run`` replaced by canned
  records (no cell runs) and the port's with its cell runner replaced by the
  same records launch the same cells in the same order with the same
  random-arm flags, and write the same JSONL and summary, from an empty
  file, a partly done one and one with lines that are not JSON (where JAX's
  summary raises and the port's skips them); every cell gets a new, empty
  directory. One real cell of the port's grid at 2/2 steps; a second run
  starts no cell and adds no line.
- The W8A8 quality check: a ResNet-18 detnet initialised by JAX with its
  BatchNorm statistics redrawn, carried into the port; the port's three
  arms and the arms built from the JAX functions the JAX script calls, each
  package's meters on the same images: every meter within rel 1e-5. The
  port's command line at 2 steps gives the JAX script's keys.
- The release check: the port's command line and JAX's script (a
  subprocess) print the same JSON line and exit code on
  tests/test_release_rehearsal.py's fabricated artifact and on a copy with
  one tensor reshaped.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.bn_grid as jgrid
import simhand_tpu_torch.constants as constants
from simhand_tpu.finetune.detnet import DetNet as JDetNet
from simhand_tpu.finetune.train import evaluate_detnet_forward as jevaluate
from simhand_tpu.serving import int8_infer as J
from simhand_tpu_torch import bn_grid, int8_quality, verify_release
from simhand_tpu_torch.finetune.datasets import DetnetSampleBuilder
from simhand_tpu_torch.finetune.detnet import DetNet
from simhand_tpu_torch.finetune.registry import build_composed_dataset
from simhand_tpu_torch.serving import int8_infer as P
from test_torch_contract import torchvision_resnet50_contract
from test_torch_resnet_depths import XLA_QUICK

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """BASE_PATH and the temporary directories under tmp_path (the constants
    reloaded), console logging only (a TensorBoard writer imports
    tensorflow, seconds)."""
    monkeypatch.setenv("BASE_PATH", str(tmp_path / "runs"))
    monkeypatch.setenv("TENSORBOARD_LOGS", "")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    importlib.reload(constants)
    yield tmp_path
    monkeypatch.undo()
    importlib.reload(constants)


# ---------------------------------------------------------------------------
# the release check: JAX's script runs in subprocesses, started first so that
# they overlap the tests before theirs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def release_runs(tmp_path_factory):
    """tests/test_release_rehearsal.py's fabricated artifact and a corrupt
    copy (one tensor reshaped), and JAX's script started on each."""
    rng = np.random.default_rng(0)
    sd = {}
    for key, shape in torchvision_resnet50_contract().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(100, dtype=torch.int64)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32))
    root = tmp_path_factory.mktemp("release")
    good, bad = str(root / "resnet50_simhand.pth"), str(root / "bad.pth")
    torch.save(sd, good)
    sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    torch.save(sd, bad)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    procs = {path: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "verify_release_artifact.py"), path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for path in (good, bad)}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_release_runs_started(release_runs):
    """Starts JAX's release checks (see test_verify_release_matches_jax)."""
    assert len(release_runs) == 2


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def canned(cell, force_skip_random: bool) -> dict:
    """A cell's record as the miniature would give it, without running it:
    numbers from the cell, the random arm where the JAX script's one-cell
    run would run it."""
    backbone, seed, variant, psteps = cell
    x = int(backbone) + 10 * seed + 0.5 * psteps + (variant == "exact")
    random = (None if variant != "exact" or force_skip_random
              else {"lossH_final": 0.4 + 0.01 * int(backbone), "hm_pck": 0.1})
    return {"cell": list(cell), "pretrained": {"lossH_final": 0.001 * x, "hm_pck": 0.5},
            "random": random}


FAILING = ["18", 0, "exact", 120]    # the first cell: the random arm goes to the next


def run_jax_grid(monkeypatch, out: str, argv: list):
    """JAX's main with its cells' processes replaced: the cells it would
    launch as (cell, --force_skip_random), its printed lines, and what it
    raised."""
    launched = []

    def fake_run(args, **kw):
        cell = json.loads(args[args.index("--one_cell") + 1])
        force = "--force_skip_random" in args
        launched.append((cell, force))
        if cell == FAILING:
            return types.SimpleNamespace(returncode=1, stdout="", stderr="boom")
        return types.SimpleNamespace(returncode=0, stdout=json.dumps(canned(cell, force)) + "\n",
                                     stderr="")

    raised = None
    with monkeypatch.context() as mp:
        mp.setattr(subprocess, "run", fake_run)
        try:
            jgrid.main(argv + ["--out", out])
        except json.JSONDecodeError as exc:
            raised = exc
    return launched, raised


def run_port_grid(out: str, argv: list):
    launched = []

    def runner(cell, finetune_steps, workdir, force_skip_random, device):
        assert os.path.isdir(workdir) and not os.listdir(workdir) and device == "cpu"
        launched.append((cell, force_skip_random))
        if cell == FAILING:
            raise RuntimeError("boom")
        return canned(cell, force_skip_random)

    summary = bn_grid.main(argv + ["--out", out, "--device", "cpu"], cell_runner=runner)
    return launched, summary


def printed(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


DONE = [canned(["18", 1, "exact", 120], False), canned(["18", 0, "stop_grad", 120], True)]


@pytest.mark.parametrize("start", ["empty", "partly_done", "malformed"])
def test_grid_plans_the_cells_of_jax(start, runs, monkeypatch, capsys):
    """3 seeds x {exact, stop_grad} at 120 steps and the rn50 arm at seed 0:
    the cells launched, their order, their random-arm flags, the JSONL and
    the printed lines (the error line of FAILING, the records, the summary)
    equal to JAX's; on a file with lines that are not JSON, JAX's summary
    raises and the port's skips those lines."""
    lines = {"empty": [], "partly_done": [json.dumps(r) for r in DONE],
             "malformed": ["{not json", json.dumps(DONE[0]), "[1, 2", json.dumps(DONE[1])]}
    files = {}
    for pkg in ("jax", "port"):
        files[pkg] = str(runs / f"{pkg}.jsonl")
        if lines[start]:
            with open(files[pkg], "w") as f:
                f.write("\n".join(lines[start]) + "\n")
    argv = ["--seeds", "3", "--pretrain_steps", "120", "--finetune_steps", "60"]
    want, raised = run_jax_grid(monkeypatch, files["jax"], argv)
    jax_lines = printed(capsys)
    got, summary = run_port_grid(files["port"], argv)
    port_lines = printed(capsys)

    assert got == want
    assert got[0][0] == FAILING
    assert len(got) == {"empty": 8, "partly_done": 6, "malformed": 6}[start]
    # the random arm once per backbone: on the first exact cell that succeeds
    assert [c for c, force in got if not force] == (
        [FAILING, ["18", 1, "exact", 120], ["50", 0, "exact", 60]] if start == "empty"
        else [["50", 0, "exact", 60]])
    with open(files["jax"]) as a, open(files["port"]) as b:
        assert a.read() == b.read()
    errors = [line for line in port_lines if "error" in line]
    assert [e["cell"] for e in errors] == [FAILING] and "boom" in errors[0]["error"]
    assert ([line for line in port_lines if "error" not in line][:-1]
            == [line for line in jax_lines if "error" not in line][:len(got) - 1])
    assert port_lines[-1] == summary and summary["cells"] == len(got) - 1 + len(DONE) * (
        start != "empty")
    if start == "malformed":
        assert isinstance(raised, json.JSONDecodeError)
    else:
        assert raised is None and jax_lines[-1] == summary


# ---------------------------------------------------------------------------
# the W8A8 quality check
# ---------------------------------------------------------------------------

BACKBONE, CALIB_BATCH, VAL_N = "18", 4, 4
# the int8 arm's meters that follow an argmax: a heatmap peak of the int8
# walk can be near-tied, and the float32 deconvolutions (XLA's and
# oneDNN's, which round differently) feed the map heads' quantization, so
# a rounding flip there can move a joint's argmax (measured on these
# VAL_N = 4 images: epe_mean 1.4e-4, epe_median 4.1e-4, the heatmap meters
# equal; on 16 images one joint moved: hm_dist 1.5e-3, epe_median 4.4e-3,
# hm_pck_loose by one joint); every other meter within rel 1e-5 (measured
# <= 1.1e-8)
INT8_ARGMAX_RTOL = {"hm_dist": 5e-3, "epe_mean": 5e-3, "epe_median": 5e-3}


def _stats(model: torch.nn.Module, seed: int) -> None:
    """BatchNorm statistics away from the init's 0 / 1."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.normal(size=buf.shape)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(0.5 + rng.random(buf.shape)))


@pytest.fixture(scope="module")
def int8_cli(tmp_path_factory):
    """The port's command line at 2 steps, B = 4, val split VAL_N, run once
    for the module: its workdir, the last line it printed, its result."""
    root = tmp_path_factory.mktemp("int8_cli")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BASE_PATH", str(root / "runs"))
        mp.setenv("TENSORBOARD_LOGS", "")
        mp.setattr(tempfile, "tempdir", str(root))
        mp.setattr(int8_quality, "VAL_N", VAL_N)
        importlib.reload(constants)
        try:
            with contextlib.redirect_stdout(out):
                result = int8_quality.main(["--train_steps", "2", "--batch_size",
                                            str(CALIB_BATCH), "--device", "cpu",
                                            "--workdir", str(root / "w")])
        finally:
            mp.undo()
            importlib.reload(constants)
    return root / "w", out.getvalue().strip().splitlines()[-1], result


class SameImages:
    """The port's val-style builder in the JAX builder's call form, so that
    both packages' meters see the same images (the two builders' cv2 and
    image-stage resizes differ by a grey level in places)."""

    def __init__(self):
        self.builder = DetnetSampleBuilder(train=False)

    def __call__(self, sample, rng):
        return self.builder(sample, rng)


def test_int8_quality_arms_match_jax(int8_cli, tmp_path, monkeypatch):
    """The three arms of one ResNet-18 detnet at 128² (the detnet.pth that
    the command line's 2-step fine-tune shipped, its BatchNorm statistics
    redrawn), written as a detnet.pth and read by each package as its
    script reads the shipped file (JAX's
    torch_state_dict_to_detnet, the port's load_detnet_state_dict): the JAX
    script's forwards (the flax apply, fold_detnet_f32, build_detnet_int8
    calibrated on two train batches) against the port's measure_arms, each
    package's evaluate_detnet_forward on the same VAL_N images. Every meter
    within rel 1e-5 (the int8 arm's argmax-led ones within
    INT8_ARGMAX_RTOL), the same int8 sites, the deltas of int8 less
    fold_f32 the same.

    The port calibrates for itself (its scales are held within rel 1e-5 of
    JAX's here) and then quantizes under JAX's scales: a scale's last bits
    move single activations across a rounding boundary. Under the same
    scales every int8 activation of the backbone equals JAX's
    (tests/test_torch_int8_infer.py)."""
    from simhand_tpu.finetune.torch_port_detnet import torch_state_dict_to_detnet
    from simhand_tpu_torch.convert import load_detnet_state_dict
    from simhand_tpu_torch.train.checkpoint import export_state_dict

    shipped = DetNet(BACKBONE)
    load_detnet_state_dict(shipped, torch.load(int8_cli[0] / "ft" / "detnet.pth",
                                               map_location="cpu", weights_only=True))
    _stats(shipped, 0)
    export_state_dict(shipped, str(tmp_path / "detnet.pth"))
    sd = torch.load(tmp_path / "detnet.pth", map_location="cpu", weights_only=True)
    det = DetNet(BACKBONE)
    load_detnet_state_dict(det, sd)
    params, stats = torch_state_dict_to_detnet({k: v.numpy() for k, v in sd.items()})
    dv = {"params": params, "batch_stats": stats}
    jdet = JDetNet(resnet_size=BACKBONE, dtype=jnp.float32)

    train_ds = build_composed_dataset("synthetic-hand", None, "train", synthetic_n=64)
    val_ds = build_composed_dataset("synthetic-hand", None, "val", synthetic_n=VAL_N)
    calib = int8_quality.calibration_batches(train_ds, CALIB_BATCH)
    qforward, report = J.build_detnet_int8(dv, BACKBONE,
                                           calib_batches=[jnp.asarray(c) for c in calib])
    build = P.build_detnet_int8

    def under_jax_scales(model, backbone, calib_batches=None):
        _, own = build(model, backbone, calib_batches=calib_batches)
        assert own["scales"].keys() == report["scales"].keys()
        for k, v in own["scales"].items():
            assert abs(v - report["scales"][k]) <= 1e-5 * report["scales"][k], k
        return P._int8_detnet(model, backbone, report["scales"]), own

    monkeypatch.setattr(P, "build_detnet_int8", under_jax_scales)
    got = int8_quality.measure_arms(det, BACKBONE, calib, val_ds, VAL_N, "cpu")

    arms = {"eval": jax.jit(lambda img: jdet.apply(dv, img, train=False),
                            compiler_options=XLA_QUICK),
            "fold_f32": jax.jit(J.fold_detnet_f32(dv, BACKBONE), compiler_options=XLA_QUICK),
            "int8": jax.jit(qforward, compiler_options=XLA_QUICK)}
    want = {name: jevaluate(fn, val_ds, SameImages(), VAL_N) for name, fn in arms.items()}

    for name in arms:
        assert got[name].keys() == want[name].keys() >= {"hm_pck", "epe_mean", "auc"}
        for k, w in want[name].items():
            rtol = INT8_ARGMAX_RTOL.get(k, 1e-5) if name == "int8" else 1e-5
            assert abs(got[name][k] - w) <= rtol * abs(w) + 1e-12, (name, k, got[name][k], w)
    assert got["int8_sites"] == report["sites"] == 21
    assert got["delta_int8_vs_f32"].keys() == set(int8_quality.DELTA_METERS)
    for k, d in got["delta_int8_vs_f32"].items():
        w = want["int8"][k] - want["fold_f32"][k]
        assert abs(d - w) <= INT8_ARGMAX_RTOL.get(k, 1e-5) * abs(want["int8"][k]) + 1e-12, k


def test_int8_quality_command_line(int8_cli):
    """python -m simhand_tpu_torch.int8_quality at 2 steps, B = 4, on the
    CPU (a val split of VAL_N for time): the JAX script's keys, with "eval"
    for its "flax", every meter finite; the JSON line printed is the
    result."""
    _, printed_line, result = int8_cli
    assert json.loads(printed_line) == result
    assert result.keys() == {"eval", "fold_f32", "int8", "int8_sites", "delta_int8_vs_f32"}
    for arm in ("eval", "fold_f32", "int8"):
        assert result[arm].keys() == {"hm_pck", "hm_pck_loose", "hm_dist", "epe_mean",
                                      "epe_median", "auc"}
        assert all(np.isfinite(v) for v in result[arm].values())
    assert result["int8_sites"] == 21
    assert result["delta_int8_vs_f32"].keys() == set(int8_quality.DELTA_METERS)


# the grid's real cell comes after the int8 check's fine-tune, which pays
# the process's first fine-tune set-up for both

def test_one_real_cell_then_resume(runs, capsys):
    """The port's grid at one rn18 stop_grad cell, 2/2 steps, on the CPU:
    one record with the JAX script's metric keys, every value finite, no
    random arm; a second run starts no cell and adds no line."""
    out = str(runs / "grid.jsonl")
    argv = ["--seeds", "1", "--variants", "stop_grad", "--rn50_seed", "-1",
            "--pretrain_steps", "2", "--finetune_steps", "2", "--out", out,
            "--workdir", str(runs / "cells"), "--device", "cpu"]
    summary = bn_grid.main(argv)
    [rec] = bn_grid.read_records(out)
    assert rec["cell"] == ["18", 0, "stop_grad", 2] and rec["random"] is None
    assert rec["pretrained"].keys() == {"lossH_final", "hm_pck", "auc", "hm_pck_loose",
                                        "hm_dist"}
    assert all(np.isfinite(v) for v in rec["pretrained"].values())
    assert summary == {"summary_lossH_mean": {"rn18_stop_grad": rec["pretrained"]["lossH_final"]},
                       "cells": 1}

    def no_cell(*a):
        raise AssertionError("a done cell was started again")

    with open(out) as f:
        before = f.read()
    assert bn_grid.main(argv, cell_runner=no_cell) == summary
    with open(out) as f:
        assert f.read() == before


# ---------------------------------------------------------------------------
# the release check
# ---------------------------------------------------------------------------

def test_contract_copy_is_the_tests_table():
    assert verify_release.TORCHVISION_RESNET50 == torchvision_resnet50_contract()
    assert list(verify_release.TORCHVISION_RESNET50) == list(torchvision_resnet50_contract())
    assert len(verify_release.TORCHVISION_RESNET50) == 320


def test_verify_release_matches_jax(release_runs, capsys):
    """The port's command line (--device cpu) against JAX's script on the
    fabricated artifact (ok, 318 keys, the round trip exact) and on the
    corrupt copy (exit 1, the shape named): the same JSON line, the same
    exit code."""
    results = []
    for path, proc in release_runs.items():
        out, err = proc.communicate(timeout=300)
        want = json.loads(out.strip().splitlines()[-1])
        rc = verify_release.main([path, "--device", "cpu"])
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (got, rc) == (want, proc.returncode), err[-2000:]
        assert not os.path.exists(path + ".roundtrip")
        results.append(got)
    good, bad = results
    assert good == {"ok": True, "keys_checked": 318, "roundtrip_exact": True, "problems": []}
    assert bad["ok"] is False and bad["roundtrip_exact"] is None
    assert bad["problems"] == ["shape mismatch layer1.0.conv1.weight: artifact (64, 64, 3, 3) "
                               "vs contract (64, 64, 1, 1)"]
