"""The port's fine-tune metrics and its two entry points
(``simhand_tpu_torch.finetune.train.main`` and ``.evaluate.main``) against
the JAX package on the CPU.

The mains run as users start them: synthetic data, ResNet-18, bf16 (the
trainer's fixed dtype), 128x128 crops. JAX sees one device (its trainer
builds a mesh whenever it sees several, and would shard the batch over the
test harness's 8 with BatchNorm per shard). The port starts from JAX's
initial weights: its ``init_detnet`` is patched to load the variables
JAX's ``main`` initialised.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

import simhand_tpu.finetune.detnet as jdetnet
import simhand_tpu.finetune.evaluate as jevaluate
import simhand_tpu.finetune.train as jtrain
from simhand_tpu.finetune import evaluation as jev
from simhand_tpu_torch import transfer_check
from simhand_tpu_torch.convert import detnet_from_flax_variables
from simhand_tpu_torch.finetune import evaluate as tevaluate
from simhand_tpu_torch.finetune import evaluation as tev
from simhand_tpu_torch.finetune import train as ttrain
from simhand_tpu_torch.models.resnet import RESNETS
from simhand_tpu_torch.train.checkpoint import CheckpointManager, export_state_dict
from simhand_tpu_torch.train.state import init_weights

pytest.importorskip("cv2")
torch.set_num_threads(2)
ARGS = ["--dataset", "synthetic", "--backbone", "18", "--batch_size", "16", "--epochs", "2",
        "--eval_every", "1"]
CURVES = ("lossH", "lossD", "lossL")


def test_eval_util_pck_auc_match():
    rng = np.random.default_rng(0)
    gt, pr = rng.normal(size=(2, 30, 21, 3)) * 0.03
    vis = rng.uniform(size=(30, 21)) > 0.1
    j, t = jev.EvalUtil(), tev.EvalUtil()
    for e in (j, t):
        e.feed(gt[:15], pr[:15])
        e.feed(gt[15:], pr[15:], vis[15:])
    want, got = j.get_measures(0.0, 0.05, 20), t.get_measures(0.0, 0.05, 20)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    d = np.abs(rng.normal(size=(40, 21))) * 0.1
    for per_joint in (False, True):
        want, got = jev.pck_curve(d, per_joint=per_joint), tev.pck_curve(d, per_joint=per_joint)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tev.auc_joints(d, per_joint), jev.auc_joints(d, per_joint))
    s = jev.epe_statistics(pr[0], gt[0])
    assert tev.epe_statistics(pr[0], gt[0])["mean"] == s["mean"]


def test_procrustes_and_global_align_match():
    """procrustes_align in float64 against JAX's float32: within 1e-5 of the
    largest coordinate; global_align (numpy in both) bit for bit."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(6, 21, 3)).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    Y = (1.7 * X @ R + 0.3 + rng.normal(size=X.shape) * 0.01).astype(np.float32)
    for a, b in zip(jev.procrustes_align(X, Y), tev.procrustes_align(X, Y)):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())
    gt = rng.normal(size=(5, 21, 3))
    pr = rng.normal(size=(5, 21, 3))
    for a, b in zip(jev.global_align(gt, pr, "fh"), tev.global_align(gt, pr, "fh")):
        np.testing.assert_array_equal(b, a)
    tips = rng.normal(size=(5, 5, 3))
    tips[1, :4] = np.nan
    tips[2, 0] = np.nan
    want, got = jev.global_align(tips, pr, "do"), tev.global_align(tips, pr, "do")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_heatmap_metrics_match():
    rng = np.random.default_rng(2)
    pred, gt = rng.uniform(size=(2, 6, 16, 16, 21)).astype(np.float32)
    veil = (rng.uniform(size=(6, 21)) > 0.3).astype(np.float32)
    assert tev.heatmap_metrics(pred, gt, veil) == jev.heatmap_metrics(pred, gt, veil)
    assert tev.heatmap_pck(pred, gt, veil) == jev.heatmap_pck(pred, gt, veil)
    m = tev.AverageMeter()
    m.update(2.0, 3)
    m.update(4.0)
    assert m.avg == 2.5 and m.count == 4


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """JAX's train main on one device, then the port's from the same
    initial weights, each recording its per-step losses; then the same for
    each fine-tune arm of the port's transfer check (its argv at 2 steps and
    B = 16: from a random init, and --pretrain an encoder export under
    --lr_strategy DLR), whose JAX runs reuse what the first compiled."""
    base = tmp_path_factory.mktemp("mains")
    mp = pytest.MonkeyPatch()
    devices = jax.devices
    mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    inits, jlosses, tlosses = [], [], []
    real_init = jdetnet.DetNet.init

    def recording_init(self, *a, **k):
        inits.append(jax.device_get(real_init(self, *a, **k)))
        return inits[-1]

    def recording(make, into):
        def wrapped(*a, **k):
            step = make(*a, **k)

            def run(state, batch):
                state, parts = step(state, batch)
                into.append(float(parts["det_total"]))
                return state, parts

            return run

        return wrapped

    def jax_init(model, seed=0):
        v = inits[0]
        model.load_state_dict(detnet_from_flax_variables(v["params"], v["batch_stats"]),
                              strict=True)

    jmake, tmake = jtrain.make_detnet_train_step, ttrain.make_detnet_train_step
    mp.setattr(jdetnet.DetNet, "init", recording_init)
    mp.setattr(jtrain, "make_detnet_train_step", recording(jmake, jlosses))
    mp.setattr(ttrain, "make_detnet_train_step", recording(tmake, tlosses))
    mp.setattr(ttrain, "init_detnet", jax_init)
    transfer = {}
    try:
        jtrain.main(ARGS + ["--out_dir", str(base / "jax")])
        state = ttrain.main(ARGS + ["--out_dir", str(base / "port"), "--device", "cpu"])
        encoder = RESNETS["18"]()
        init_weights(encoder, torch.Generator().manual_seed(1))
        export_state_dict(encoder, str(base / "encoder.pth"))
        for arm, pretrain in (("random", None), ("pretrained", str(base / "encoder.pth"))):
            jl, tl = [], []
            mp.setattr(jtrain, "make_detnet_train_step", recording(jmake, jl))
            mp.setattr(ttrain, "make_detnet_train_step", recording(tmake, tl))
            n = len(inits)
            mp.setattr(ttrain, "init_detnet", lambda model, seed=0, n=n: model.load_state_dict(
                detnet_from_flax_variables(inits[n]["params"], inits[n]["batch_stats"]),
                strict=True))
            argv = transfer_check.finetune_argv(str(base / f"jax_{arm}"), 2, 16,
                                                pretrain=pretrain)
            jtrain.main(argv)
            argv = transfer_check.finetune_argv(str(base / f"port_{arm}"), 2, 16,
                                                pretrain=pretrain)
            ttrain.main(argv + ["--device", "cpu"])
            transfer[arm] = {"jax": jl, "port": tl}
    finally:
        mp.undo()
    return {"base": base, "jax": jlosses, "port": tlosses, "state": state, "transfer": transfer}


def test_train_main_matches_jax(mains):
    """8 steps over 2 epochs at B = 16: step 0's det_total within rel 1e-4
    of JAX's (measured 5.8e-6), each epoch's mean within rel 2e-3 (measured
    <= 1.9e-4; two bf16 forwards and backwards of one model, whose per-step
    losses part by up to 4.5e-4), the npy curves' shapes and epochs, the
    checkpoint steps and the detnet.pth key set as JAX's."""
    base, jl, tl = mains["base"], mains["jax"], mains["port"]
    assert len(jl) == len(tl) == 8
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    for e in range(2):
        np.testing.assert_allclose(np.mean(tl[4 * e:4 * e + 4]), np.mean(jl[4 * e:4 * e + 4]),
                                   rtol=2e-3)
    for name in CURVES:
        a, b = np.load(base / "jax" / f"{name}.npy"), np.load(base / "port" / f"{name}.npy")
        assert a.shape == b.shape == (2, 2) and (a[:, 0] == b[:, 0]).all()
    for name in ("acc_hm_all", "hm_extras_all", "auc_all"):
        a = np.load(base / "jax" / f"{name}.npy", allow_pickle=True).item()
        b = np.load(base / "port" / f"{name}.npy", allow_pickle=True).item()
        assert a.keys() == b.keys() and all(len(a[k]) == len(b[k]) == 2 for k in a)
    assert CheckpointManager(str(base / "port" / "checkpoints"), metric="det_total"
                             ).all_steps() == [8]
    jsd = torch.load(base / "jax" / "detnet.pth", weights_only=True)
    tsd = torch.load(base / "port" / "detnet.pth", weights_only=True)
    assert jsd.keys() == tsd.keys()
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in tsd.values())


def test_transfer_check_arms_match_jax(mains):
    """The transfer check's two fine-tune arms (its argv at 2 steps, B = 16,
    synthetic-hand, lr 3e-4): from a random init (ULR), and from an encoder
    export under DLR (--lr_head 3e-4), the first hold of --pretrain <encoder
    .pth> --lr_strategy DLR against JAX's. Step 0's det_total within rel
    1e-4 of JAX's and lossH_final (the epoch's mean heatmap loss) within rel
    2e-3, test_train_main_matches_jax's limits; the metrics' keys."""
    base = mains["base"]
    for arm, losses in mains["transfer"].items():
        assert len(losses["jax"]) == len(losses["port"]) == 2, arm
        np.testing.assert_allclose(losses["port"][0], losses["jax"][0], rtol=1e-4, err_msg=arm)
        want = transfer_check.read_metrics(str(base / f"jax_{arm}"))
        got = transfer_check.read_metrics(str(base / f"port_{arm}"))
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["lossH_final"], want["lossH_final"], rtol=2e-3,
                                   err_msg=arm)
    # the export reached the pretrained arm: its step 0 is not the random one's
    assert mains["transfer"]["pretrained"]["port"][0] != mains["transfer"]["random"]["port"][0]


def test_train_resume_cycle(mains, tmp_path):
    """--max_steps 2 then --resume: the resumed run restores step 2 (model,
    moments and count) bit for bit, ends at step 4 with its curves' history
    kept, and the export equals the final model."""
    out = str(tmp_path / "run")
    args = ["--dataset", "synthetic", "--backbone", "18", "--batch_size", "32", "--epochs", "2",
            "--eval_every", "5", "--device", "cpu", "--out_dir", out]
    first = ttrain.main(args + ["--max_steps", "2"])
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    moments = [t.clone() for t in first.optimizer.mu + first.optimizer.nu]
    manager = CheckpointManager(out + "/checkpoints", metric="det_total")
    assert manager.all_steps() == [2]
    seen = {}
    real = CheckpointManager.restore

    def checked(self, state, step=None):
        out_state = real(self, state, step)
        sd = out_state.model.state_dict()
        seen["ok"] = (all(torch.equal(sd[k], saved[k]) for k in saved)
                      and all(torch.equal(a, b) for a, b in zip(
                          out_state.optimizer.mu + out_state.optimizer.nu, moments))
                      and out_state.optimizer.count == 2 and out_state.step == 2)
        return out_state

    mp = pytest.MonkeyPatch()
    mp.setattr(CheckpointManager, "restore", checked)
    try:
        resumed = ttrain.main(args + ["--resume"])
    finally:
        mp.undo()
    assert seen["ok"] and resumed.step == 4 and manager.all_steps() == [4]
    assert np.load(out + "/lossH.npy").shape == (2, 2)
    sd = torch.load(out + "/detnet.pth", weights_only=True)
    live = resumed.model.state_dict()
    assert all(torch.equal(sd[k], live[k]) for k in sd)


def test_evaluate_main_matches_jax(mains, capsys):
    """The JAX trainer's detnet.pth through both evaluate mains (64
    synthetic samples, B = 16, bf16 forwards): every metric within rel 3e-2
    or 1e-3 of JAX's (measured: rel <= 6.4e-3, and auc_norm 9.8e-5 against
    0.0; two bf16 forwards put a few joints on either side of a threshold);
    the port's --checkpoint and --pretrain of its own export give the same
    metrics, and so do two runs."""
    base = mains["base"]
    common = ["--dataset", "synthetic", "--backbone", "18", "--batch_size", "16"]
    mp = pytest.MonkeyPatch()
    devices = jax.devices
    mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    try:
        want = jevaluate.main(common + ["--pretrain", str(base / "jax" / "detnet.pth")])
    finally:
        mp.undo()
    got = tevaluate.main(common + ["--pretrain", str(base / "jax" / "detnet.pth"),
                                   "--device", "cpu"])
    assert got.keys() == want.keys() and got["batches"] == want["batches"] == 4
    for k, v in want.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=3e-2, abs_tol=1e-3), (k, got[k], v)
    own = [tevaluate.main(common + ["--checkpoint", str(base / "port" / "checkpoints"),
                                    "--device", "cpu"]) for _ in range(2)]
    own.append(tevaluate.main(common + ["--pretrain", str(base / "port" / "detnet.pth"),
                                        "--device", "cpu", "--out_json",
                                        str(base / "m.json")]))
    assert own[0] == own[1] == own[2] == json.loads((base / "m.json").read_text())


def test_mains_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--dataset", "synthetic", "--backbone", "18", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(["--dataset", "synthetic", "--backbone", "18"])
