"""The port's data-parallel detnet fine-tune (``det_loss(..., axis)``,
``make_detnet_train_step(model, axis)``, ``finetune.train.main`` with
``WORLD_SIZE = 2``) against the JAX package's mesh step on a 2-device
sub-mesh of ``tests/conftest.py``'s 8, float32, ResNet-18 at 32x32 (hm_res
8). The port's ranks are threads over ``torch_thread_axis.ThreadAxis``;
the entry point runs as two gloo processes.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from simhand_tpu.finetune import detloss as jloss
from simhand_tpu.finetune.detnet import DetNet as JDetNet
from simhand_tpu.finetune.train import make_detnet_train_step as jmake_step
from simhand_tpu.train.state import TrainState as JState
from simhand_tpu_torch.convert import detnet_from_flax_variables
from simhand_tpu_torch.finetune import detloss as tloss
from simhand_tpu_torch.finetune.train import make_detnet_train_step
from simhand_tpu_torch.parallel import shard_batch
from simhand_tpu_torch.train.optimizer import Adam, exponential_decay
from simhand_tpu_torch.train.state import TrainState
from test_torch_detnet import BN_VARIANTS, loss_inputs, port_model, targets
from torch_thread_axis import run_ranks

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
W, B, STEPS, LR = 2, 8, 3, 1e-5
MESH = Mesh(np.array(jax.devices()[:W]), ("data",))
KEYS = ("hm", "dm", "lm", "hm_veil", "flag_3d")


def sharded_losses(preds, tg):
    """JAX's det_loss under shard_map over MESH (value, parts and each
    rank's gradient, rows in rank order) and the port's on W thread ranks."""
    def local(p, *t):
        (total, parts), g = jax.value_and_grad(
            lambda q: jloss.det_loss(q, *t, axis_name="data"), has_aux=True)(p)
        return total, parts, g

    fn = jax.jit(shard_map(local, mesh=MESH, in_specs=(P("data"),) * 6,
                           out_specs=(P(), P(), P("data")), check_vma=False))
    jtotal, jparts, jgrad = fn({k: jnp.asarray(v) for k, v in preds.items()},
                               *(jnp.asarray(tg[k]) for k in KEYS))

    def rank(axis):
        p = {k: torch.from_numpy(v).requires_grad_()
             for k, v in shard_batch(axis, preds).items()}
        t = shard_batch(axis, {k: torch.from_numpy(tg[k]) for k in KEYS})
        total, parts = tloss.det_loss(p, *(t[k] for k in KEYS), axis=axis)
        grads = torch.autograd.grad(total, list(p.values()))
        return {k: float(v.detach()) for k, v in parts.items()}, dict(zip(p, grads))

    return (jparts, jgrad), run_ranks(W, rank)


def test_det_loss_with_an_axis_matches_jax():
    """2 ranks of 2 samples, 3 of 4 3D: each rank's parts (the 3D terms
    the global batch's, the heatmap term its own) within rel 1e-5 of
    JAX's, each rank's gradient (W x the per-sample one) within 1e-5 of
    its largest; the mean of the ranks' parts and gradients is the
    single-device loss's (rel 1e-5)."""
    preds, tg = loss_inputs(4, [1, 0, 1, 1])
    (jparts, jgrad), out = sharded_losses(preds, tg)
    for parts, _ in out:
        for k in ("det_dm", "det_lm"):
            np.testing.assert_allclose(parts[k], float(jparts[k]), rtol=1e-5, err_msg=k)
    for k in jgrad:
        w = np.asarray(jgrad[k])
        got = np.concatenate([g[k].numpy() for _, g in out])
        assert np.isfinite(w).all()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, parts = tloss.det_loss(tp, *(torch.from_numpy(tg[k]) for k in KEYS))
    grads = dict(zip(tp, torch.autograd.grad(total, list(tp.values()))))
    for k in parts:
        np.testing.assert_allclose(np.mean([p[k] for p, _ in out]), float(parts[k]),
                                   rtol=1e-5, err_msg=k)
    for k, g in grads.items():
        got = np.concatenate([gr[k].numpy() for _, gr in out]) / W
        np.testing.assert_allclose(got, g.numpy(), rtol=0, atol=1e-5 * g.abs().max().item())


def test_all_2d_global_batch_nan_and_one_3d_sample_on_one_rank():
    """The reference's fault over an axis: with every flag_3d 0 on every
    rank, d_map's and l_map's gradients are NaN on every rank (in JAX too);
    one 3D sample on rank 1 alone makes every rank's gradient finite, rank
    0's, which holds only 2D samples, included."""
    preds, tg = loss_inputs(5, [0, 0, 0, 0])
    (_, jgrad), out = sharded_losses(preds, tg)
    for k in ("d_map", "l_map"):
        assert np.isnan(np.asarray(jgrad[k])).all()
        assert all(torch.isnan(g[k]).all() for _, g in out), k
    tg["flag_3d"] = np.asarray([0, 0, 0, 1], np.float32)
    (_, jgrad), out = sharded_losses(preds, tg)
    for k in ("h_map", "d_map", "l_map"):
        assert np.isfinite(np.asarray(jgrad[k])).all()
        assert all(torch.isfinite(g[k]).all() for _, g in out), k


@pytest.fixture(scope="module")
def det32():
    # one compiled init in place of eager op-by-op dispatch (the same bits)
    model = JDetNet(resnet_size="18", hm_res=8)
    return jax.device_get(jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))


@pytest.mark.parametrize("variant", ["exact", "fused_pallas"])
def test_mesh_step_matches_jax(det32, variant):
    """W = 2, global B = 8 (4 a rank, 3 of 4 3D), 3 Adam steps at lr 1e-5:
    BatchNorm per-replica; gradients, parts and running statistics pmean'd.
    fused_pallas: the port's plain #9 on the CPU, JAX's Pallas kernel in
    interpret mode. Both ranks' parts within rel 1e-5 of JAX's at step 0
    and 1e-3 after (tests/test_torch_detnet.py's limits for one device,
    whose reasons hold per rank), the ranks' states equal bit for bit,
    each statistic within 2e-2 of its largest change and each parameter
    within 2 * 3 * lr of JAX's, their difference within 0.15 of the norm of
    JAX's update."""
    kw = BN_VARIANTS[variant]
    jm = JDetNet(resnet_size="18", hm_res=8, **kw)
    rng = np.random.default_rng(6)
    batches = [dict(targets(rng, B, 8, [1, 1, 0, 1] * 2),
                    img=rng.uniform(-0.5, 0.5, (B, 32, 32, 3)).astype(np.float32))
               for _ in range(STEPS)]
    tx = optax.adam(optax.exponential_decay(LR, 50, 0.1, staircase=True))
    # the state replicated over MESH from the start, as the step returns
    # it, so the step compiles once
    jstate = jax.device_put(JState.create(apply_fn=jm.apply, params=det32["params"], tx=tx,
                                          batch_stats=det32["batch_stats"]),
                            NamedSharding(MESH, P()))
    jstep, jparts = jmake_step(jm, mesh=MESH), []
    for batch in batches:
        jstate, parts = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jparts.append({k: float(v) for k, v in parts.items()})

    def rank(axis):
        model = port_model(det32, resnet_size="18", hm_res=8, **kw)
        state = TrainState(model, Adam([(list(model.parameters()),
                                         exponential_decay(LR, 50, 0.1, True))]))
        step, parts = make_detnet_train_step(model, axis), []
        for batch in batches:
            state, p = step(state, shard_batch(axis, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()}))
            parts.append({k: float(v) for k, v in p.items()})
        return parts, model.state_dict()

    out = run_ranks(W, rank)
    for parts, _ in out:
        for s, (got, want) in enumerate(zip(parts, jparts)):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5 if s == 0 else 1e-3,
                                           err_msg=f"step {s} {k}")
    got, other = out[0][1], out[1][1]
    assert all(torch.equal(got[k], other[k]) for k in got)
    want = detnet_from_flax_variables(jax.device_get(jstate.params),
                                      jax.device_get(jstate.batch_stats))
    start = detnet_from_flax_variables(det32["params"], det32["batch_stats"])
    stats_err, diff_sq, update_sq = 0.0, 0.0, 0.0
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith(("running_mean", "running_var")):
            stats_err = max(stats_err, np.abs(g - w).max() / np.abs(w - start[k].numpy()).max())
        elif not k.endswith("num_batches_tracked"):
            d = np.abs(g - w)
            assert d.max() <= 2 * STEPS * LR, (k, d.max())
            diff_sq += float((d ** 2).sum())
            update_sq += float(((w - start[k].numpy()) ** 2).sum())
    assert stats_err <= 2e-2 and np.sqrt(diff_sq / update_sq) <= 0.15


def test_each_rank_builds_only_its_rows():
    """detnet_batch_iterator(shard=(r, W)) builds rank r's rows of every
    global batch alone, equal bit for bit to those rows of the global
    batch (image and targets): each sample's draws are keyed by its index."""
    from simhand_tpu_torch.finetune import datasets as tds

    ds = tds.SyntheticPoseDataset(n=12, side=96)
    kw = dict(epoch=1, device="cpu")
    whole = list(tds.detnet_batch_iterator(ds, tds.DetnetSampleBuilder(), 4, **kw))
    parts = [list(tds.detnet_batch_iterator(ds, tds.DetnetSampleBuilder(), 4, shard=(r, W),
                                            **kw)) for r in range(W)]
    assert len(whole) == 3 and all(len(p) == 3 for p in parts)
    for b, g in enumerate(whole):
        for r in range(W):
            local = parts[r][b]
            assert local.keys() == g.keys()
            for k, v in g.items():
                want = v[r * 2:(r + 1) * 2]
                got = local[k]
                if isinstance(v, torch.Tensor):
                    assert torch.equal(got, want), k
                else:
                    np.testing.assert_array_equal(got, want, err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        next(tds.detnet_batch_iterator(ds, tds.DetnetSampleBuilder(), 3, shard=(0, W), **kw))


# one rank: finetune main(), recording each step's rows and parts
RANK = textwrap.dedent("""
    import sys
    import torch
    import simhand_tpu_torch.finetune.train as t

    out = sys.argv[1]
    rec = {"parts": [], "rows": []}
    make = t.make_detnet_train_step

    def recording(model, axis=None):
        step = make(model, axis)

        def run(state, batch):
            rec["rows"].append(batch["img"].clone())
            state, parts = step(state, batch)
            rec["parts"].append({k: float(v) for k, v in parts.items()})
            return state, parts
        return run

    t.make_detnet_train_step = recording
    state = t.main(sys.argv[2:], device="cpu")
    rec["final"] = state.model.state_dict()
    torch.save(rec, out)
""")
MAIN_DEADLINE_S = 240


def test_finetune_main_on_two_processes(tmp_path):
    """finetune.train.main as two gloo processes (torchrun's environment;
    synthetic set, ResNet-18, global B = 4, 2 steps in one epoch with an
    evaluation): the ranks took disjoint rows, their parts and final states
    are equal bit for bit, and rank 0 alone wrote the one checkpoint, the
    curves and detnet.pth, all under --out_dir."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = tmp_path / "detnet"
    argv = ["--dataset", "synthetic", "--backbone", "18", "--batch_size", "4", "--epochs", "1",
            "--max_steps", "2", "--eval_every", "1", "--out_dir", str(out_dir)]
    procs = []
    for r in range(W):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp_path / f"rank{r}.pt"), *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + MAIN_DEADLINE_S
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
    assert len(recs[0]["parts"]) == 2 and recs[0]["parts"] == recs[1]["parts"]
    for s in range(2):
        a, b = (r["rows"][s] for r in recs)
        assert a.shape[0] == b.shape[0] == 2 and not torch.equal(a, b)
    assert all(torch.equal(recs[0]["final"][k], recs[1]["final"][k]) for k in recs[0]["final"])
    assert sorted(p.name for p in (out_dir / "checkpoints").iterdir()) == ["2"]
    assert (out_dir / "detnet.pth").exists() and (out_dir / "lossH.npy").exists()
