"""The port's FSDP (ZeRO-3) step (``simhand_tpu_torch.parallel.fsdp``) against
the JAX package's ``make_fsdp_train_step`` on ``tests/conftest.py``'s
8-device mesh and against the port's own single-device step on the global
batch: simhand_w at ResNet-18, float32, from one init carried over by
``convert``. The port's ranks are threads over
``torch_thread_axis.ThreadAxis``.

The optimizer config warms up for one step, so the three steps run at
learning rates 0, base and cosine(1) (JAX's own test compares after step 0
only, at lr 0). Adam's moments after step 0 are 0.1 x (gradient + weight
decay) at lr 0 (LARS's trust ratio clips to 1 there), so they hold the
gradient's scale, which Adam's direction does not show.
"""
import copy
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.parallel.fsdp import leaf_partition_spec as jspec
from simhand_tpu.parallel.fsdp import make_fsdp_train_step as jfsdp
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train import create_train_state as jcreate
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.sources import generate_synthetic_hand100m
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.parallel import (
    FSDPTrainState,
    create_hybrid_mesh,
    leaf_partition_spec,
    make_fsdp_train_step,
    state_bytes,
)
from simhand_tpu_torch.train import OptimizerConfig as TOpt
from simhand_tpu_torch.train import create_train_state as tcreate
from simhand_tpu_torch.train import make_schedule as tschedule
from simhand_tpu_torch.train import make_train_step as tstep
from simhand_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_train_step import OPT, assert_states_match, to_numpy
from torch_thread_axis import run_ranks

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
SIDE, B, STEPS, W = 32, 16, 3, 8
CFG = dict(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
           image_side=float(SIDE))


def global_batch(seed: int, b: int = B, side: int = SIDE) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "transformed_image1": rng.normal(size=(b, side, side, 3)),
        "transformed_image2": rng.normal(size=(b, side, side, 3)),
        "joints1_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints2_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints1_ori": rng.uniform(0, 1, (b, 21, 3)),
        "joints2_ori": rng.uniform(0, 1, (b, 21, 3)),
    }
    for k in ("jitter_x_1", "jitter_x_2", "jitter_y_1", "jitter_y_2"):
        batch[k] = rng.uniform(-10, 0, b)
    for k in ("angle_1", "angle_2"):
        batch[k] = rng.uniform(-45, 45, b)
    return {k: v.astype(np.float32) for k, v in batch.items()}


def test_leaf_partition_spec_rules():
    """JAX's four cases of the leaf rule, and the same dim as JAX's spec on
    the port's OIHW layout of a convolution."""
    assert leaf_partition_spec((3, 3, 128, 256), 8) == 3
    assert leaf_partition_spec((256,), 8) is None
    assert leaf_partition_spec((), 8) is None
    assert leaf_partition_spec((3, 3, 21, 21), 8, min_leaf_elements=1) is None
    assert jspec((3, 3, 128, 256), 8, "d")[3] == "d"
    assert leaf_partition_spec((256, 128, 3, 3), 8) == 0


def _thread_collectives(axis, x):
    xt = torch.from_numpy(x[axis.index]).requires_grad_()
    s, p = axis.psum_scatter(xt), axis.ppermute(xt)
    gs = torch.autograd.grad((s * s).sum() + (p * p * p).sum(), xt)[0]
    p = axis.ppermute(xt)
    gp = torch.autograd.grad((p * torch.arange(p.numel(), dtype=p.dtype).view(p.shape)).sum(),
                             xt)[0]
    return s.detach().numpy(), p.detach().numpy(), gs.numpy(), gp.numpy()


def test_thread_axis_collectives_match_shard_map():
    """ThreadAxis's psum_scatter and ppermute, and their transposes (an
    all_gather and the inverse permutation), against shard_map's
    (check_vma=False) on the 8-device mesh, bit for bit: each rank's (16,
    3) block of small integers (every sum exact in any order), of which
    psum_scatter keeps 2 rows."""
    mesh = Mesh(np.array(jax.devices()), ("data",))
    x = np.random.default_rng(0).integers(-8, 8, size=(W, 16, 3)).astype(np.float32)
    perm = [(i, (i + 1) % W) for i in range(W)]

    def local(xb):
        xb = xb[0]

        def f(v):
            s = jax.lax.psum_scatter(v, "data", scatter_dimension=0, tiled=True)
            p = jax.lax.ppermute(v, "data", perm)
            return (s * s).sum() + (p * p * p).sum(), (s, p)

        (_, (s, p)), gs = jax.value_and_grad(f, has_aux=True)(xb)
        gp = jax.grad(lambda v: (jax.lax.ppermute(v, "data", perm)
                                 * jnp.arange(v.size).reshape(v.shape)).sum())(xb)
        return s[None], p[None], gs[None], gp[None]

    want = jax.jit(shard_map(local, mesh=mesh, in_specs=P("data"),
                             out_specs=(P("data"),) * 4, check_vma=False))(jnp.asarray(x))
    got = run_ranks(W, lambda axis: _thread_collectives(axis, x))
    for i, name in enumerate(("psum_scatter", "ppermute", "d psum_scatter", "d ppermute")):
        np.testing.assert_array_equal(np.stack([g[i] for g in got]), np.asarray(want[i]),
                                      err_msg=name)


@pytest.fixture(scope="module")
def jax_fsdp():
    """JAX's initial state as the port's state dict; JAX's FSDP losses and
    final state dict on the 1-D mesh (JAX's tests/test_fsdp.py holds its
    1-D and hybrid steps each to its single-device step, so one compile
    serves both of the port's layouts); the port's single-device run on the
    same global batches."""
    jm, jcfg = JModel(resnet_size="18"), JConfig(**CFG)
    # one compiled init in place of eager op-by-op dispatch (the same bits)
    template = jax.jit(lambda key: jcreate(jm, JOpt(**OPT), key,
                                           input_shape=(2, SIDE, SIDE, 3)))(jax.random.key(0))
    init = from_flax_variables(to_numpy(template.params), to_numpy(template.batch_stats))
    step, place_state, place_batch = jfsdp(jm, jcfg, Mesh(np.array(jax.devices()), ("data",)),
                                           template)
    state, losses = place_state(template), []
    for s in range(STEPS):
        state, metrics = step(state, place_batch(
            {k: jnp.asarray(v) for k, v in global_batch(s).items()}))
        losses.append(float(metrics["contrastive_loss"]))
    jax_out = (losses, from_flax_variables(to_numpy(state.params), to_numpy(state.batch_stats)))
    return {"init": init, "jax": jax_out,
            "one": one_device(init, [global_batch(s) for s in range(STEPS)])}


def one_device(init, batches, cfg=TConfig(**CFG), side=SIDE):
    """The port's single-device step on the global batches: losses, the
    first step's mu, the final state dict."""
    model = TModel("18")
    state = tcreate(model, TOpt(**OPT), 0, input_shape=(2, side, side, 3), device="cpu")
    model.load_state_dict(init, strict=True)
    step, losses, mu0 = tstep(model, cfg), [], None
    for batch in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["contrastive_loss"]))
        mu0 = mu0 or [m.clone() for m in state.optimizer.mu]
    return losses, mu0, copy.deepcopy(model.state_dict())


def fsdp_rank(axis, init, batches, cfg=TConfig(**CFG), hybrid=False, side=SIDE):
    """One rank's FSDP run: the fraction of each large parameter and moment
    it holds after place_state, its losses, the first step's whole mu (a
    gather), the final whole state dict and its held bytes."""
    mesh = create_hybrid_mesh(axis.size // 2, 2, axis) if hybrid else axis
    model = TModel("18")
    state = tcreate(model, TOpt(**OPT), 0, input_shape=(2, side, side, 3), device="cpu")
    model.load_state_dict(init, strict=True)
    whole = [p.numel() for p in state.params]
    step, place_state, place_batch = make_fsdp_train_step(model, cfg, mesh, state)
    state = place_state(state)
    assert isinstance(state, FSDPTrainState)
    fracs = [t.numel() / n for ts in (state.shards, state.optimizer.mu, state.optimizer.nu)
             for t, n in zip(ts, whole) if n >= 4096]
    losses, mu0 = [], None
    for batch in batches:
        state, metrics = step(state, place_batch(batch))
        losses.append(float(metrics["contrastive_loss"]))
        mu0 = mu0 or [t.clone() for t in state.payload()["optimizer"]["mu"]]
    return fracs, losses, mu0, state.payload()["model"], state_bytes(state)


def mu_errors(got, want) -> list:
    """Each moment's distance from the single-device one relative to its
    norm, without projection_head.fc1.bias: it feeds a train-mode
    BatchNorm, so its gradient is 0 up to rounding."""
    names = [n for n, _ in TModel("18").named_parameters()]
    return [float((g.double() - w.double()).norm() / w.double().norm())
            for n, g, w in zip(names, got, want) if n != "projection_head.fc1.bias"]


@pytest.mark.parametrize("kind", ["1d", "hybrid"])
def test_fsdp_steps_match_jax_and_one_device(jax_fsdp, kind):
    """8 ranks (1-D, or (data 4, fsdp 2)), global B = 16 at 32x32, 3 steps.

    Each large leaf of the parameters and of both moments is held at 1/n
    (n = 8, or 2 on the hybrid mesh); the ranks' states equal bit for bit.
    Against JAX's FSDP step (its 1-D mesh, which equals its hybrid one, for
    both layouts): each loss to rel 1e-4 and the state within
    tests/test_torch_train_step.py's limits for the single-device step.
    Against the port's single-device step on the global batch: the step-0
    loss to rel 1e-6 (measured 7e-8: cross-replica BatchNorm forms the
    variance as E[x^2] - mu^2), the later ones to 1e-4 (measured 2.5e-5:
    the parameters stepped apart by Adam's sign flips), the first step's
    mu (the gradient) to 5e-2 of each tensor's norm (measured 7.8e-3 at
    layer3.1.bn1.bias; 1.9e-7 with float64 compute, so rounding: 20
    BatchNorm backwards at this init carry the variance's last bits on;
    a scale fault of the reduce-scatter would be off by 1 - 1/8), the
    state within the
    same limits as JAX's (the LARS norms of split leaves are
    sqrt(psum(|piece|^2)), which rounds differently from _foreach_norm, and
    Adam's first updates are +-lr where a gradient is within rounding of
    0)."""
    init, (jlosses, jwant) = jax_fsdp["init"], jax_fsdp["jax"]
    batches = [global_batch(s) for s in range(STEPS)]
    losses, mu0, want = jax_fsdp["one"]
    out = run_ranks(W, lambda axis: fsdp_rank(axis, init, batches, hybrid=kind == "hybrid"))
    n = 2 if kind == "hybrid" else W
    lrs = [tschedule(TOpt(**OPT))(i) for i in range(STEPS)]
    for fracs, glosses, gmu0, got, _ in out:
        assert fracs and set(fracs) == {1.0 / n}
        np.testing.assert_allclose(glosses, jlosses, rtol=1e-4)
        np.testing.assert_allclose(glosses[0], losses[0], rtol=1e-6)
        np.testing.assert_allclose(glosses, losses, rtol=1e-4)
        assert max(mu_errors(gmu0, mu0)) <= 5e-2
    got = out[0][3]
    assert all(torch.equal(got[k], o[3][k]) for o in out[1:] for k in got)
    assert_states_match(init, jwant, got, lrs, update_rtol=0.25, stats_rtol=3e-2, bn_too=False)
    assert_states_match(init, want, got, lrs, update_rtol=0.25, stats_rtol=3e-2, bn_too=False)


def test_kernel_route_gives_the_one_device_gradient():
    """2 ranks, global B = 256 pairs at 16x16 (2B_local = 256 rows: the
    sharded kernels #2/#4, their plain versions on the CPU) against the
    port's single-device kernel-route step (2B = 512): the step-0 loss to
    rel 1e-6 and the first step's mu, 0.1 x the gradient, to 5e-2 of each
    tensor's norm: the reduce-scattered sum of the ranks' shares, not the
    shard_map step's global gradient / W, which would be off by 0.5. The
    FSDP step's two routes agree to 1.5e-6, the single-device step's to
    2.3e-6; FSDP and one device differ by 2e-3 to 1.7e-2 with the CPU's
    thread count (cross-replica BatchNorm's rounding, as above). The dense
    route's gradient, divided by W, is held in the test above."""
    side, b = 16, 256
    cfg = TConfig(**{**CFG, "image_side": float(side), "use_pallas": True})
    model = TModel("18")
    tcreate(model, TOpt(**OPT), 0, input_shape=(2, side, side, 3), device="cpu")
    init = copy.deepcopy(model.state_dict())
    batches = [global_batch(0, b, side)]
    losses, mu0, _ = one_device(init, batches, cfg, side)
    out = run_ranks(2, lambda axis: fsdp_rank(axis, init, batches, cfg, side=side))
    for _, glosses, gmu0, _, _ in out:
        np.testing.assert_allclose(glosses[0], losses[0], rtol=1e-6)
        assert max(mu_errors(gmu0, mu0)) <= 5e-2


def test_fsdp_device_augment_matches_one_device():
    """--device_augment under FSDP: the draws of the global batch from
    (0, step), each rank keeping its rows (no rank in the key). 2 ranks,
    raw uint8 64x64 crops of 8 pairs, 32x32 views, 2 steps: the losses
    within rel 1e-5 of the single-device augmented step's and the final
    statistics within 1e-4 of their largest."""
    rng = np.random.default_rng(8)
    b = 8
    raw = {
        "image1": rng.integers(0, 255, (b, 64, 64, 3), dtype=np.uint8),
        "image2": rng.integers(0, 255, (b, 64, 64, 3), dtype=np.uint8),
        "joints1": rng.uniform(16, 48, (b, 21, 3)).astype(np.float32),
        "joints2": rng.uniform(16, 48, (b, 21, 3)).astype(np.float32),
        "joints_raw1": rng.uniform(0, 1, (b, 21, 3)).astype(np.float32),
        "joints_raw2": rng.uniform(0, 1, (b, 21, 3)).astype(np.float32),
    }
    augment = (AugmentFlags(crop=True, resize=True, rotate=True),
               AugmentParams(resize_shape=(SIDE, SIDE)), SIDE)
    cfg = TConfig(**CFG)

    def run(axis):
        model = TModel("18")
        state = tcreate(model, TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
        if axis is None:
            step = tstep(model, cfg, augment=augment)
            place = lambda batch: {k: torch.from_numpy(v) for k, v in batch.items()}  # noqa: E731
        else:
            step, place_state, place = make_fsdp_train_step(model, cfg, axis, state,
                                                             augment=augment)
            state = place_state(state)
        losses = []
        for _ in range(2):
            state, metrics = step(state, place(raw))
            losses.append(float(metrics["contrastive_loss"]))
        return losses, state.payload()["model"]

    want_losses, want = run(None)
    for losses, got in run_ranks(2, run):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, w in want.items():
            if "running" in k:
                err = float((got[k] - w).abs().max() / w.abs().max())
                assert err <= 1e-4, (k, err)


def test_replicated_checkpoint_restores_under_fsdp(tmp_path):
    """A checkpoint of the single-device (replicated) step restores into
    the FSDP layout of 2 ranks: each rank keeps its pieces of the saved
    parameters and moments bit for bit, the buffers whole, the step; it
    trains on; its own save (rank 0 writes, rank 1 takes part in the
    gather) is the replicated file's layout, whole tensors under the same
    keys, and restores into a single-device state."""
    model = TModel("18")
    state = tcreate(model, TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in global_batch(0, 4).items()}
    state, metrics = tstep(model, TConfig(**CFG))(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, {"contrastive_loss": float(metrics["contrastive_loss"])})
    saved = mgr.restore_tree()

    def rank(axis):
        m = TModel("18")
        template = tcreate(m, TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
        step, place_state, place_batch = make_fsdp_train_step(m, TConfig(**CFG), axis,
                                                              template)
        st = CheckpointManager(str(tmp_path / "ckpt")).restore(place_state(template))
        names = [n for n, _ in m.named_parameters()]
        for name, d, s, mu in zip(names, st.dims, st.shards, st.optimizer.mu):
            w = saved["model"][name]
            want = w if d is None else w.movedim(d, 0).chunk(2)[axis.index]
            assert torch.equal(s, want), name
            wmu = saved["optimizer"]["mu"][names.index(name)]
            assert torch.equal(mu, wmu if d is None else wmu.movedim(d, 0).chunk(2)[axis.index])
        assert st.step == 1 and any(d is not None for d in st.dims)
        st, metrics = step(st, place_batch(global_batch(1, 4)))
        assert np.isfinite(float(metrics["contrastive_loss"]))
        if axis.index == 0:
            CheckpointManager(str(tmp_path / "fsdp")).save(2, st, {"contrastive_loss": 1.0})
        else:
            st.payload()
        return True

    assert all(run_ranks(2, rank))
    again = CheckpointManager(str(tmp_path / "fsdp")).restore_tree()
    assert again["model"].keys() == saved["model"].keys()
    assert all(again["model"][k].shape == v.shape for k, v in saved["model"].items())
    assert [t.shape for t in again["optimizer"]["nu"]] == [t.shape for t in
                                                           saved["optimizer"]["nu"]]
    fresh = tcreate(TModel("18"), TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3),
                    device="cpu")
    assert CheckpointManager(str(tmp_path / "fsdp")).restore(fresh).step == 2


# one rank: main() with --fsdp, recording what its steps saw
RANK = textwrap.dedent("""
    import copy, sys
    import torch
    import simhand_tpu_torch.constants as constants
    import simhand_tpu_torch.experiments.config as cfg
    import simhand_tpu_torch.experiments.main as m
    from simhand_tpu_torch.parallel import state_bytes

    cfg.TRAINING_CONFIG_PATH, out = sys.argv[1], sys.argv[2]
    constants.TENSORBOARD_LOGS = ""     # console logging only: no TensorBoard import
    rec = {"losses": [], "batches": []}
    make = m.make_fsdp_train_step

    def recording(model, ccfg, axis, state, augment=None):
        rec.update(init=copy.deepcopy(model.state_dict()), ccfg=ccfg,
                   opt_cfg=state.optimizer.cfg, whole_bytes=state_bytes(state))
        step, place_state, place_batch = make(model, ccfg, axis, state, augment=augment)

        def run(state, batch):
            rec["batches"].append({k: v.clone() for k, v in batch.items()})
            state, metrics = step(state, batch)
            rec["losses"].append(float(metrics["contrastive_loss"]))
            rec["bytes"], rec["final"] = state_bytes(state), state.payload()["model"]
            return state, metrics
        return run, place_state, place_batch

    m.make_fsdp_train_step = recording
    m.main(sys.argv[3:], device="cpu")
    torch.save(rec, out)
""")
MAIN_DEADLINE_S = 240


def test_fsdp_main_on_two_processes(tmp_path):
    """experiments/main.py --fsdp as two gloo processes (torchrun's
    environment; simhand_w, ResNet-18, 32x32 float32, global B = 8, 2
    steps): each holds less than 0.55 of the replicated state's bytes, the
    ranks' final (gathered) states are equal bit for bit, the losses equal
    the thread-axis FSDP step's on the rows each took (rel 1e-6), and rank 0
    alone wrote the one checkpoint, which restores into one process's
    state."""
    pytest.importorskip("cv2")
    with open(REPO / "simhand_tpu_torch/experiments/config/training_config.json") as f:
        tc = json.load(f)
    tc.update(precision="32", train_ratio=1.0)
    tc["augmentation_params"]["resize_shape"] = [SIDE, SIDE]
    config = tmp_path / "training_config.json"
    config.write_text(json.dumps(tc))
    data = tmp_path / "data"
    generate_synthetic_hand100m(str(data / "synthetic"), num_images=32, num_videos=8)
    argv = ["--experiment_type", "simhand_w", "--crop", "--resize", "--rotate",
            "-sources", "synthetic", "-batch_size", "8", "-resnet_size", "18",
            "--data_dir", str(data), "-epochs", "1", "--max_steps", "2",
            "-experiment_name", "fsdp", "--fsdp"]
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), BASE_PATH=str(tmp_path / "runs"),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(config), str(tmp_path / f"rank{r}.pt"), *argv],
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
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-4000:]

    recs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r in recs:
        assert len(r["losses"]) == 2 and r["bytes"] < 0.55 * r["whole_bytes"]
    assert recs[0]["losses"] == recs[1]["losses"]
    assert all(torch.equal(recs[0]["final"][k], recs[1]["final"][k]) for k in recs[0]["final"])

    def thread_rank(axis):
        rec = recs[axis.index]
        model = TModel("18")
        state = tcreate(model, rec["opt_cfg"], 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
        model.load_state_dict(rec["init"], strict=True)
        step, place_state, _ = make_fsdp_train_step(model, rec["ccfg"], axis, state)
        state, losses = place_state(state), []
        for batch in rec["batches"]:
            state, metrics = step(state, batch)
            losses.append(float(metrics["contrastive_loss"]))
        return losses

    for losses in run_ranks(2, thread_rank):
        np.testing.assert_allclose(losses, recs[0]["losses"], rtol=1e-6)
    ckpts = list((tmp_path / "runs").rglob("state.pt"))
    assert len(ckpts) == 1
    fresh = tcreate(TModel("18"), recs[0]["opt_cfg"], 0, input_shape=(2, SIDE, SIDE, 3),
                    device="cpu")
    restored = CheckpointManager(str(ckpts[0].parent.parent)).restore(fresh)
    assert restored.step == 2
    assert all(torch.equal(v, recs[0]["final"][k])
               for k, v in restored.model.state_dict().items())
