"""The port's data-parallel train and eval steps (``make_train_step(...,
axis=...)``) against the JAX package's ``make_train_step(..., mesh=...)``
on a 2-device sub-mesh of ``tests/conftest.py``'s 8, simhand_w at
ResNet-18, float32, from one init carried over by ``convert``.

The port's two ranks are threads over ``torch_thread_axis.ThreadAxis``,
each with its own replica of the model; 16x16 views. Two cases, which
take each BatchNorm mode and each route once (JAX's compile of a sharded
ResNet-18 step costs ~10 s a case): the kernel route (B = 256 pairs,
2B_local = 256 rows a rank) with per-replica BatchNorm, the route of
``experiments/main.py``, and the dense route (B = 8 pairs) with
cross-replica BatchNorm (``bn_axis``). The other two pairings are held
piecewise: the BatchNorms and the synced conv1x1 site in
tests/test_torch_sync_bn.py, the losses of both routes with their gradient
scales in tests/test_torch_sharded_losses.py, and on the card by phase 20
of chip_smoke.py (both routes with cross-replica BatchNorm).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.parallel.mesh import replicate as jreplicate
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train import create_train_state as jcreate
from simhand_tpu.train import make_eval_step as jeval
from simhand_tpu.train import make_train_step as jstep
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.parallel import shard_batch
from simhand_tpu_torch.train import OptimizerConfig as TOpt
from simhand_tpu_torch.train import create_train_state as tcreate
from simhand_tpu_torch.train import make_eval_step as teval
from simhand_tpu_torch.train import make_schedule as tschedule
from simhand_tpu_torch.train import make_train_step as tstep
from test_torch_train_step import OPT, assert_states_match, to_numpy
from torch_thread_axis import run_ranks

torch.set_num_threads(2)
W, STEPS = 2, 2
MESH = Mesh(np.array(jax.devices()[:W]), ("data",))


def synthetic_batch(b: int, side: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "transformed_image1": rng.normal(size=(b, side, side, 3)),
        "transformed_image2": rng.normal(size=(b, side, side, 3)),
        "jitter_x_1": rng.uniform(-10, 0, b), "jitter_x_2": rng.uniform(-10, 0, b),
        "jitter_y_1": rng.uniform(-10, 0, b), "jitter_y_2": rng.uniform(-10, 0, b),
        "angle_1": rng.uniform(-45, 45, b), "angle_2": rng.uniform(-45, 45, b),
        "joints1_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints2_aug": rng.uniform(0, side, (b, 21, 3)),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_init():
    """One JAX train state of ResNet-18 (its variables do not depend on the
    view size or on bn_axis_name) and its state dict for the port."""
    state = jcreate(JModel(resnet_size="18"), JOpt(**OPT), jax.random.key(0),
                    input_shape=(2, 16, 16, 3))
    return state, from_flax_variables(to_numpy(state.params), to_numpy(state.batch_stats))


def sharded_steps(jax_init, b: int, use_pallas: bool, sync_bn: bool, side: int = 16):
    """STEPS sharded train steps and one sharded eval step in both
    packages. Returns JAX's and each rank's losses and eval losses, each
    rank's state dict, the initial and JAX state dicts and the learning
    rates."""
    cfg = dict(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
               image_side=float(side), use_pallas=use_pallas)
    batch = synthetic_batch(b, side)
    jm = JModel(resnet_size="18", bn_axis_name="data" if sync_bn else None)
    # the step donates its state: a replicated copy of the shared one, also
    # so that both steps run one compiled program
    jstate, init = jreplicate(MESH, jax.tree.map(jnp.copy, jax_init[0])), jax_init[1]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step, jlosses = jstep(jm, JConfig(**cfg), mesh=MESH), []
    for _ in range(STEPS):
        jstate, metrics = step(jstate, jb)
        jlosses.append(float(metrics["contrastive_loss"]))
    jeval_loss = float(jeval(jm, JConfig(**cfg), mesh=MESH)(jstate, jb)["contrastive_loss"])
    want = from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))

    def rank(axis):
        tm = TModel("18", bn_axis=axis if sync_bn else None)
        state = tcreate(tm, TOpt(**OPT), 0, input_shape=(2, side, side, 3), device="cpu")
        tm.load_state_dict(init, strict=True)
        tb = {k: torch.from_numpy(v) for k, v in shard_batch(axis, batch).items()}
        step, losses = tstep(tm, TConfig(**cfg), axis=axis), []
        for _ in range(STEPS):
            state, metrics = step(state, tb)
            losses.append(metrics["contrastive_loss"].item())
        eval_loss = teval(tm, TConfig(**cfg), axis=axis)(state, tb)["contrastive_loss"].item()
        return losses, eval_loss, copy.deepcopy(tm.state_dict())

    out = run_ranks(W, rank)
    lrs = [tschedule(TOpt(**OPT))(i) for i in range(STEPS)]
    return jlosses, jeval_loss, out, init, want, lrs


@pytest.mark.parametrize("b,use_pallas,sync_bn", [(256, True, False), (8, False, True)],
                         ids=["kernel-per-replica", "dense-sync"])
def test_sharded_train_steps_match_jax(jax_init, b, use_pallas, sync_bn):
    """Each rank's losses against JAX's (rel 1e-4) and its eval loss after
    the steps (rel 5e-4); the ranks' parameters and running statistics
    equal bit for bit; the parameters and statistics against JAX's within
    tests/test_torch_train_step.py's limits for the single-device step.
    The kernel route steps with the global gradient / W (its per-rank
    gradient is the global one, then pmean'd), the dense route with the
    global gradient, in both packages."""
    jlosses, jeval_loss, out, init, want, lrs = sharded_steps(jax_init, b, use_pallas, sync_bn)
    for losses, eval_loss, _ in out:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        assert eval_loss == pytest.approx(jeval_loss, rel=5e-4)
    sd0, sd1 = out[0][2], out[1][2]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert_states_match(init, want, sd0, lrs, update_rtol=0.25, stats_rtol=3e-2, bn_too=False)


def test_per_replica_statistics_are_the_replica_mean():
    """Per-replica BatchNorm (no bn_axis): after one sharded step, the
    running statistics are the mean of those each rank's rows give alone
    (the serial oracle of tests/test_train.py:247, here from the port's own
    forward: within rtol 1e-6, atol 1e-7); with bn_axis the encoder's are
    the global batch's, from a forward of the whole batch on one device
    (rtol 1e-4, atol 1e-5: the variance formed as E[x^2] - mu^2 against
    batch_norm's). The projection head's BatchNorm is per-replica in both
    packages; with bn_axis its inputs are the synced encoder's, which the
    oracle does not give, so that case holds the encoder's alone."""
    batch = synthetic_batch(8, 32, seed=3)
    cfg = TConfig(experiment_type="simclr", augmentation=("crop", "rotate", "resize"),
                  image_side=32.0)
    ref = TModel("18")
    tcreate(ref, TOpt(**OPT), 0, input_shape=(2, 32, 32, 3), device="cpu")
    init = copy.deepcopy(ref.state_dict())

    def oracle(rows) -> dict:
        m = TModel("18")
        m.load_state_dict(init)
        m.train()
        with torch.no_grad():
            m(torch.cat([torch.from_numpy(batch[f"transformed_image{v}"][rows])
                         for v in (1, 2)]))
        return {k: v for k, v in m.state_dict().items() if k.endswith(("_mean", "_var"))}

    shards = [oracle(slice(4 * r, 4 * (r + 1))) for r in range(W)]
    per_replica_want = {k: (shards[0][k] + shards[1][k]) / 2 for k in shards[0]}
    global_want = {k: v for k, v in oracle(slice(0, 8)).items() if k.startswith("encoder.")}

    for sync_bn, want, rtol, atol in ((False, per_replica_want, 1e-6, 1e-7),
                                      (True, global_want, 1e-4, 1e-5)):
        def rank(axis, sync_bn=sync_bn):
            tm = TModel("18", bn_axis=axis if sync_bn else None)
            state = tcreate(tm, TOpt(**OPT), 0, input_shape=(2, 32, 32, 3), device="cpu")
            tm.load_state_dict(init)
            tb = {k: torch.from_numpy(v) for k, v in shard_batch(axis, batch).items()}
            tstep(tm, cfg, axis=axis)(state, tb)
            return tm.state_dict()

        for got in run_ranks(W, rank):
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                           err_msg=k)
