"""The port's optimizer, train state and train step (``simhand_tpu_torch.train``)
against the JAX package on the CPU.

Inputs are made from a seed with numpy; the JAX package initialises the
model and ``simhand_tpu_torch.convert`` carries its weights over. The
optimizer config warms up for one step, so the three steps run at learning
rates 0, base and cosine(1): a single step (lr 0) would not test the
update at all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train import create_train_state as jcreate
from simhand_tpu.train import make_eval_step as jeval
from simhand_tpu.train import make_train_step as jstep
from simhand_tpu.train.optimizer import make_optimizer, wd_mask
from simhand_tpu.train.optimizer import make_schedule as jschedule
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.train import Optimizer
from simhand_tpu_torch.train import OptimizerConfig as TOpt
from simhand_tpu_torch.train import create_train_state as tcreate
from simhand_tpu_torch.train import make_eval_step as teval
from simhand_tpu_torch.train import make_schedule as tschedule
from simhand_tpu_torch.train import make_train_step as tstep
from simhand_tpu_torch.train.optimizer import decay_mask

torch.set_num_threads(2)
SIDE = 32
STEPS = 3
OPT = dict(train_iters_per_epoch=1, warmup_epochs=1, epochs=10)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rn18():
    """A ResNet-18 ContrastiveModel's flax variables at 32x32."""
    variables = JModel(resnet_size="18").init(jax.random.key(0),
                                              jnp.zeros((2, SIDE, SIDE, 3)))
    return to_numpy(variables["params"]), to_numpy(variables["batch_stats"])


def test_create_train_state_initialises_like_flax(rn18):
    """flax's initialisers, drawn by another generator: lecun_normal kernels
    (truncated to 2 std) and zero biases, BatchNorm scale 1 and bias 0,
    running mean 0 and variance 1. Each kernel's std agrees to 5% (tensors
    of >= 1728 elements; sampling noise <= 1.7%)."""
    params, batch_stats = rn18
    want = from_flax_variables(params, batch_stats)
    model = TModel("18")
    state = tcreate(model, TOpt(), 3, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    assert state.step == 0 and state.optimizer.count == 0
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key.endswith("weight") and g.dim() > 1:
            assert float(g.std()) == pytest.approx(float(w.std()), rel=0.05), key
            assert float(g.abs().max()) <= 2 * float(w.std()) / 0.8796 * 1.05, key
        else:
            assert torch.equal(g.float(), w.float()), key


@pytest.mark.parametrize("optimizer,accumulate", [("LARS", 1), ("adam", 1), ("LARS", 4)])
def test_schedule_matches_optax(optimizer, accumulate):
    for kw in (OPT, dict(train_iters_per_epoch=1000, epochs=100, warmup_epochs=10)):
        jcfg = JOpt(optimizer=optimizer, accumulate_grad_batches=accumulate, **kw)
        tcfg = TOpt(optimizer=optimizer, accumulate_grad_batches=accumulate, **kw)
        want, got = jschedule(jcfg), tschedule(tcfg)
        w = jcfg.warmup_steps
        for count in sorted({0, 1, 2, 3, w // 2, max(w - 1, 0), w, w + 1,
                             jcfg.total_steps // 2, jcfg.total_steps, jcfg.total_steps + 7}):
            # both in float32; XLA's and numpy's cos may differ in the last bit
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12)


def test_decay_mask_matches_wd_mask(rn18):
    """By module type: every BatchNorm parameter (also ``downsample.1``,
    which a mask by the name "bn" would miss) and every bias."""
    params, batch_stats = rn18
    mask = jax.tree.map(lambda m, p: np.full(p.shape, float(m)), wd_mask(params), params)
    want = {k: bool(v.flatten()[0]) for k, v in from_flax_variables(mask, batch_stats).items()
            if "running" not in k and "num_batches" not in k}
    model = TModel("18")
    got = dict(zip([n for n, _ in model.named_parameters()], decay_mask(model)))
    assert got == want
    assert got["encoder.layer2.0.downsample.1.weight"] is False
    assert got["encoder.layer2.0.downsample.0.weight"] is True
    assert got["projection_head.fc1.bias"] is False


@pytest.mark.parametrize("optimizer,accumulate", [("LARS", 1), ("adam", 1), ("LARS", 2)])
def test_optimizer_matches_optax(rn18, optimizer, accumulate):
    """The same gradients into both chains for 3 updates (3 * accumulate
    calls). One tensor's gradient is zero, where LARS leaves the gradient
    as it is; at the first update lr is 0 and LARS divides by it."""
    params, batch_stats = rn18
    jcfg = JOpt(optimizer=optimizer, accumulate_grad_batches=accumulate,
                **{**OPT, "train_iters_per_epoch": accumulate})
    tcfg = TOpt(optimizer=optimizer, accumulate_grad_batches=accumulate,
                **{**OPT, "train_iters_per_epoch": accumulate})
    model = TModel("18")
    model.load_state_dict(from_flax_variables(params, batch_stats), strict=True)
    names = [n for n, _ in model.named_parameters()]
    tparams = list(model.parameters())
    opt = Optimizer(tcfg, tparams, decay_mask(model))
    tx = make_optimizer(jcfg, params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate, update = tx.init(jparams), jax.jit(tx.update)
    rng = np.random.default_rng(3)
    for call in range(3 * accumulate):
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32), params)
        grads["encoder"]["bn1"]["bias"] = np.zeros_like(grads["encoder"]["bn1"]["bias"])
        updates, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tgrads = from_flax_variables(grads, batch_stats)
        opt.step(tparams, [tgrads[n] for n in names])
    want = from_flax_variables(to_numpy(jparams), batch_stats)
    for name, p in zip(names, tparams):
        assert torch.isfinite(p).all(), name
        # the same float32 arithmetic; only the LARS norms sum in another
        # order (a trust ratio differs in its last bits): a few ulps of
        # parameters of size ~0.05
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    assert opt.count == 3


def synthetic_batch(b: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "transformed_image1": rng.normal(size=(b, SIDE, SIDE, 3)),
        "transformed_image2": rng.normal(size=(b, SIDE, SIDE, 3)),
        "jitter_x_1": rng.uniform(-10, 0, b), "jitter_x_2": rng.uniform(-10, 0, b),
        "jitter_y_1": rng.uniform(-10, 0, b), "jitter_y_2": rng.uniform(-10, 0, b),
        "angle_1": rng.uniform(-45, 45, b), "angle_2": rng.uniform(-45, 45, b),
        "joints1_aug": rng.uniform(0, SIDE, (b, 21, 3)),
        "joints2_aug": rng.uniform(0, SIDE, (b, 21, 3)),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def run_both(b: int, use_pallas: bool, f64: bool = False):
    """STEPS train steps and one eval step of simhand_w in both packages
    from one init. Returns the losses, eval losses, initial, JAX and port
    state dicts, and the learning rates of the steps."""
    cfg = dict(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
               image_side=float(SIDE), use_pallas=use_pallas)
    batch = synthetic_batch(b)
    with jax.enable_x64(f64):
        jm = JModel(resnet_size="18", dtype=jnp.float64 if f64 else jnp.float32)
        jstate = jcreate(jm, JOpt(**OPT), jax.random.key(0), input_shape=(2, SIDE, SIDE, 3))
        init = from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step, jlosses = jstep(jm, JConfig(**cfg)), []
        for _ in range(STEPS):
            jstate, metrics = step(jstate, jb)
            jlosses.append(float(metrics["contrastive_loss"]))
        jeval_loss = float(jeval(jm, JConfig(**cfg))(jstate, jb)["contrastive_loss"])
        want = from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))

    tm = TModel("18", dtype=torch.float64 if f64 else torch.float32)
    tstate = tcreate(tm, TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    tm.load_state_dict(init, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step, tlosses = tstep(tm, TConfig(**cfg)), []
    for _ in range(STEPS):
        tstate, metrics = step(tstate, tb)
        tlosses.append(metrics["contrastive_loss"].item())
    assert tstate.step == STEPS
    teval_loss = teval(tm, TConfig(**cfg))(tstate, tb)["contrastive_loss"].item()
    lrs = [tschedule(TOpt(**OPT))(i) for i in range(STEPS)]
    return (jlosses, tlosses), (jeval_loss, teval_loss), init, want, tm.state_dict(), lrs


def assert_states_match(init, want, got, lrs, update_rtol, stats_rtol, bn_too):
    """Parameters and BatchNorm statistics after the steps.

    Adam's first updates are +-lr per element (m / sqrt(v) of one gradient
    is its sign), so an element whose gradient is within rounding of 0 may
    step the other way in the other package: no element may differ by more
    than 2 * sum(lr), and each weight tensor's update (p - p_init) must
    agree in norm to ``update_rtol``. The gradients of BatchNorm scales and
    biases cancel almost to 0 (the next train-mode BatchNorm absorbs a
    common scale of relu(gamma x + beta)), so in float32 their updates are
    held only to the elementwise bound; ``bn_too`` holds them to the norm
    as well. ``projection_head.fc1.bias`` feeds a train-mode BatchNorm: its
    gradient is 0 up to rounding, and it is held only to the bound.
    """
    flip = 2 * sum(lrs) * (1 + 1e-5)
    for key, w in want.items():
        if "num_batches" in key:
            continue
        g, w, p0 = got[key].double(), w.double(), init[key].double()
        if "running" in key:
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= stats_rtol, (key, err)
            continue
        assert float((g - w).abs().max()) <= flip, key
        is_weight = key.endswith("weight") and g.dim() > 1
        if key != "projection_head.fc1.bias" and (is_weight or bn_too):
            err = float(((g - p0) - (w - p0)).norm() / (w - p0).norm())
            assert err <= update_rtol, (key, err)
    assert not torch.equal(got["encoder.conv1.weight"], init["encoder.conv1.weight"])


@pytest.mark.parametrize("b,use_pallas", [(8, False), (256, True)], ids=["dense-B8", "kernel-B256"])
def test_train_steps_match(b, use_pallas):
    """simhand_w, ResNet-18 at 32x32 in float32: B = 8 takes the dense
    route; B = 256 (2B = 512) passes the 2B % 512 gate and takes the
    kernel route in both packages.

    Tolerances: each step's loss to rel 1e-4 (measured <= 7.3e-6: XLA's and
    oneDNN's float32 convolutions round differently, and train-mode
    BatchNorm over few values per channel amplifies that); the eval loss
    after the steps to rel 5e-4 (measured <= 7.3e-5: it sees the parameters
    that stepped apart). Weight updates to 0.25 of their norm (measured 0.013
    at B = 8 and 0.127 at B = 256: about 0.4% of the elements took opposite
    Adam signs). BatchNorm statistics to 3e-2 of each tensor's largest value
    (measured 2.1e-3 and 1.6e-2). The float64 test below holds the same step
    to rounding.
    """
    (jl, tl), (je, te), init, want, got, lrs = run_both(b, use_pallas)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert te == pytest.approx(je, rel=5e-4)
    assert_states_match(init, want, got, lrs, update_rtol=0.25, stats_rtol=3e-2,
                        bn_too=False)


def test_train_steps_match_in_float64():
    """The dense-route step with float64 compute (float32 parameters and
    loss, as flax keeps them): the semantics agree to rounding. Losses to
    rel 1e-6 (measured 9.6e-8), the eval loss to 2e-6 (measured 3.8e-7),
    every update, BatchNorm's too, to 5e-3 of its norm (measured 8.2e-4:
    one element of 590k took the other Adam sign), statistics to 1e-3
    (measured 1.6e-4)."""
    (jl, tl), (je, te), init, want, got, lrs = run_both(8, False, f64=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert te == pytest.approx(je, rel=2e-6)
    assert_states_match(init, want, got, lrs, update_rtol=5e-3, stats_rtol=1e-3,
                        bn_too=True)
