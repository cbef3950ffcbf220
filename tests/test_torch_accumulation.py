"""Gradient accumulation (``accumulate_grad_batches``, BASELINE.json's config
#4: global batch 8,192 as micro-batches) in the port's train step against
the JAX package's ``optax.MultiSteps`` step on the CPU: ResNet-18, 32x32,
B = 4 a micro-batch, float32, simhand_w on the dense route, from one set of
variables drawn with numpy into the JAX model's tree.

JAX's step moves ``batch_stats`` on every micro-step (they are the state the
forward returns) while MultiSteps holds the parameters until the k-th; the
port's step must do the same. Then the port's accumulated update against
one update of its own optimizer with the float32 mean of the micro-batches'
gradients (the counterpart of tests/test_train.py's slow
test_grad_accumulation_equivalent_to_averaged_update).
"""
import copy
import math

import jax
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train.optimizer import make_optimizer
from simhand_tpu.train.state import TrainState as JTrainState
from simhand_tpu.train import make_train_step as jstep
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models import contrastive_loss_from_projections
from simhand_tpu_torch.train import Optimizer
from simhand_tpu_torch.train import OptimizerConfig as TOpt
from simhand_tpu_torch.train import create_train_state as tcreate
from simhand_tpu_torch.train import make_train_step as tstep
from simhand_tpu_torch.train.optimizer import decay_mask
from test_torch_resnet_depths import XLA_QUICK, random_variables
from test_torch_train_step import OPT, SIDE, assert_states_match, synthetic_batch, to_numpy

torch.set_num_threads(2)
K, B = 2, 4
# k = 2 over OPT: no warmup step (warmup_epochs * iters // k = 0), so the
# first update runs at the base learning rate lr * sqrt(1024 k)
ACCUM = dict(OPT, accumulate_grad_batches=K)
CFG = dict(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
           image_side=float(SIDE))


def state_dict_of(jstate) -> dict:
    return from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))


@pytest.fixture(scope="module")
def micro_batches():
    return [synthetic_batch(B, seed) for seed in range(K)]


@pytest.fixture(scope="module")
def jax_run(micro_batches):
    """JAX's step over 2k micro-steps (two updates), the micro-batches in
    turn: the initial state dict and the state dict after each micro-step."""
    jm = JModel(resnet_size="18")
    variables = random_variables("18", 0)
    jstate = JTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                tx=make_optimizer(JOpt(**ACCUM), variables["params"]),
                                batch_stats=variables["batch_stats"])
    states = [state_dict_of(jstate)]         # before the step donates the state
    step = jstep(jm, JConfig(**CFG)).lower(jstate, micro_batches[0]).compile(XLA_QUICK)
    for i in range(2 * K):
        jstate, _ = step(jstate, micro_batches[i % K])
        states.append(state_dict_of(jstate))
    return states


def test_accumulated_steps_match_multisteps(micro_batches, jax_run):
    """After each micro-step: the parameters equal the initial ones bit for
    bit in both packages until the k-th, the running statistics have moved
    on every one (within 3e-2 of JAX's largest, test_torch_train_step.py's
    float32 limit for train-mode BatchNorm over few values a channel), and
    after each k-th the parameters agree as that file holds one update
    (every element within 2 lr, each weight's update within 0.25 of its
    norm: Adam's first steps are +-lr where a gradient is near 0)."""
    init, *want = jax_run
    model = TModel("18")
    state = tcreate(model, TOpt(**ACCUM), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    model.load_state_dict(init, strict=True)
    step = tstep(model, TConfig(**CFG))
    lr = state.optimizer.schedule(0)
    assert lr == pytest.approx(TOpt(**ACCUM).base_lr, rel=1e-6)
    last, last_want = init, init
    for i in range(2 * K):
        batch = {k: torch.from_numpy(v) for k, v in micro_batches[i % K].items()}
        state, metrics = step(state, batch)
        assert math.isfinite(metrics["contrastive_loss"].item())
        got = {k: v.clone() for k, v in model.state_dict().items()}
        emitted = (i + 1) % K == 0
        assert (state.optimizer.count, state.optimizer.mini_step) == ((i + 1) // K, (i + 1) % K)
        for key, w in want[i].items():
            if "running" in key:
                assert not torch.equal(got[key], last[key]), (i, key)
                assert not torch.equal(w, last_want[key]), (i, key)
                err = float((got[key] - w).abs().max() / w.abs().max())
                assert err <= 3e-2, (i, key, err)
            elif "num_batches" not in key:
                # held until the k-th micro-step, in both packages
                assert torch.equal(got[key], last[key]) != emitted, (i, key)
                assert torch.equal(w, last_want[key]) != emitted or key.endswith("fc1.bias"), (
                    i, key)
        if emitted:
            lrs = [state.optimizer.schedule(c) for c in range(state.optimizer.count)]
            assert_states_match(init, want[i], got, lrs, update_rtol=0.25, stats_rtol=3e-2,
                                bn_too=False)
        last, last_want = got, want[i]


def test_accumulated_update_is_the_averaged_update(micro_batches):
    """k micro-steps of the port's step against its own optimizer handed the
    float32 mean of the k gradients (each taken at the initial parameters,
    as the held parameters give them) at the same base learning rate and
    schedule (lr * sqrt(k), the same total steps). The gradient the
    accumulator hands to its update equals that mean within 1e-6 of each
    tensor's largest element (a running mean and a mean round differently),
    and the parameters equal that update of the accumulated gradient bit for
    bit. Against the update of the plain mean every element is within 1e-5
    of its update's largest element plus lr |dg| / eps, dg its two
    gradients' difference: Adam's first update m / (sqrt(v) + eps) =
    x / (|x| + eps) of the LARS-scaled gradient x (trust <= 1) is
    scale-free, its slope at most 1 / eps, so where the mean of the
    micro-gradients cancels to within ~eps of 0 a rounding of the mean
    moves the element by up to the update's size (measured: 1.0e-2 of the
    largest element in the worst tensor, 1.4e-5 in norm)."""
    model = TModel("18")
    state = tcreate(model, TOpt(**ACCUM), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    reference = copy.deepcopy(model)
    init = [p.detach().clone() for p in model.parameters()]
    cfg = TConfig(**CFG)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in micro_batches]

    handed = []
    update = state.optimizer._update

    def recording_update(params, grads):
        handed.append([g.clone() for g in grads])
        return update(params, grads)

    state.optimizer._update = recording_update
    step = tstep(model, cfg)
    for b in batches:
        state, _ = step(state, b)
    assert len(handed) == 1

    grads = []
    for b in batches:
        reference.train()
        _, proj = reference(torch.cat([b["transformed_image1"], b["transformed_image2"]]))
        loss, _ = contrastive_loss_from_projections(proj, b, cfg)
        grads.append(torch.autograd.grad(loss, list(reference.parameters())))
    mean = [sum(gs) / K for gs in zip(*grads)]
    names = [n for n, _ in model.named_parameters()]
    for name, got, want in zip(names, handed[0], mean):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()), name

    plain = TOpt(**dict(ACCUM, accumulate_grad_batches=1, lr=TOpt().lr * math.sqrt(K),
                        epochs=ACCUM["epochs"] // K, warmup_epochs=0))
    assert plain.base_lr == pytest.approx(TOpt(**ACCUM).base_lr)
    assert (plain.total_steps, plain.warmup_steps) == (TOpt(**ACCUM).total_steps, 0)
    for grad, name in ((handed[0], "accumulated"), (mean, "mean")):
        ref = copy.deepcopy(reference)
        params = list(ref.parameters())
        Optimizer(plain, params, decay_mask(ref)).step(params, grad)
        lr = state.optimizer.schedule(0)
        for got, want, p0, g, m in zip(model.parameters(), params, init, handed[0], mean):
            if name == "accumulated":
                assert torch.equal(got, want)
                continue
            d, u = (got - want).detach().double(), (want - p0).detach().double()
            bound = 1e-5 * u.abs().max() + 1.01 * lr * (g - m).abs().double() / 1e-8
            assert bool((d.abs() <= bound).all())
    moved = [not torch.equal(p, p0) for p, p0 in zip(model.parameters(), init)]
    assert sum(moved) > 0.9 * len(moved)
