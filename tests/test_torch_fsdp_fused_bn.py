"""The port's FSDP step with every fused BatchNorm mode
(``bn_fused`` True, "xla", "pallas", "epilogue", "epilogue_xla", and
"pallas" with the statistics' gradients stopped): the
kernels #5-#9 (their plain versions on the CPU) reduce each rank's rows and
their per-channel sums are all-reduced over the ranks, as the JAX package's
GSPMD step (``simhand_tpu/parallel/fsdp.py``, ``_step_fn(axis_name=None)``)
computes them over the global batch.

JAX's own FSDP contract (``tests/test_fsdp.py``): the FSDP step equals the
single-device step on the global batch. So each mode's FSDP step on 2
thread ranks (``torch_thread_axis``) is held against the port's
single-device step with the same ``bn_fused``: simhand_w at ResNet-18,
float32, global B = 16 at 32x32, 2 steps, from one JAX init carried over
by ``convert``. One mode is also held against JAX's single-device step
with that ``bn_fused`` (Pallas #9 in interpret mode), and one against
JAX's FSDP step itself on a 2-device mesh. A per-replica control (each
rank's rows through its own statistics, no reduce) must fail the limits,
so the test sees the reduce.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_fsdp import CFG, global_batch, mu_errors
from test_torch_train_step import OPT, assert_states_match, to_numpy

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.parallel.fsdp import make_fsdp_train_step as jfsdp
from simhand_tpu.train import OptimizerConfig as JOpt
from simhand_tpu.train import create_train_state as jcreate
from simhand_tpu.train import make_train_step as jstep
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models.bn_epilogue import BNRelu
from simhand_tpu_torch.models.fused_bn import FusedBatchNorm
from simhand_tpu_torch.parallel import make_fsdp_train_step
from simhand_tpu_torch.train import OptimizerConfig as TOpt
from simhand_tpu_torch.train import create_train_state as tcreate
from simhand_tpu_torch.train import make_schedule as tschedule
from simhand_tpu_torch.train import make_train_step as tstep
from torch_thread_axis import run_ranks

torch.set_num_threads(2)
SIDE, STEPS, W = 32, 2, 2
# id -> the model's BatchNorm options; "pallas-stop-grad" stops the
# statistics' gradients (dx = a dy: no backward all-reduce)
MODES = {"true": {"bn_fused": True}, "xla": {"bn_fused": "xla"},
         "pallas": {"bn_fused": "pallas"}, "epilogue": {"bn_fused": "epilogue"},
         "epilogue_xla": {"bn_fused": "epilogue_xla"},
         "pallas-stop-grad": {"bn_fused": "pallas", "bn_stop_gradient_stats": True}}
# the limits of tests/test_torch_fsdp.py for the exact BatchNorm: the
# step-0 loss to rel 1e-6 (the global statistics from the ranks' sums
# round otherwise than one device's mean; measured 1.5e-7 in every mode),
# the first step's mu (0.1 x the gradient) to 5e-2 of each tensor's norm
# (rounding carried back through the BatchNorm backwards at this init;
# measured 1.1e-3 for FusedBatchNorm, 9.0e-6 for the epilogue; a missing
# reduce or a wrong row count is off by O(1): the per-replica control
# reads 1.43, and 7.1e-3 in the loss), the later loss to 1e-4 (Adam's sign
# flips)
LOSS0_RTOL, MU_RTOL, LOSS_RTOL = 1e-6, 5e-2, 1e-4


@pytest.fixture(scope="module")
def init():
    """JAX's initial state (one compiled init, bn_fused=True: the fused
    modes share the exact model's tree) and the port's state dict of it."""
    jm = JModel(resnet_size="18", bn_fused=True)
    template = jax.jit(lambda key: jcreate(jm, JOpt(**OPT), key,
                                           input_shape=(2, SIDE, SIDE, 3)))(jax.random.key(0))
    return template, from_flax_variables(to_numpy(template.params),
                                         to_numpy(template.batch_stats))


def _model(sd, bn):
    model = TModel("18", **bn)
    state = tcreate(model, TOpt(**OPT), 0, input_shape=(2, SIDE, SIDE, 3), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model, state


def one_device(sd, bn, batches):
    """The port's single-device step: losses, the first step's mu, the
    final state dict."""
    model, state = _model(sd, bn)
    step, losses, mu0 = tstep(model, TConfig(**CFG)), [], None
    for batch in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["contrastive_loss"]))
        mu0 = mu0 or [m.clone() for m in state.optimizer.mu]
    return losses, mu0, model.state_dict()


def fsdp_rank(axis, sd, bn, batches, per_replica=False):
    """One rank's FSDP run: losses, the first step's whole mu, the final
    whole state dict; ``per_replica``: every BatchNorm on this rank's rows
    alone (the control)."""
    model, state = _model(sd, bn)
    step, place_state, place_batch = make_fsdp_train_step(model, TConfig(**CFG), axis, state)
    fused = [m for m in model.modules() if isinstance(m, (FusedBatchNorm, BNRelu))]
    assert fused and all(m.axis is axis for m in fused)
    if per_replica:
        model.sync_batch_norms(None)
    state, losses, mu0 = place_state(state), [], None
    for batch in batches:
        state, metrics = step(state, place_batch(batch))
        losses.append(float(metrics["contrastive_loss"]))
        mu0 = mu0 or [t.clone() for t in state.payload()["optimizer"]["mu"]]
    return losses, mu0, state.payload()["model"]


def jax_run(template, bn_fused, batches, mesh=None):
    """JAX's losses and final state dict: its single-device step with
    ``bn_fused`` (Pallas in interpret mode on the CPU), or its FSDP step on
    ``mesh``."""
    jm, jcfg = JModel(resnet_size="18", bn_fused=bn_fused), JConfig(**CFG)
    template = jax.tree.map(jax.numpy.copy, template)     # both steps donate their state
    if mesh is None:
        step, state, place = jstep(jm, jcfg), template, lambda b: b
    else:
        step, place_state, place = jfsdp(jm, jcfg, mesh, template)
        state = place_state(template)
    losses = []
    for batch in batches:
        state, metrics = step(state, place({k: jax.numpy.asarray(v) for k, v in batch.items()}))
        losses.append(float(metrics["contrastive_loss"]))
    return losses, from_flax_variables(to_numpy(state.params), to_numpy(state.batch_stats))


@pytest.mark.parametrize("mode", list(MODES))
def test_fsdp_fused_bn_matches_one_device(init, mode):
    """W = 2, global B = 16, 2 steps: each rank's step-0 loss within rel
    1e-6 of the single-device step's with the same options, its second
    within 1e-4, the first step's mu within 5e-2 of each tensor's norm,
    the ranks' final states equal bit for bit. The per-replica control (one
    step) departs beyond both first limits. "pallas" is held against JAX's
    single-device step with bn_fused="pallas" (#9 in interpret mode) and
    "true" against JAX's FSDP step on a 2-device mesh: each loss to rel
    1e-4 and the state within tests/test_torch_train_step.py's limits, as
    tests/test_torch_fsdp.py holds the exact BatchNorm."""
    template, sd = init
    bn = MODES[mode]
    batches = [global_batch(s) for s in range(STEPS)]
    losses, mu0, want = one_device(sd, bn, batches)
    out = run_ranks(W, lambda axis: fsdp_rank(axis, sd, bn, batches))
    for glosses, gmu0, _ in out:
        np.testing.assert_allclose(glosses[0], losses[0], rtol=LOSS0_RTOL)
        np.testing.assert_allclose(glosses, losses, rtol=LOSS_RTOL)
        assert max(mu_errors(gmu0, mu0)) <= MU_RTOL
    got = out[0][2]
    assert all(torch.equal(got[k], out[1][2][k]) for k in got)
    lrs = [tschedule(TOpt(**OPT))(i) for i in range(STEPS)]
    assert_states_match(sd, want, got, lrs, update_rtol=0.25, stats_rtol=3e-2, bn_too=False)

    control = run_ranks(W, lambda axis: fsdp_rank(axis, sd, bn, batches[:1],
                                                  per_replica=True))
    for closses, cmu0, _ in control:
        assert abs(closses[0] / losses[0] - 1) > LOSS0_RTOL
        assert max(mu_errors(cmu0, mu0)) > MU_RTOL

    if mode in ("pallas", "true"):
        mesh = Mesh(np.array(jax.devices()[:W]), ("data",)) if mode == "true" else None
        jlosses, jwant = jax_run(template, bn["bn_fused"], batches, mesh)
        np.testing.assert_allclose(out[0][0], jlosses, rtol=LOSS_RTOL)
        assert_states_match(sd, jwant, got, lrs, update_rtol=0.25, stats_rtol=3e-2,
                            bn_too=False)
