"""The port's NT-Xent kernels (``simhand_tpu_torch/losses/ntxent_kernels.py``)
against the JAX package's Pallas kernels, run as their own tests run them
on the CPU (``interpret=True``).

On the CPU the wrappers take their kernels' plain versions; the CUDA
kernels themselves run only on the card (``tests/test_torch_gpu_kernels.py``
and ``chip_smoke.py``). Inputs are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.losses import linear_weights
from simhand_tpu.losses import contrastive as jcon
from simhand_tpu.losses import pallas_ntxent as P
from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.models.contrastive import contrastive_loss_from_projections as jloss
from simhand_tpu_torch.losses import ntxent_kernels as K
from simhand_tpu_torch.models.contrastive import ContrastiveConfig as TConfig
from simhand_tpu_torch.models.contrastive import contrastive_loss_from_projections as tloss

torch.set_num_threads(2)
T = 0.5
# the tolerances of tests/test_pallas_ntxent.py:113,150: a denominator sums
# N positive terms; a gradient sums N vectors of both signs (plain), times
# weights rebuilt from 21 square roots (weighted)
DENOM_RTOL = 2e-5
GRAD_RTOL = {"ntxent_grad": 2e-4, "weighted_grad_rows": 1e-3}
GRAD_ATOL = 1e-7


def normalize(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=["full", "shard"])
def case(request):
    """M = N = 512, or a 256-row shard at offset 256 of 512 columns."""
    rng = np.random.default_rng(0)
    n = 512
    m, off = (512, 0) if request.param == "full" else (256, 256)
    z_cols = normalize(rng.normal(size=(n, 128)))
    j_cols = rng.uniform(0, 128, (n, 21, 2)).astype(np.float32)
    col_ids = np.arange(n, dtype=np.int32)
    d = np.linalg.norm(j_cols[:, None] - j_cols[None, :], axis=-1).mean(-1)
    inv_cols = (1.0 / np.asarray(P.ntxent_denominator(
        z_cols, z_cols, col_ids, T, interpret=True))).astype(np.float32)
    return {
        "z_rows": z_cols[off:off + m], "z_cols": z_cols,
        "j_rows": j_cols[off:off + m], "j_cols": j_cols,
        "row_ids": np.arange(off, off + m, dtype=np.int32),
        "inv_rows": inv_cols[off:off + m], "inv_cols": inv_cols,
        "d_max": np.float32(d.max()), "d_min": np.float32(d.min()),
    }


def _args(c, names):
    return [c[k] for k in names]


KERNEL_ARGS = {
    "ntxent_denominator": ("z_rows", "z_cols", "row_ids"),
    "weighted_ntxent_denominator": ("z_rows", "z_cols", "j_rows", "j_cols", "row_ids",
                                    "d_max", "d_min"),
    "ntxent_grad": ("z_rows", "z_cols", "inv_rows", "inv_cols", "row_ids"),
    "weighted_grad_rows": ("z_rows", "z_cols", "j_rows", "j_cols", "inv_rows",
                           "inv_cols", "row_ids", "d_max", "d_min"),
}
JAX_KERNELS = {
    "ntxent_denominator": P.ntxent_denominator,
    "weighted_ntxent_denominator": P.weighted_ntxent_denominator,
    "ntxent_grad": P._ntxent_grad,
    "weighted_grad_rows": P._weighted_grad_rows,
}


@pytest.mark.parametrize("name", list(KERNEL_ARGS))
def test_plain_version_matches_pallas_interpret(case, name):
    args = _args(case, KERNEL_ARGS[name])
    want = np.asarray(JAX_KERNELS[name](*[jnp.asarray(a) for a in args], T,
                                        interpret=True))
    got = getattr(K, f"{name}_plain")(*[t(a) for a in args], T).numpy()
    if "grad" in name:
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL[name], atol=GRAD_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=DENOM_RTOL)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch(case):
    K.reset_launches()
    for name, keys in KERNEL_ARGS.items():
        args = [t(a) for a in _args(case, keys)]
        got = getattr(K, name)(*args, T)
        want = getattr(K, f"{name}_plain")(*args, T)
        assert torch.equal(got, want), name
    assert [fn.launches for fn in K.KERNELS] == [0, 0, 0, 0]


def test_wrappers_refuse_other_devices(case):
    z = t(case["z_rows"])
    with pytest.raises(ValueError, match="several devices"):
        K.ntxent_denominator(z, z.to("meta"), t(case["row_ids"]))
    with pytest.raises(ValueError, match="unsupported device"):
        K.ntxent_denominator(z.to("meta"), z.to("meta"), t(case["row_ids"]).to("meta"))


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(5)
    b = 256                                     # 2B = 512 rows
    z1, z2 = normalize(rng.normal(size=(b, 128))), normalize(rng.normal(size=(b, 128)))
    j1 = rng.uniform(0, 128, (b, 21, 2)).astype(np.float32)
    j2 = rng.uniform(0, 128, (b, 21, 2)).astype(np.float32)
    return z1, z2, j1, j2


def _loss_and_grads(fn, z1, z2):
    tz1, tz2 = t(z1).requires_grad_(), t(z2).requires_grad_()
    loss = fn(tz1, tz2)
    return loss.item(), torch.autograd.grad(loss, (tz1, tz2))


def test_nt_xent_kernel_function_matches_pallas_vjp(pairs):
    z1, z2, _, _ = pairs
    want_loss = float(P.nt_xent_pallas(z1, z2, T, True))
    want = jax.grad(lambda a, b: P.nt_xent_pallas(a, b, T, True), argnums=(0, 1))(z1, z2)
    loss, grads = _loss_and_grads(lambda a, b: K.nt_xent_kernel(a, b, T), z1, z2)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=1e-7)


def test_weighted_nt_xent_kernel_function_matches_pallas_vjp(pairs):
    z1, z2, j1, j2 = pairs
    pw, _ = linear_weights(j1, j2, "mpjpe")
    joints = np.concatenate([j1, j2])
    d = np.linalg.norm(joints[:, None] - joints[None, :], axis=-1).mean(-1)
    minmax = np.asarray([d.max(), d.min()], np.float32)
    want_loss = float(P.weighted_nt_xent_pallas(z1, z2, joints, pw, minmax, T, True))
    want = jax.grad(lambda a, b: P.weighted_nt_xent_pallas(a, b, joints, pw, minmax, T, True),
                    argnums=(0, 1))(z1, z2)
    loss, grads = _loss_and_grads(
        lambda a, b: K.weighted_nt_xent_kernel(a, b, t(joints), t(pw), t(minmax), T), z1, z2)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-7)
    # and the dense route that autograd differentiates agrees too
    _, nw = linear_weights(j1, j2, "mpjpe")
    assert loss == pytest.approx(float(jcon.weighted_nt_xent(z1, z2, pw, nw, T)), rel=1e-4)


def _batch(rng, b, side=128.0):
    return {
        "jitter_x_1": rng.uniform(-10, 0, b), "jitter_x_2": rng.uniform(-10, 0, b),
        "jitter_y_1": rng.uniform(-10, 0, b), "jitter_y_2": rng.uniform(-10, 0, b),
        "angle_1": rng.uniform(-45, 45, b), "angle_2": rng.uniform(-45, 45, b),
        "joints1_aug": rng.uniform(0, side, (b, 21, 3)),
        "joints2_aug": rng.uniform(0, side, (b, 21, 3)),
    }


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("etype", ["simclr", "simhand_w"])
def test_contrastive_loss_from_projections_matches(etype, use_pallas):
    """Both routes of the dispatch: B = 256 passes the 2B % 512 gate when
    use_pallas is on, so both packages take their kernel route."""
    rng = np.random.default_rng(11)
    b = 256
    proj = rng.normal(size=(2 * b, 128)).astype(np.float32)
    batch = {k: v.astype(np.float32) for k, v in _batch(rng, b).items()}
    kw = dict(experiment_type=etype, augmentation=("crop", "rotate", "resize"),
              use_pallas=use_pallas)
    (want, _), want_g = jax.value_and_grad(
        lambda p: jloss(p, batch, JConfig(**kw)), has_aux=True)(proj)
    tp = t(proj).requires_grad_()
    got, _ = tloss(tp, {k: t(v) for k, v in batch.items()}, TConfig(**kw))
    (got_g,) = torch.autograd.grad(got, tp)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    # the gradient passes the equivariance transform's normalisations
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-3, atol=1e-8)
