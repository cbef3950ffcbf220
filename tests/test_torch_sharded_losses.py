"""The port's global-batch losses and weight statistics over a data axis
against the JAX package's ``shard_map`` on the 8-device CPU mesh of
``tests/conftest.py``.

The port's W ranks run as threads over ``torch_thread_axis.ThreadAxis``.
Inputs are made from a seed with numpy; each rank takes its rows of the
global batch, as ``P("data")`` gives each JAX device its rows. Gradients
are per rank, as ``shard_map(jax.grad(...), check_vma=False)`` returns
them: the dense losses give W times the global gradient, the kernel
losses the global gradient itself (ROADMAP Queue 3, the gradient-scale
fault of the reference).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from simhand_tpu.losses import contrastive as jcon
from simhand_tpu.losses import pallas_ntxent as jpal
from simhand_tpu.losses import weights as jw
from simhand_tpu_torch.losses import contrastive as tcon
from simhand_tpu_torch.losses import ntxent_kernels as tker
from simhand_tpu_torch.losses import weights as tw
from torch_thread_axis import run_ranks

torch.set_num_threads(2)
W, T = 8, 0.5
MESH = Mesh(np.array(jax.devices()), ("data",))


def normalize(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def inputs(b: int, seed: int):
    rng = np.random.default_rng(seed)
    z1, z2 = normalize(rng.normal(size=(b, 128))), normalize(rng.normal(size=(b, 128)))
    j1 = rng.uniform(0, 128, (b, 21, 2)).astype(np.float32)
    j2 = rng.uniform(0, 128, (b, 21, 2)).astype(np.float32)
    return z1, z2, j1, j2


def rows(a: np.ndarray, axis) -> torch.Tensor:
    n = a.shape[0] // axis.size
    return torch.from_numpy(a[axis.index * n:(axis.index + 1) * n].copy())


def jax_sharded(fn, *args):
    """(value, per-device gradients w.r.t. z1 and z2) of fn(z1, z2, j1, j2)
    inside shard_map over the 8 devices."""
    out_specs = (P(), (P("data"), P("data")))
    vg = jax.value_and_grad(fn, argnums=(0, 1))
    value, grads = jax.jit(shard_map(vg, mesh=MESH, in_specs=(P("data"),) * 4,
                                     out_specs=out_specs, check_vma=False))(*args)
    return float(value), [np.asarray(g) for g in grads]


def torch_sharded(fn, z1, z2, j1, j2):
    """(each rank's value, the ranks' gradients concatenated) of
    fn(z1, z2, j1, j2, axis) on W thread ranks."""
    def rank(axis):
        a, b = rows(z1, axis).requires_grad_(), rows(z2, axis).requires_grad_()
        loss = fn(a, b, rows(j1, axis), rows(j2, axis), axis)
        ga, gb = torch.autograd.grad(loss, (a, b))
        return float(loss.detach()), ga, gb

    out = run_ranks(W, rank)
    return [o[0] for o in out], [torch.cat([o[k] for o in out]).numpy() for k in (1, 2)]


def _jax_dense(name):
    def plain(z1, z2, j1, j2):
        return jcon.nt_xent(z1, z2, T, "data")

    def weighted(z1, z2, j1, j2):
        pw, nw = jw.linear_weights(j1, j2, "mpjpe", axis_name="data")
        return {"weighted": lambda: jcon.weighted_nt_xent(z1, z2, pw, nw, T, "data"),
                "pos": lambda: jcon.pos_weighted_nt_xent(z1, z2, pw, T, "data"),
                "neg": lambda: jcon.neg_weighted_nt_xent(z1, z2, nw, T, "data")}[name]()

    return plain if name == "nt_xent" else weighted


def _torch_dense(name):
    def loss(z1, z2, j1, j2, axis):
        if name == "nt_xent":
            return tcon.nt_xent(z1, z2, T, axis)
        pw, nw = tw.linear_weights(j1, j2, "mpjpe", axis)
        return {"weighted": lambda: tcon.weighted_nt_xent(z1, z2, pw, nw, T, axis),
                "pos": lambda: tcon.pos_weighted_nt_xent(z1, z2, pw, T, axis),
                "neg": lambda: tcon.neg_weighted_nt_xent(z1, z2, nw, T, axis)}[name]()

    return loss


@pytest.mark.parametrize("name", ["nt_xent", "weighted", "pos", "neg"])
def test_dense_losses_match_shard_map(name):
    """All four dense losses at W = 8, B = 64 pairs (8 a rank), the weights
    from linear mpjpe statistics over the axis. Values within rel 1e-5 on
    every rank; per-rank z-gradients within rtol 2e-4, atol 1e-7 (a
    gradient sums 2N terms of both signs). Both are W = 8 times the
    single-device gradient of the global loss (rel 1e-4): the transposes of
    all_gather and pmean sum the ranks' cotangents."""
    z1, z2, j1, j2 = inputs(64, 7)
    want, jgrads = jax_sharded(_jax_dense(name), z1, z2, j1, j2)
    values, grads = torch_sharded(_torch_dense(name), z1, z2, j1, j2)
    assert values == pytest.approx([want] * W, rel=1e-5)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-7)

    a, b = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
    loss = _torch_dense(name)(a, b, torch.from_numpy(j1), torch.from_numpy(j2), None)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for g, single in zip(grads, torch.autograd.grad(loss, (a, b))):
        np.testing.assert_allclose(g, W * single.numpy(), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def kernel_inputs():
    # B = 1,024 pairs: 256 rows a device, the sharded kernels' tiles
    return inputs(1024, 31)


@pytest.mark.parametrize("family", ["plain", "weighted"])
def test_sharded_kernel_losses_match_interpret(family, kernel_inputs):
    """make_sharded_nt_xent_kernel / make_sharded_weighted_nt_xent_kernel
    (kernels #1/#3 and #2/#4 through their plain versions on the CPU) at
    W = 8, B = 1,024 against JAX's make_sharded_*_pallas in interpret mode,
    as tests/test_pallas_ntxent.py does: the plain family's value within
    rel 1e-5 and per-rank gradients within rtol 2e-4, atol 1e-7, the
    weighted family's within rel 1e-4 and rtol 1e-3 (the pallas kernel
    recomputes the weights tile by tile). A rank's gradient is the global
    one (x1), not W times it."""
    z1, z2, j1, j2 = kernel_inputs
    if family == "plain":
        jfn = jpal.make_sharded_nt_xent_pallas("data", T, interpret=True)
        want, jgrads = jax_sharded(lambda a, b, c, d: jfn(a, b), z1, z2, j1, j2)
        values, grads = torch_sharded(
            lambda a, b, c, d, axis: tker.make_sharded_nt_xent_kernel(axis, T)(a, b),
            z1, z2, j1, j2)
        rel, rtol = 1e-5, 2e-4
        single = functools.partial(tcon.nt_xent, temperature=T)
    else:
        jfn = jpal.make_sharded_weighted_nt_xent_pallas("data", T, interpret=True)
        want, jgrads = jax_sharded(jfn, z1, z2, j1, j2)
        values, grads = torch_sharded(
            lambda a, b, c, d, axis: tker.make_sharded_weighted_nt_xent_kernel(axis, T)(
                a, b, c, d), z1, z2, j1, j2)
        rel, rtol = 1e-4, 1e-3

        def single(a, b):
            pw, nw = tw.linear_weights(torch.from_numpy(j1), torch.from_numpy(j2), "mpjpe")
            return tcon.weighted_nt_xent(a, b, pw, nw, T)
    assert values == pytest.approx([want] * W, rel=rel)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)

    a, b = torch.from_numpy(z1).requires_grad_(), torch.from_numpy(z2).requires_grad_()
    global_grads = torch.autograd.grad(single(a, b), (a, b))
    for g, gg in zip(grads, global_grads):
        np.testing.assert_allclose(g, gg.numpy(), rtol=rtol, atol=1e-7)


def _jax_stats(fn):
    return jax.jit(shard_map(fn, mesh=MESH, in_specs=(P("data"),) * 2, out_specs=P("data"),
                             check_vma=False))


@pytest.mark.parametrize("case", ["linear", "nonlinear", "linear_pca", "pairwise_minmax",
                                  "gstats"])
def test_weight_statistics_match_shard_map(case):
    """The global statistics of losses/weights.py at W = 8, B = 48 pairs:
    linear and sigmoid weights (pmin / pmax / pmean, all-gathered columns),
    PCA-reduced linear weights (pmean'd mean, psum'd second moment and
    count), pairwise_minmax (all-gathered columns, pmin / pmax, chunks of
    16 columns) and _gmin / _gmax / _gmean. Each rank's outputs within rtol
    1e-5 (atol 1e-6 for weights near 0), except: the sigmoid weights within
    rtol 1e-4, atol 1e-7 (measured 3.4e-5: the weight's relative rounding
    is ~lambda |d - mu| eps with lambda |d - mu| up to ~80 at pixel scale,
    and mu is a pmean of the ranks' means, summed in another order), and
    the PCA case within rtol 1e-4, atol 2e-3, whose basis comes from an
    eigendecomposition, as tests/test_torch_losses.py holds apply_pca."""
    _, _, j1, j2 = inputs(48, 11)

    def jax_fn(a, b):
        if case == "linear":
            return jnp.concatenate([x.reshape(-1) for x in
                                    jw.linear_weights(a, b, "mpjpe", axis_name="data")])
        if case == "nonlinear":
            return jnp.concatenate([x.reshape(-1) for x in jw.nonlinear_weights(
                a, b, 5.0, 0.05, "w_abs", axis_name="data")])
        if case == "linear_pca":
            pa, pb = jw.apply_pca(a, 6, axis_name="data"), jw.apply_pca(b, 6, axis_name="data")
            pw, nw = jw.linear_weights(pa, pb, "w_o_abs", axis_name="data", flat=True)
            return jnp.concatenate([pa.reshape(-1), pw, nw.reshape(-1)])
        if case == "pairwise_minmax":
            return jnp.stack(jw.pairwise_minmax(a, "mpjpe", chunk=16, axis_name="data"))
        d = jnp.linalg.norm(a - b, axis=-1).reshape(-1)
        return jnp.stack([jw._gmin(d, "data"), jw._gmax(d, "data"), jw._gmean(d, "data")])

    def torch_fn(axis):
        a, b = rows(j1, axis), rows(j2, axis)
        if case == "linear":
            out = tw.linear_weights(a, b, "mpjpe", axis)
        elif case == "nonlinear":
            out = tw.nonlinear_weights(a, b, 5.0, 0.05, "w_abs", axis)
        elif case == "linear_pca":
            pa, pb = tw.apply_pca(a, 6, axis), tw.apply_pca(b, 6, axis)
            out = (pa, *tw.linear_weights(pa, pb, "w_o_abs", axis, flat=True))
        elif case == "pairwise_minmax":
            return torch.stack(tw.pairwise_minmax(a, "mpjpe", chunk=16, axis=axis))
        else:
            d = torch.linalg.vector_norm(a - b, dim=-1).reshape(-1)
            return torch.stack([tw._gmin(d, axis), tw._gmax(d, axis), tw._gmean(d, axis)])
        return torch.cat([x.reshape(-1) for x in out])

    want = np.asarray(_jax_stats(jax_fn)(j1, j2)).reshape(W, -1)
    got = run_ranks(W, torch_fn)
    rtol, atol = {"nonlinear": (1e-4, 1e-7), "linear_pca": (1e-4, 2e-3)}.get(case, (1e-5, 1e-6))
    for r in range(W):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=rtol, atol=atol)
