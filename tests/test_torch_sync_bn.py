"""The port's cross-replica BatchNorm against the JAX package's on the
8-device CPU mesh of ``tests/conftest.py``, float32: the exact
``BatchNorm2d`` against flax's ``nn.BatchNorm(axis_name=...)``,
``SubsampledBatchNorm`` against JAX's, and the synced fused conv1x1 site
against JAX's ``_conv1x1_bn_train_synced`` (its kernel in interpret mode).

Each JAX device and each port rank (a thread over ``ThreadAxis``) takes its
rows of one batch made from a seed with numpy, and the loss of a rank is
sum(y * gy) over its own rows. Gradients are per rank, as
``shard_map(jax.grad(...), check_vma=False)`` returns them.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from simhand_tpu.models.fused_conv import _conv1x1_bn_train_synced
from simhand_tpu.models.norm import SubsampledBatchNorm as JSubsampled
from simhand_tpu_torch.models.fused_conv import conv1x1_bn_train
from simhand_tpu_torch.models.layers import BatchNorm2d
from simhand_tpu_torch.models.norm import SubsampledBatchNorm
from torch_thread_axis import run_ranks

torch.set_num_threads(2)
W, C = 8, 16
MESH = Mesh(np.array(jax.devices()), ("data",))


def rows(a: np.ndarray, axis) -> np.ndarray:
    n = a.shape[0] // axis.size
    return a[axis.index * n:(axis.index + 1) * n]


def per_device(tree):
    """Each device's leaves with a leading axis of one, for P("data")."""
    return jax.tree.map(lambda v: v[None], tree)


@pytest.mark.parametrize("kind", ["exact", "subsampled"])
def test_sync_batchnorm_matches_flax_axis_name(kind):
    """y, the running statistics after one train step and the gradients of
    x, scale and bias at W = 8, 4 images of 5x6 a rank, 16 channels:
    y within rtol 1e-5, atol 2e-6; the running statistics (equal on every
    rank) within rtol 1e-5; the gradients within rtol 1e-4, atol 1e-5 (each
    sums the batch's terms in another order). SubsampledBatchNorm with
    subsample 2 takes each rank's first 2 images."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4 * W, 5, 6, C)).astype(np.float32) * 3 + 1
    gy = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 2, C).astype(np.float32)

    if kind == "exact":
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                            axis_name="data")
    else:
        jbn = JSubsampled(subsample=2, use_running_average=False, momentum=0.9,
                          epsilon=1e-5, axis_name="data")
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def device(params, xb, gb):
        def loss(p, xx):
            y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx,
                               mutable=["batch_stats"])
            return jnp.sum(y * gb), (y, upd["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, xb)
        return y, gx, per_device(gp), new

    y_j, gx_j, gp_j, new_j = jax.jit(shard_map(
        device, mesh=MESH, in_specs=(P(), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P()), check_vma=False))(params, x, gy)

    def rank(axis):
        bn = (BatchNorm2d(C, axis=axis) if kind == "exact"
              else SubsampledBatchNorm(C, subsample=2, axis=axis))
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        bn.train()
        xb = torch.from_numpy(rows(x, axis).copy()).permute(0, 3, 1, 2).requires_grad_()
        y = bn(xb)
        gb = torch.from_numpy(rows(gy, axis).copy()).permute(0, 3, 1, 2)
        gx, gw, gbias = torch.autograd.grad((y * gb).sum(), (xb, bn.weight, bn.bias))
        return (y.detach().permute(0, 2, 3, 1), gx.permute(0, 2, 3, 1), gw, gbias,
                bn.running_mean.clone(), bn.running_var.clone())

    out = run_ranks(W, rank)
    np.testing.assert_allclose(torch.cat([o[0] for o in out]).numpy(), y_j,
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(torch.cat([o[1] for o in out]).numpy(), gx_j,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack([o[2] for o in out]).numpy(), gp_j["scale"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack([o[3] for o in out]).numpy(), gp_j["bias"],
                               rtol=1e-4, atol=1e-5)
    for o in out:
        np.testing.assert_allclose(o[4].numpy(), new_j["mean"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(o[5].numpy(), new_j["var"], rtol=1e-5)


def test_synced_conv1x1_site_matches_jax():
    """The fused conv1x1 + BatchNorm site with an axis (#10's plain version
    on the CPU) against JAX's _conv1x1_bn_train_synced with conv1x1_stats
    in interpret mode, at W = 8, 64 rows of 32 channels a rank into 16:
    o within rtol 1e-5, atol 1e-5; the global mu and var within rtol 1e-5
    (equal on every rank); dx, dw, dscale and dbias per rank within rtol
    1e-4, atol 1e-5. The scale and bias gradients are this rank's own sums,
    as in JAX."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(64 * W, 32)).astype(np.float32)
    w = (rng.normal(size=(32, C)) / 6).astype(np.float32)
    go = rng.normal(size=(64 * W, C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)

    def device(xb, wb, sb, bb, gb):
        def loss(xx, ww, ss, bbb):
            o, mu, var = _conv1x1_bn_train_synced(xx, ww, ss, bbb, 1e-5, "data")
            return jnp.sum(o * gb), (o, mu, var)

        (_, (o, mu, var)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(xb, wb, sb, bb)
        gx, gw, gs, gbias = grads
        return o, mu, var, gx, gw[None], gs[None], gbias[None]

    want = jax.jit(shard_map(
        device, mesh=MESH, in_specs=(P("data"), P(), P(), P(), P("data")),
        out_specs=(P("data"), P(), P(), P("data"), P("data"), P("data"), P("data")),
        check_vma=False))(x, w, scale, bias, go)

    def rank(axis):
        xb = torch.from_numpy(rows(x, axis).copy()).requires_grad_()
        wt = torch.from_numpy(w.T.copy()).requires_grad_()
        s = torch.from_numpy(scale).requires_grad_()
        b = torch.from_numpy(bias).requires_grad_()
        o, mu, var = conv1x1_bn_train(xb, wt, s, b, 1e-5, axis)
        grads = torch.autograd.grad((o * torch.from_numpy(rows(go, axis).copy())).sum(),
                                    (xb, wt, s, b))
        return o.detach(), mu, var, *grads

    out = run_ranks(W, rank)
    o_j, mu_j, var_j, gx_j, gw_j, gs_j, gb_j = want
    np.testing.assert_allclose(torch.cat([r[0] for r in out]).numpy(), o_j,
                               rtol=1e-5, atol=1e-5)
    for r in out:
        np.testing.assert_allclose(r[1].numpy(), mu_j, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r[2].numpy(), var_j, rtol=1e-5)
    np.testing.assert_allclose(torch.cat([r[3] for r in out]).numpy(), gx_j,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack([r[4].T for r in out]).numpy(), gw_j,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack([r[5] for r in out]).numpy(), gs_j,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch.stack([r[6] for r in out]).numpy(), gb_j,
                               rtol=1e-4, atol=1e-5)
