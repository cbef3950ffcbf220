"""The port's subsampled / stop-gradient BatchNorm (``models/norm.py``) and
first-match max-pool (``models/pool.py``) against the JAX package on the
CPU, alone and inside a ResNet-18 ContrastiveModel. Inputs are made from a
seed with numpy; float32 unless a test says otherwise.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.norm import SubsampledBatchNorm as JNorm
from simhand_tpu.models.pool import max_pool_firstmatch as jpool
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models.layers import BatchNorm2d
from simhand_tpu_torch.models.norm import SubsampledBatchNorm
from simhand_tpu_torch.models.pool import max_pool_firstmatch

torch.set_num_threads(2)


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("stop_grad", [False, True], ids=["grad", "stop_grad"])
@pytest.mark.parametrize("subsample", [1, 4, -1])
def test_subsampled_batchnorm_matches_flax(subsample, stop_grad):
    """Train mode: output, the gradients of x, scale and bias, the running
    statistics; eval mode: the output. The same float32 expressions summed
    in another order: rtol 1e-5 of each tensor's largest element (the
    x-gradient through the statistics: 1e-4, a difference of two sums). A
    negative subsample takes the whole batch, as flax's does."""
    rng = np.random.default_rng(abs(subsample) + 2 * stop_grad)
    shape, c = (8, 6, 6, 16), 16
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    params = {"scale": (rng.normal(size=c) * 0.5 + 1).astype(np.float32),
              "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.normal(size=c) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    jm = JNorm(subsample=subsample, stop_gradient_stats=stop_grad)

    def train(x, p):
        return jm.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])

    y, vjp, new_stats = jax.vjp(train, jnp.asarray(x), params, has_aux=True)
    dx, dparams = vjp(jnp.asarray(g))
    # eval mode after the statistics update
    y_eval = jm.apply({"params": params, **new_stats}, jnp.asarray(x),
                      use_running_average=True)

    bn = SubsampledBatchNorm(c, subsample=subsample, stop_gradient_stats=stop_grad)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    tx = nchw(x).requires_grad_()
    ty = bn.train()(tx)
    tdx, tds, tdb = torch.autograd.grad(ty, (tx, bn.weight, bn.bias), nchw(g))
    with torch.no_grad():
        ty_eval = bn.eval()(nchw(x))

    def close(got, want, rtol=1e-5):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= rtol * np.abs(want).max()

    close(to_nhwc(ty), y)
    close(to_nhwc(tdx), dx, 1e-4)
    close(tds.numpy(), dparams["scale"])
    close(tdb.numpy(), dparams["bias"])
    close(bn.running_mean.numpy(), new_stats["batch_stats"]["mean"])
    close(bn.running_var.numpy(), new_stats["batch_stats"]["var"])
    close(to_nhwc(ty_eval), y_eval)


@pytest.mark.parametrize("stop_grad", [False, True], ids=["grad", "stop_grad"])
def test_subsample_zero_raises_in_train_mode_as_flax(stop_grad):
    """subsample=0: the reference's train mode divides by it
    (ZeroDivisionError); eval mode reads the running statistics alone and
    gives the same output in both packages."""
    rng = np.random.default_rng(7)
    c = 8
    x = rng.normal(size=(4, 3, 3, c)).astype(np.float32)
    params = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
    stats = {"mean": (rng.normal(size=c) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    jm = JNorm(subsample=0, stop_gradient_stats=stop_grad)
    with pytest.raises(ZeroDivisionError):
        jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 mutable=["batch_stats"])
    bn = SubsampledBatchNorm(c, subsample=0, stop_gradient_stats=stop_grad)
    with pytest.raises(ZeroDivisionError):
        bn.train()(nchw(x))
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got = to_nhwc(bn.eval()(nchw(x)))
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               use_running_average=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def first_match_grad(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The rule by loops: each 3x3/2 window (padding 1) sends its gradient
    to its first maximal element in row-major order."""
    n, h, w, c = x.shape
    dx = np.zeros(x.shape, np.float64)
    for i in range(g.shape[1]):
        for j in range(g.shape[2]):
            rows = [r for r in range(2 * i - 1, 2 * i + 2) if 0 <= r < h]
            cols = [q for q in range(2 * j - 1, 2 * j + 2) if 0 <= q < w]
            for b in range(n):
                for ch in range(c):
                    win = [(r, q) for r in rows for q in cols]
                    vals = [x[b, r, q, ch] for r, q in win]
                    r, q = win[int(np.argmax(vals))]          # first maximum
                    dx[b, r, q, ch] += g[b, i, j, ch]
    return dx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_max_pool_firstmatch_matches_jax(dtype):
    """A post-ReLU input full of exact zeros and repeated values (ties):
    forward equal; backward equal to JAX's and to the first-match rule
    (at most four gradients summed in float32, then one rounding: equal in
    float32 to rtol 1e-6; bf16 after the same rounding)."""
    rng = np.random.default_rng(5)
    x = np.maximum(np.round(rng.normal(size=(2, 9, 8, 5)), 1), 0).astype(np.float32)
    assert (x == 0).mean() > 0.4
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.array(jnp.asarray(x, jdt), np.float32)       # exact in both dtypes
    y, vjp = jax.vjp(jpool, jnp.asarray(x, jdt))
    g = rng.normal(size=y.shape).astype(np.float32)
    g = np.array(jnp.asarray(g, jdt), np.float32)
    (dx,) = vjp(jnp.asarray(g, jdt))

    tx = nchw(x, tdt).requires_grad_()
    ty = max_pool_firstmatch(tx)
    (tdx,) = torch.autograd.grad(ty, tx, nchw(g, tdt))
    assert ty.dtype == tdx.dtype == tdt
    np.testing.assert_array_equal(to_nhwc(ty), np.asarray(y, np.float32))
    np.testing.assert_allclose(to_nhwc(tdx), np.asarray(dx, np.float32), rtol=1e-6, atol=0)
    if dtype == "f32":
        np.testing.assert_allclose(to_nhwc(tdx), first_match_grad(x, g), rtol=1e-6, atol=0)


def assert_model_matches_jax(kw: dict) -> TModel:
    """ContrastiveModel(**kw), ResNet-18 at 32x32 and B = 8, loaded from the
    JAX model's variables with strict=True, against the JAX model: train-mode
    outputs and statistics to 1e-3 of the largest element; each parameter
    gradient of sum(proj * w) to 2e-3 of its norm (fc1.bias, 0 up to
    rounding, to 1e-6 of fc1.weight's largest gradient); eval outputs to
    2e-3. Returns the port's model."""
    side, b = 32, 8
    jm = JModel(resnet_size="18", **kw)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, side, side, 3)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, side, side, 3)).astype(np.float32)
    w = rng.normal(size=(b, 128)).astype(np.float32)

    @jax.jit
    def train(params):
        def loss(p):
            (emb, proj), mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                        x, train=True, mutable=["batch_stats"])
            return jnp.sum(proj * w), (emb, proj, mut["batch_stats"])
        return jax.grad(loss, has_aux=True)(params)

    grads, (emb, proj, stats) = train(variables["params"])
    jeval = jax.jit(partial(jm.apply, train=False))(
        {"params": variables["params"], "batch_stats": stats}, x)
    np_tree = partial(jax.tree.map, np.asarray)
    model = TModel("18", **kw)
    model.load_state_dict(from_flax_variables(np_tree(variables["params"]),
                                              np_tree(variables["batch_stats"])), strict=True)

    def max_rel(got, want):
        want = np.asarray(want, np.float64)
        return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())

    temb, tproj = model.train()(torch.from_numpy(x))
    assert max_rel(temb, emb) < 1e-3 and max_rel(tproj, proj) < 1e-3
    new_stats = from_flax_variables(np_tree(variables["params"]), np_tree(stats))
    sd = model.state_dict()
    for key in new_stats:
        if "running" in key:
            assert max_rel(sd[key], new_stats[key].numpy()) < 1e-3, key
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad((tproj * torch.from_numpy(w)).sum(), list(model.parameters()))
    want = from_flax_variables(np_tree(grads), np_tree(stats))
    fc1_scale = float(want["projection_head.fc1.weight"].abs().max())
    for name, g in zip(names, got):
        g, ref = g.double(), want[name].double()
        if name == "projection_head.fc1.bias":
            assert float((g - ref).abs().max()) <= 1e-6 * fc1_scale
        else:
            assert float((g - ref).norm() / ref.norm()) <= 2e-3, name
    with torch.no_grad():
        eemb, eproj = model.eval()(torch.from_numpy(x))
    assert max_rel(eemb, jeval[0]) < 2e-3 and max_rel(eproj, jeval[1]) < 2e-3
    return model


def test_variant_model_matches_jax():
    """ContrastiveModel(bn_subsample=2, bn_stop_gradient_stats=True,
    maxpool="masked"), statistics from 4 of the 8 images, within
    assert_model_matches_jax's limits (measured: train outputs 1.7e-4,
    statistics 1.2e-4, gradients <= 2e-4 of their norms, eval 4.8e-5)."""
    assert_model_matches_jax(dict(bn_subsample=2, bn_stop_gradient_stats=True,
                                  maxpool="masked"))


@pytest.mark.parametrize("kw", [dict(bn_subsample=0), dict(bn_subsample=-1),
                                dict(bn_subsample=-1, bn_stop_gradient_stats=True)],
                         ids=["0", "-1", "-1-stop_grad"])
def test_subsample_below_one_takes_the_references_branch(kw):
    """The reference's test is bn_subsample > 1 (simhand_tpu/models/
    resnet.py:217): below 1 without stopped gradients it builds exact
    BatchNorm, with them SubsampledBatchNorm over the whole batch. The
    port builds the same modules and matches the JAX model."""
    model = assert_model_matches_jax(kw)
    norms = {type(m) for m in model.encoder.modules() if isinstance(m, BatchNorm2d)}
    assert norms == {SubsampledBatchNorm if kw.get("bn_stop_gradient_stats") else BatchNorm2d}
