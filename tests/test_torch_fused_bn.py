"""The port's BatchNorm with the hand-derived backward
(``simhand_tpu_torch.models.fused_bn``) against the JAX package on the CPU.

Kernel level: the plain version behind ``bn_backward_reduces`` against the
Pallas kernel of ``simhand_tpu/models/fused_bn.py`` in interpret mode, in
float32 and bf16. Module level: ``FusedBatchNorm`` against the JAX
``FusedBatchNorm`` (reduce_impl "xla"/"pallas", with and without stopped
statistics' gradients). Model level: ``ContrastiveModel(bn_fused="pallas")``
against the JAX ``bn_fused=True`` (the same math without interpret mode),
and ``bn_fused="xla"`` against the JAX ``bn_fused="xla"`` (the plain
reduces on both sides), weights carried over by ``simhand_tpu_torch.convert``. Inputs are made from
a seed with numpy.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bn_epilogue import (
    DTYPES,
    EPS,
    GRAD_ALL_RTOL,
    GRAD_RTOL,
    TRAIN_RTOL,
    assert_planes_close,
    assert_sums_close,
    f32,
    max_rel,
    nchw,
    nhwc,
    to_numpy,
)

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models import fused_bn as J
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models import fused_bn as T
from simhand_tpu_torch.models.layers import BatchNorm2d

torch.set_num_threads(2)
# an odd M (999 rows, one Pallas block), a ragged C, and a wide one
SHAPES = [(64, 8, 8, 96), (999, 40), (4, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bn_backward_reduces_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = DTYPES[dtype]
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32).reshape(-1, c)
    dy = rng.normal(size=shape).astype(np.float32).reshape(-1, c)
    mu = (rng.normal(size=c) * 0.1).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    want = J.bn_backward_reduces(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), mu, inv,
                                 interpret=True)
    got = T.bn_backward_reduces(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                                torch.from_numpy(mu), torch.from_numpy(inv))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_sums_close(g, w)


REDUCE_IMPLS = {"pallas": "kernel", "xla": "plain"}


@pytest.mark.parametrize("stop_grad", [False, True], ids=["stats-grad", "stop-grad"])
@pytest.mark.parametrize("reduce_impl", REDUCE_IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_batchnorm_matches_jax(dtype, reduce_impl, stop_grad):
    """Train-mode output, new running statistics and the vjp (dx, dscale,
    dbias), then eval mode with the new statistics. Planes to one bf16 ulp
    or 1e-5 of the largest float32 element, sums to 1e-5 of the largest
    (test_torch_bn_epilogue's tolerances: the same float32 expressions,
    statistics summed in another order); running statistics to 1e-6."""
    rng = np.random.default_rng(1)
    jdt, tdt = DTYPES[dtype]
    shape, c = (8, 6, 6, 24), 24
    x, g = (rng.normal(size=shape).astype(np.float32) * 2 + 0.5 for _ in range(2))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    mean0 = (rng.normal(size=c) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)

    jm = J.FusedBatchNorm(momentum=0.9, epsilon=EPS, dtype=jdt, reduce_impl=reduce_impl,
                          stop_gradient_stats=stop_grad)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def apply(x, s, b):
        return jm.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, x,
                        mutable=["batch_stats"])

    y, vjp, new = jax.vjp(apply, jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                          has_aux=True)
    dx, dscale, dbias = vjp(jnp.asarray(g, jdt))
    y_eval = J.FusedBatchNorm(use_running_average=True, epsilon=EPS, dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": new["batch_stats"]},
        jnp.asarray(x, jdt))

    bn = T.FusedBatchNorm(c, eps=EPS, stop_gradient_stats=stop_grad,
                          reduce_impl=REDUCE_IMPLS[reduce_impl])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tx = nchw(x, tdt).requires_grad_()
    ty = bn.train()(tx)
    tdx, tds, tdb = torch.autograd.grad(ty, (tx, bn.weight, bn.bias), nchw(g, tdt))
    assert ty.dtype == tdx.dtype == tdt and tds.dtype == tdb.dtype == torch.float32
    assert tdx.is_contiguous(memory_format=torch.channels_last)
    assert_planes_close(nhwc(ty), y, dtype)
    assert_planes_close(nhwc(tdx), dx, dtype)
    assert_sums_close(tds, dscale)
    assert_sums_close(tdb, dbias)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(f32(getattr(bn, name)), f32(new["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert_planes_close(nhwc(bn.eval()(nchw(x, tdt))), y_eval, dtype)


# --------------------------------------------------------------------------
# model level: ContrastiveModel(bn_fused="pallas") against JAX bn_fused=True,
# and bn_fused="xla" on both sides
# --------------------------------------------------------------------------

SIDE, B = 32, 4
# (ResNet size, the JAX model's bn_fused, the port's) by fixture id
FUSED_MODELS = {"18": ("18", True, "pallas"), "50": ("50", True, "pallas"),
                "18-xla": ("18", "xla", "xla")}


@pytest.fixture(scope="module", params=list(FUSED_MODELS))
def fused(request):
    """The JAX fused model's train-mode outputs, new statistics and
    parameter gradients of sum(proj * w), and its eval-mode outputs after
    the statistics update; the port's fused model loaded from its variables
    with strict=True."""
    size, jax_fused, bn_fused = FUSED_MODELS[request.param]
    jm = JModel(resnet_size=size, bn_fused=jax_fused)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
    w = rng.normal(size=(B, 128)).astype(np.float32)

    @jax.jit
    def train(params):
        def loss(p):
            (emb, proj), mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                        x, train=True, mutable=["batch_stats"])
            return jnp.sum(proj * w), (emb, proj, mut["batch_stats"])
        return jax.grad(loss, has_aux=True)(params)

    grads, (emb, proj, stats) = train(variables["params"])
    evaluated = jax.jit(partial(jm.apply, train=False))(
        {"params": variables["params"], "batch_stats": stats}, x)
    init = from_flax_variables(to_numpy(variables["params"]), to_numpy(variables["batch_stats"]))
    model = TModel(size, bn_fused=bn_fused)
    model.load_state_dict(init, strict=True)
    return dict(size=size, bn_fused=bn_fused, x=x, w=w, model=model, init=init, emb=emb, proj=proj,
                stats=from_flax_variables(to_numpy(variables["params"]), to_numpy(stats)),
                grads=from_flax_variables(to_numpy(grads), to_numpy(stats)),
                eval=evaluated)


def test_fused_model_is_built_of_fused_batchnorms(fused):
    """Every encoder BatchNorm is a FusedBatchNorm (a BatchNorm2d, so the keys
    are torchvision's and the JAX variables load with strict=True), the
    downsample ones too; the projection head's stays exact."""
    model = fused["model"]
    sites = [n for n, m in model.encoder.named_modules() if isinstance(m, T.FusedBatchNorm)]
    assert len(sites) == {"18": 20, "50": 53}[fused["size"]]
    assert sum(n.endswith("downsample.1") for n in sites) == {"18": 3, "50": 4}[fused["size"]]
    impl = "kernel" if fused["bn_fused"] == "pallas" else "plain"
    assert all(m.reduce_impl == impl and not m.stop_gradient_stats
               for m in model.modules() if isinstance(m, T.FusedBatchNorm))
    assert not any(isinstance(m, T.FusedBatchNorm) for m in model.projection_head.modules())
    assert sorted(model.state_dict()) == sorted(fused["init"])


def test_fused_train_outputs_stats_and_gradients_match(fused):
    """Tolerances of test_torch_bn_epilogue.py (TRAIN_RTOL, GRAD_RTOL,
    GRAD_ALL_RTOL), for the same reason: train-mode BatchNorm at B = 4 and
    32x32 amplifies the float32 rounding differences of XLA's and oneDNN's
    convolutions layer after layer."""
    size, model = fused["size"], fused["model"].train()
    model.load_state_dict(fused["init"], strict=True)
    temb, tproj = model(torch.from_numpy(fused["x"]))
    assert max_rel(temb, fused["emb"]) < TRAIN_RTOL[size]
    assert max_rel(tproj, fused["proj"]) < TRAIN_RTOL[size]
    got = model.state_dict()
    for key, want in fused["stats"].items():
        if "running" in key:
            assert max_rel(got[key], want.numpy()) < TRAIN_RTOL[size], key

    names = [n for n, _ in model.named_parameters()]
    loss = (tproj * torch.from_numpy(fused["w"])).sum()
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    errs, norms = [], []
    for name in names:
        g, w = grads[name].double(), fused["grads"][name].double()
        if name == "projection_head.fc1.bias":
            # feeds a train-mode BatchNorm: its gradient is 0 up to rounding
            scale = float(fused["grads"]["projection_head.fc1.weight"].abs().max())
            assert float((g - w).abs().max()) <= 1e-6 * scale, name
            continue
        err = float((g - w).norm() / w.norm())
        assert err <= GRAD_RTOL[size], (name, err)
        errs.append(float((g - w).norm()) ** 2)
        norms.append(float(w.norm()) ** 2)
    assert (sum(errs) / sum(norms)) ** 0.5 <= GRAD_ALL_RTOL[size]


def test_fused_eval_outputs_match(fused):
    """After one train-mode forward updated the statistics of both models:
    a fixed affine map per layer, tolerance as in test_torch_bn_epilogue.py."""
    model = fused["model"]
    model.load_state_dict(fused["stats"], strict=True)
    with torch.no_grad():
        temb, tproj = model.eval()(torch.from_numpy(fused["x"]))
    emb, proj = fused["eval"]
    assert max_rel(temb, emb) < 2e-3
    assert max_rel(tproj, proj) < 2e-3


def test_fused_model_loads_jax_pallas_variables_strictly():
    """The JAX ContrastiveModel(bn_fused="pallas"), initialised in train mode
    (FusedBatchNorm declares nn.BatchNorm's leaves), loads into the port's
    with strict=True."""
    shapes = jax.eval_shape(lambda k, x: JModel(resnet_size="50", bn_fused="pallas")
                            .init(k, x, train=True),
                            jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    params, batch_stats = (jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes[k])
                           for k in ("params", "batch_stats"))
    model = TModel("50", bn_fused="pallas")
    model.load_state_dict(from_flax_variables(params, batch_stats), strict=True)


def test_fused_ignores_subsample_and_passes_stop_grad_on():
    """The reference's precedence (resnet.py:203-216 before :217): with
    bn_fused, bn_subsample is ignored and bn_stop_gradient_stats reaches every
    FusedBatchNorm; bn_fused=True takes the plain reduces."""
    torch.manual_seed(0)
    plain = TModel("18", bn_fused="pallas", bn_stop_gradient_stats=True)
    quirk = TModel("18", bn_fused="pallas", bn_subsample=2, bn_stop_gradient_stats=True)
    quirk.load_state_dict(plain.state_dict(), strict=True)
    assert [type(m) for m in plain.modules()] == [type(m) for m in quirk.modules()]
    assert all(m.stop_gradient_stats for m in quirk.modules() if isinstance(m, T.FusedBatchNorm))
    assert all(m.reduce_impl == "plain" for m in TModel("18", bn_fused=True).modules()
               if isinstance(m, T.FusedBatchNorm))
    assert not any(isinstance(m, T.FusedBatchNorm) for m in TModel("18").modules())
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, SIDE, SIDE, 3)).astype(np.float32))
    outs = []
    for model in (plain, quirk):
        _, proj = model.train()(x)
        outs.append([proj, *torch.autograd.grad(proj.square().sum(), list(model.parameters()))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert type(TModel("18", bn_subsample=2).encoder.bn1) is not BatchNorm2d
