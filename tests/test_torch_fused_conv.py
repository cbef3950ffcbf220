"""The port's 1x1 convolution with statistics (``simhand_tpu_torch.ops.conv1x1``)
and fused conv1x1+BN site (``simhand_tpu_torch.models.fused_conv``) against
the JAX package on the CPU.

Kernel level: the plain versions behind ``conv1x1_stats`` and
``conv1x1_bn_relu_stats`` against the Pallas kernels of
``simhand_tpu/ops/conv1x1.py`` in interpret mode (as ``tests/test_conv1x1.py``
runs them). Site level: ``conv1x1_bn_train`` against the JAX custom VJP.
Model level: a ResNet with every bottleneck 1x1 site fused
(``conv1x1_fuse_min_cin=1``) against the JAX model of the same configuration,
and the site count of ResNet-50. The port's weight is (Cout, Cin), the
reference's (Cin, Cout): the tests transpose. Inputs are made from a seed
with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bn_epilogue import DTYPES, f32, max_rel, to_numpy

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.fused_conv import conv1x1_bn_train as jfused
from simhand_tpu.models.resnet import Bottleneck as JBottleneck
from simhand_tpu.models.resnet import ResNet as JResNet
from simhand_tpu.ops import conv1x1 as J
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models import resnet as R
from simhand_tpu_torch.models.fused_conv import conv1x1_bn_train as tfused
from simhand_tpu_torch.ops import conv1x1 as T

torch.set_num_threads(2)
EPS = 1e-5


def assert_y_close(got, want, x2d, w, dtype):
    """float32: 1e-5 of the largest element (the same products summed in
    another order). bf16: one bf16 ulp at the larger magnitude, plus 2^-16 *
    sum_k |x||w|, an allowance for the float32 sums' different order (of the
    order of K * 2^-24 * |y|, it only matters where y is near 0)."""
    a, b = torch.tensor(f32(got)), torch.tensor(f32(want))
    if dtype == "f32":
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        return
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    floor = 2.0**-16 * (torch.tensor(f32(x2d)).abs() @ torch.tensor(f32(w)).abs())
    assert ((a - b).abs() <= ulp + floor).all(), float((a - b).abs().max())


def assert_stats(y, s1, s2, want_s1, want_s2):
    """s1, s2 against the float64 column sums of the port's own y to rel 1e-5
    of the largest (float32 sums in another order), and against the
    reference's to rel 1e-3 (a y element that rounds to the other bf16
    neighbour moves them; float32: 1e-5)."""
    y64 = torch.tensor(f32(y)).double()
    for got, own, want in ((s1, y64.sum(0), want_s1), (s2, (y64 * y64).sum(0), want_s2)):
        got64 = got.double()
        assert float((got64 - own).abs().max()) <= 1e-5 * float(own.abs().max())
        tol = 1e-5 if y.dtype == torch.float32 else 1e-3
        want = torch.tensor(f32(want)).double()
        assert float((got64 - want).abs().max()) <= tol * float(want.abs().max())


# the shapes of tests/test_fused_conv.py and tests/test_conv1x1.py, and the
# ragged ones of the kernels' card tests (tests/test_torch_gpu_kernels.py)
CONV_CASES = {"f32": ("f32", (64, 16, 8)), "bf16": ("bf16", (1024, 64, 32)),
              "bf16-1000x96-40": ("bf16", (1000, 96, 40)), "bf16-72x8-8": ("bf16", (72, 8, 8))}


@pytest.mark.parametrize("affine", [False, True], ids=["stats", "bn_relu_stats"])
@pytest.mark.parametrize("dtype,shape", CONV_CASES.values(), ids=CONV_CASES)
def test_conv1x1_plain_versions_match_pallas(dtype, shape, affine):
    rng = np.random.default_rng(0)
    jdt, tdt = DTYPES[dtype]
    m, cin, cout = shape
    x = rng.normal(size=(m, cin)).astype(np.float32)
    w = (rng.normal(size=(cin, cout)) * 0.1).astype(np.float32)
    A = (rng.normal(size=cin) * 0.3 + 1).astype(np.float32)
    B = (rng.normal(size=cin) * 0.1).astype(np.float32)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()).to(tdt)
    if affine:
        want = J.conv1x1_bn_relu_stats(jx, jw, A, B, interpret=True)
        got = T.conv1x1_bn_relu_stats(tx, tw, torch.from_numpy(A), torch.from_numpy(B))
        xin = torch.relu(tx.float() * torch.from_numpy(A) + torch.from_numpy(B)).to(tdt)
    else:
        want = J.conv1x1_stats(jx, jw, interpret=True)
        got = T.conv1x1_stats(tx, tw)
        xin = tx
    y, s1, s2 = got
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    assert_y_close(y, want[0], xin, w, dtype)
    assert_stats(y, s1, s2, want[1], want[2])


def test_conv1x1_bn_train_matches_jax():
    """o, mu, var, and the gradients of every input through a ReLU as in the
    bottleneck, at tests/test_fused_conv.py's shapes and tolerances (o to
    2e-5, mu and var to 1e-5 with atol 1e-6, gradients to 5e-4 with atol
    5e-5); float32."""
    rng = np.random.default_rng(1)
    for m, cin, cout in ((64, 16, 8), (48, 12, 8)):
        x = rng.normal(size=(m, cin)).astype(np.float32)
        w = (rng.normal(size=(cin, cout)) * 0.2).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
        r = rng.normal(size=(m, cout)).astype(np.float32)

        def jloss(x, w, s, b):
            o, mu, var = jfused(x, w, s, b, EPS)
            return jnp.sum(jax.nn.relu(o) * r), (o, mu, var)

        jgrads, (o, mu, var) = jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            x, w, scale, bias)
        tx, tw, ts, tb = (torch.from_numpy(v).requires_grad_()
                          for v in (x, w.T.copy(), scale, bias))
        to, tmu, tvar = tfused(tx, tw, ts, tb, EPS)
        tgrads = torch.autograd.grad((torch.relu(to) * torch.from_numpy(r)).sum(),
                                     (tx, tw, ts, tb))
        np.testing.assert_allclose(f32(to), f32(o), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(f32(tmu), f32(mu), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f32(tvar), f32(var), rtol=1e-5, atol=1e-6)
        for name, g, want in zip(("dx", "dw", "dscale", "dbias"), tgrads, jgrads):
            g = g.T if name == "dw" else g
            np.testing.assert_allclose(f32(g), f32(want), rtol=5e-4, atol=5e-5, err_msg=name)


# --------------------------------------------------------------------------
# model level
# --------------------------------------------------------------------------

SIDE = 32


def tiny_resnet(fuse: int, **kw):
    return R.ResNet((1, 1, 1, 1), R.Bottleneck, conv1x1_fuse_min_cin=fuse, **kw)


def test_fused_resnet_matches_jax():
    """ResNet((1, 1, 1, 1), Bottleneck, conv1x1_fuse_min_cin=1) in float32,
    every bottleneck conv1/conv3 fused in both packages (the JAX one in
    interpret mode): the train-mode output and new statistics to 5e-4 of
    their largest element, each gradient of mean(out^2) to 5e-3 of its norm
    (float32 convolutions of XLA and oneDNN round differently and train-mode
    BatchNorm at B = 4 amplifies it; measured 7.9e-5, 3.6e-6 and 7.2e-5).
    In eval mode the site is the plain conv and BatchNorm: the port's output
    equals the unfused model's bit for bit."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, SIDE, SIDE, 3)).astype(np.float32)
    jm = JResNet(stage_sizes=(1, 1, 1, 1), block=JBottleneck, conv1x1_fuse_min_cin=1)
    variables = jax.jit(JResNet(stage_sizes=(1, 1, 1, 1), block=JBottleneck).init)(
        jax.random.key(0), jnp.asarray(x))

    @jax.jit
    def train(params):
        def loss(p):
            out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.square(out)), (out, mut["batch_stats"])
        return jax.grad(loss, has_aux=True)(params)

    grads, (out, stats) = train(variables["params"])
    init = from_flax_variables(to_numpy(variables["params"]), to_numpy(variables["batch_stats"]))
    want_stats = from_flax_variables(to_numpy(variables["params"]), to_numpy(stats))
    want_grads = from_flax_variables(to_numpy(grads), to_numpy(stats))

    model = tiny_resnet(1)
    model.load_state_dict(init, strict=True)
    tx = torch.from_numpy(x)
    tout = model.train()(tx)
    assert max_rel(tout, out) < 5e-4
    got = model.state_dict()
    for key, want in want_stats.items():
        if "running" in key:
            assert max_rel(got[key], want.numpy()) < 5e-4, key
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(tout.square().mean(), list(model.parameters()))):
        w = want_grads[name].double()
        assert float((g.double() - w).norm() / w.norm()) < 5e-3, name
    plain = tiny_resnet(0)
    plain.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(model.eval()(tx), plain.eval()(tx))


@pytest.mark.parametrize("variant", [dict(bn_fused=True), dict(bn_fused="pallas"),
                                     dict(bn_fused="epilogue"), dict(bn_subsample=2),
                                     dict(bn_stop_gradient_stats=True)], ids=str)
def test_fuse_refuses_the_other_batchnorm_variants_in_train_mode(variant):
    """As the reference raises (resnet.py:262-269): only in train mode, where
    the fused site would own the BatchNorm."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, SIDE, SIDE, 3)).astype(np.float32))
    model = tiny_resnet(1, **variant)
    with pytest.raises(NotImplementedError, match="conv1x1_fuse_min_cin"):
        model.train()(x)
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x)).all()


def test_fused_model_loads_jax_variables_strictly():
    """The JAX ContrastiveModel(conv1x1_fuse_min_cin=512), initialised in
    train mode (Conv1x1Kernel and BNParams declare nn.Conv's and
    nn.BatchNorm's leaves), loads into the port's with strict=True."""
    shapes = jax.eval_shape(lambda k, x: JModel(resnet_size="50", conv1x1_fuse_min_cin=512)
                            .init(k, x, train=True),
                            jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    params, batch_stats = (jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes[k])
                           for k in ("params", "batch_stats"))
    model = TModel("50", conv1x1_fuse_min_cin=512)
    model.load_state_dict(from_flax_variables(params, batch_stats), strict=True)


def test_fused_site_count_per_threshold(monkeypatch):
    """ResNet-50 in train mode fuses the bottleneck conv1/conv3 sites with at
    least the threshold's input channels: 15 at 512 (the step's), all 32 at
    1, 2 at 2048; none in eval mode."""
    sites = []
    fused_site = R.fused_conv_bn_site

    def spy(conv, bn, x):
        sites.append((x.shape[0] * x.shape[2] * x.shape[3], x.shape[1], conv.out_channels))
        return fused_site(conv, bn, x)

    monkeypatch.setattr(R, "fused_conv_bn_site", spy)
    x = torch.zeros(2, SIDE, SIDE, 3)
    for threshold, count in ((512, 15), (1, 32), (2048, 2)):
        sites.clear()
        encoder = R.resnet50(conv1x1_fuse_min_cin=threshold)
        with torch.no_grad():
            encoder.train()(x)
        assert len(sites) == count and all(cin >= threshold for _, cin, _ in sites)
        sites.clear()
        with torch.no_grad():
            encoder.eval()(x)
        assert not sites


def test_kernel_checks_take_float32_and_refuse_float16():
    """The wrapper's checks before a launch (here on CPU tensors): bf16 and
    float32 pass (the float32 kernels keep y in x's dtype, as the reference
    does), float16 and mixed dtypes raise."""
    x2d, w = torch.zeros(64, 32), torch.zeros(16, 32)
    A, B = torch.ones(32), torch.zeros(32)
    for dt in (torch.float32, torch.bfloat16):
        T._check(x2d.to(dt), w.to(dt), dict(A=A, B=B))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        T._check(x2d.half(), w.half(), {})
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        T._check(x2d, w.bfloat16(), {})
