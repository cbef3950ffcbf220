"""The port's fused BN+ReLU epilogue (``simhand_tpu_torch.models.bn_epilogue``)
against the JAX package on the CPU.

Kernel level: the plain versions behind the four kernel wrappers against the
Pallas kernels of ``simhand_tpu/models/bn_epilogue.py`` in interpret mode
(as ``tests/test_bn_epilogue.py`` runs them), directly and through the
custom VJPs, in float32 and bf16. Model level: ``ContrastiveModel(
bn_fused="epilogue")`` against the JAX ``bn_fused="epilogue_xla"`` (the same
math without interpret mode), weights carried over by
``simhand_tpu_torch.convert``. Inputs are made from a seed with numpy.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models import bn_epilogue as J
from simhand_tpu.train.optimizer import wd_mask
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models import bn_epilogue as T
from simhand_tpu_torch.models.layers import BatchNorm2d
from simhand_tpu_torch.train.optimizer import decay_mask

torch.set_num_threads(2)
EPS = 1e-5
SHAPES = [(64, 8, 8, 96), (256, 256), (4, 512)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def assert_sums_close(got, want):
    """float32 sums of M terms in another order: rtol 1e-5 of the largest."""
    got, want = f32(got), f32(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def assert_planes_close(got, want, dtype):
    """float32: 1e-5 of the largest element (the same float32 expressions,
    statistics summed in another order). bf16: one bf16 ulp at each
    element's magnitude (a float32 value a few ulps apart may round to the
    neighbouring bf16 value)."""
    got, want = f32(got), f32(want)
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.ldexp(np.float32(1), e - 8)          # bf16 keeps 8 significant bits
    # where the float32 terms cancel to almost 0, their own rounding
    # (measured <= 3e-9 of the largest element) decides the bf16 value
    tol = np.maximum(ulp, 2.0**-20 * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def nchw(a: np.ndarray, dtype) -> torch.Tensor:
    """A numpy (..., C) array as the port's layout: channel on dim 1 with
    channels-last strides (an (M, C) plane stays as it is)."""
    t = torch.from_numpy(a).to(dtype)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def consts(rng, c):
    """Per-channel mu, inv, scale, bias (float32) and the affine constants."""
    mu = rng.normal(size=c).astype(np.float32) * 0.1
    inv = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    A, B, C, D = (np.asarray(v) for v in J._affine_consts(mu, inv, scale, bias))
    return A, B, C, D, scale * inv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_masked_kernels_match_pallas(shape, dtype):
    """masked_dual_reduce and masked_dx on (M, C) planes."""
    rng = np.random.default_rng(0)
    jdt, tdt = DTYPES[dtype]
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32).reshape(-1, c)
    g = rng.normal(size=shape).astype(np.float32).reshape(-1, c)
    A, B, C, D, P = consts(rng, c)
    k1, k2 = (rng.normal(size=c).astype(np.float32) * 0.1 for _ in range(2))
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want_sums = J.masked_dual_reduce(jg, jx, A, B, C, D, interpret=True)
    want_dx = J.masked_dx(jg, jx, A, B, C, D, P, k1, k2, jdt, interpret=True)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    tc = [torch.from_numpy(v) for v in (A, B, C, D, P, k1, k2)]
    got_sums = T.masked_dual_reduce(tg, tx, *tc[:4])
    got_dx = T.masked_dx(tg, tx, *tc)
    for got, want in zip(got_sums, want_sums):
        assert_sums_close(got, want)
    assert got_dx.dtype == tdt
    assert_planes_close(got_dx, want_dx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bn_relu_vjp_matches_pallas(shape, dtype):
    """BNReluTrain (impl="kernel", plain versions on the CPU) against the vjp
    of bn_relu_train(impl="pallas"); the forward output to one bf16 ulp (XLA
    may keep bf16 products in float32 where PyTorch rounds each)."""
    rng = np.random.default_rng(0)
    jdt, tdt = DTYPES[dtype]
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    y, vjp = jax.vjp(lambda x, s, b: J.bn_relu_train(x, s, b, EPS, "pallas"),
                     jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    dx, dscale, dbias = vjp(jnp.asarray(g, jdt))

    tx = nchw(x, tdt).requires_grad_()
    ts, tb = (torch.from_numpy(v).requires_grad_() for v in (scale, bias))
    ty, mu, var = T.BNReluTrain.apply(tx, ts, tb, EPS, "kernel")
    tdx, tds, tdb = torch.autograd.grad(ty, (tx, ts, tb), nchw(g, tdt))
    assert ty.dtype == tdx.dtype == tdt and tds.dtype == tdb.dtype == torch.float32
    assert_planes_close(nhwc(ty), y, dtype)
    assert_planes_close(nhwc(tdx), dx, dtype)
    assert_sums_close(tds, dscale)
    assert_sums_close(tdb, dbias)
    _, jmu, jvar = J._fwd_impl(jnp.asarray(x, jdt), scale, bias, EPS)
    np.testing.assert_allclose(f32(mu), f32(jmu), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f32(var), f32(jvar), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_add_relu_vjp_matches_pallas(dtype):
    """BNAddReluTrain against the vjp of bn_add_relu_train(impl="pallas"),
    at the shape of tests/test_bn_epilogue.py; dres is dy, exact in bf16."""
    rng = np.random.default_rng(1)
    jdt, tdt = DTYPES[dtype]
    shape, c = (32, 4, 4, 128), 128
    x, r, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    y, vjp = jax.vjp(lambda x, r, s, b: J.bn_add_relu_train(x, r, s, b, EPS, "pallas"),
                     jnp.asarray(x, jdt), jnp.asarray(r, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    dx, dr, dscale, dbias = vjp(jnp.asarray(g, jdt))

    tx, tr = (nchw(v, tdt).requires_grad_() for v in (x, r))
    ts, tb = (torch.from_numpy(v).requires_grad_() for v in (scale, bias))
    ty, _, _ = T.BNAddReluTrain.apply(tx, tr, ts, tb, EPS, "kernel")
    tdx, tdr, tds, tdb = torch.autograd.grad(ty, (tx, tr, ts, tb), nchw(g, tdt))
    assert tdx.dtype == tdr.dtype == tdt
    assert_planes_close(nhwc(ty), y, dtype)
    assert_planes_close(nhwc(tdx), dx, dtype)
    assert_planes_close(nhwc(tdr), dr, dtype)
    assert_sums_close(tds, dscale)
    assert_sums_close(tdb, dbias)


# (..., C): M = 231 (no multiple of 8) with a ragged C of 96, a bottleneck's
# bn3 width, and layer4's C = 2,048 over a few rows
RES_SHAPES = [(3, 7, 11, 96), (4, 4, 8, 256), (37, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RES_SHAPES, ids=str)
def test_residual_pair_matches_pallas(shape, dtype):
    """masked_dual_reduce_res, then masked_dx_res on its dres, against the
    reference's _bn_add_relu_bwd(impl="pallas") in interpret mode: the sums
    are (dbias, dscale), dres and dx its two gradients."""
    rng = np.random.default_rng(4)
    jdt, tdt = DTYPES[dtype]
    c = shape[-1]
    x, r, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mu = rng.normal(size=c).astype(np.float32) * 0.1
    inv = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    res = tuple(jnp.asarray(v, jdt) for v in (x, r)) + tuple(
        jnp.asarray(v) for v in (mu, inv, scale, bias))
    dx, dres, dscale, dbias = J._bn_add_relu_bwd(EPS, "pallas", res, jnp.asarray(g, jdt))

    tmu, tinv, tscale, tbias = (torch.from_numpy(v) for v in (mu, inv, scale, bias))
    A, B, C, D = T._affine_consts(tmu, tinv, tscale, tbias)
    tx, tr, tg = (nchw(v, tdt) for v in (x, r, g))
    m = tx.numel() // c
    sum_dy, sum_dyx, tdres = T.masked_dual_reduce_res(tg, tx, tr, A, B, C, D)
    tdx = T.masked_dx_res(tdres, tx, C, D, tscale * tinv, sum_dy / m, sum_dyx / m)
    assert tdres.dtype == tdx.dtype == tdt and tdres.shape == tr.shape
    assert tdres.movedim(1, -1).is_contiguous() and tdx.movedim(1, -1).is_contiguous()
    assert_sums_close(sum_dy, dbias)
    assert_sums_close(sum_dyx, dscale)
    assert_planes_close(nhwc(tdres), dres, dtype)
    assert_planes_close(nhwc(tdx), dx, dtype)


def resnet50_bn_sites(images: int, side: int, downsample: bool = True) -> list:
    """(M, C) of the 53 BatchNorms of ResNet-50 at images x side x side: the
    stem, then bn1, bn2, bn3 of each bottleneck (the stride on its 3x3) and,
    with ``downsample``, the first block's downsample BatchNorm of each
    layer."""
    hw = side // 4                               # after the stem's conv and max pool
    sites = [(images * (side // 2) ** 2, 64)]
    for layer, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512))):
        for block in range(blocks):
            out = hw // 2 if layer > 0 and block == 0 else hw
            m_in, m = images * hw * hw, images * out * out
            sites += [(m_in, width), (m, width), (m, 4 * width)]
            sites += [(m, 4 * width)] if downsample and block == 0 else []
            hw = out
    return sites


def test_persistent_grid_covers_the_rows(monkeypatch):
    """The ring kernels' grid (#5-#9): contiguous row shares that
    cover M exactly, at most two CTAs an SM, each walking at least
    _MIN_CTA_BYTES of a plane; at the 53 BatchNorm sites of the step at
    B = 256 pairs (512 images of 128x128) in both dtypes, and at ragged and
    one-row shapes."""
    monkeypatch.setattr(T, "_sm_count", lambda device: 132)
    sites = resnet50_bn_sites(512, 128)
    assert len(sites) == 53
    for m, c, esize in ([(m, c, e) for m, c in sites for e in (2, 4)]
                        + [(231, 96, 2), (1, 8, 2), (1, 8, 4), (1000, 96, 4)]):
        rows, ctas = T._persistent_grid(m, c, esize, None)
        assert rows * ctas >= m > rows * (ctas - 1)
        assert 1 <= ctas <= 264
        assert ctas == 1 or rows * c * esize >= T._MIN_CTA_BYTES
    assert T._persistent_grid(524288, 256, 2, None) == (1986, 264)
    assert T._persistent_grid(2097152, 64, 2, None) == (7944, 264)
    assert T._persistent_grid(1, 8, 2, None) == (1, 1)


@pytest.mark.parametrize("bn_fused", ["epilogue", "pallas"])
def test_resnet_bn_sites_take_the_ring(bn_fused):
    """Every BatchNorm site whose backward runs a ring kernel (#5-#8 for
    "epilogue", #9 for "pallas") passes ring_fits, the mirror of the CUDA
    source's test: ResNet-50 at two 128x128 images (the projection head's
    train-mode BatchNorm needs more than one) in bf16, forward hooks
    recording each site's C, dtype and planes; for "epilogue", backward
    hooks also record the planes of #6's launch (g as the wrapper hands it
    on, x, and a dx allocated as the wrapper allocates it). The ragged
    1,000 x 96 and a base one element off do not."""
    from simhand_tpu_torch.models.fused_bn import FusedBatchNorm

    cls = T.BNRelu if bn_fused == "epilogue" else FusedBatchNorm
    model = TModel("50", dtype=torch.bfloat16, bn_fused=bn_fused).train()
    seen = []

    def hook(module, args, _out):
        x = args[0]
        planes = [t for t in args if t is not None]
        seen.append((x.numel() // x.shape[1], x.shape[1], x.dtype,
                     T.ring_fits(x.shape[1], x.element_size(), *(t.data_ptr() for t in planes))))

    saved, dx_planes = {}, []

    def keep_x(module, args, _out):
        if len(args) == 1 or args[1] is None:        # #6's sites: no residual
            saved[module] = args[0]

    def dx_hook(module, grad_output):
        # the planes of masked_dx(g, x, ...): the gradient plane the wrapper
        # hands on, x, and its dx
        if module in saved:
            x = saved[module]
            g2d, x2d = T._gradient_plane(grad_output[0], x), T._plane(x, "x")
            dx = torch.empty_like(x2d)
            dx_planes.append(T.ring_fits(x.shape[1], x.element_size(),
                                         *(t.data_ptr() for t in (g2d, x2d, dx))))

    for mod in model.modules():
        if isinstance(mod, cls):
            mod.register_forward_hook(hook)
            if bn_fused == "epilogue":
                mod.register_forward_hook(keep_x)
                mod.register_full_backward_pre_hook(dx_hook)
    x = np.random.default_rng(5).normal(size=(2, 128, 128, 3)).astype(np.float32)
    with torch.set_grad_enabled(bn_fused == "epilogue"):
        out = model(torch.from_numpy(x))
    # "epilogue" keeps the downsample BatchNorms exact
    want = resnet50_bn_sites(2, 128, downsample=bn_fused == "pallas")
    assert len(seen) == {"epilogue": 49, "pallas": 53}[bn_fused]
    assert sorted((m, c) for m, c, _, _ in seen) == sorted(want)
    assert all(dtype == torch.bfloat16 and fits for _, _, dtype, fits in seen)
    if bn_fused == "epilogue":
        sum(o.float().sum() for o in out).backward()
        # #6 at the stem and at bn1/bn2 of the 16 bottlenecks
        assert len(dx_planes) == 33 and all(dx_planes)
    assert T.ring_fits(64, 4, 0, 256) and T.ring_fits(2048, 2, 512)
    assert not T.ring_fits(96, 2, 0)                    # 1,000 x 96: C divides no 2,048
    assert not T.ring_fits(256, 2, 0, 2)                # a bf16 base one element off
    assert not T.ring_fits(256, 4, 4)                   # a float32 base one element off


def test_plain_impl_equals_kernel_impl_on_the_cpu():
    """impl="plain" (bn_fused="epilogue_xla") and impl="kernel" run the same
    plain versions on CPU tensors: equal bit for bit, with a gradient in
    another layout than the saved activation's."""
    rng = np.random.default_rng(2)
    x, r = (nchw(rng.normal(size=(4, 5, 5, 24)).astype(np.float32), torch.bfloat16)
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(4, 24, 5, 5)).astype(np.float32)).bfloat16()
    scale, bias = torch.ones(24, requires_grad=True), torch.zeros(24, requires_grad=True)
    out = []
    for impl in ("kernel", "plain"):
        xx, rr = x.clone().requires_grad_(), r.clone().requires_grad_()
        y, _, _ = T.BNAddReluTrain.apply(xx, rr, scale, bias, EPS, impl)
        out.append([y, *torch.autograd.grad(y, (xx, rr, scale, bias), g)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# model level: ContrastiveModel(bn_fused="epilogue") against "epilogue_xla"
# --------------------------------------------------------------------------

SIDE, B = 32, 4


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def max_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=["18", "50"])
def epilogue(request):
    """The JAX epilogue_xla model's train-mode outputs, new statistics and
    parameter gradients of sum(proj * w), and its eval-mode outputs after
    the statistics update; the port's model loaded from its variables."""
    size = request.param
    jm = JModel(resnet_size=size, bn_fused="epilogue_xla")
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
    model = TModel(size, bn_fused="epilogue")
    model.load_state_dict(init, strict=True)
    return dict(size=size, x=x, w=w, model=model, init=init, emb=emb, proj=proj,
                stats=from_flax_variables(to_numpy(variables["params"]), to_numpy(stats)),
                grads=from_flax_variables(to_numpy(grads), to_numpy(stats)),
                eval=evaluated)


# float32 train-mode tolerances, relative to the largest element, as in
# tests/test_torch_models.py: train-mode BatchNorm at B = 4 and 32x32
# normalises layer4 over 4 values per channel and amplifies the rounding
# differences of XLA's and oneDNN's convolutions layer after layer
# (measured: 5.5e-5 for ResNet-18, 9.9e-3 for ResNet-50, the same as the
# exact BatchNorm's 3e-5 and 8e-3).
TRAIN_RTOL = {"18": 5e-4, "50": 3e-2}
# Each parameter gradient, relative to its norm (measured: 2.6e-4 for
# ResNet-18; 0.234 for ResNet-50, where the exact BatchNorm's gradients
# differ by up to 0.14 in the same comparison: the same amplification, one
# derivative further, through the head's BatchNorm over 4 rows too). All
# gradients together, relative to their norm: measured 1.8e-4 and 0.196.
# The kernel-level tests above hold the backward's arithmetic tightly.
GRAD_RTOL = {"18": 2e-3, "50": 0.5}
GRAD_ALL_RTOL = {"18": 1e-3, "50": 0.4}


def test_epilogue_model_is_built_of_bnrelu(epilogue):
    """Every bn+relu site is a BNRelu (a BatchNorm2d, so the keys are
    torchvision's), downsample BatchNorms stay exact."""
    enc = epilogue["model"].encoder
    fused = [n for n, m in enc.named_modules() if isinstance(m, T.BNRelu)]
    exact = [n for n, m in enc.named_modules() if type(m) is BatchNorm2d]
    assert all(n.endswith("downsample.1") for n in exact)
    assert len(exact) == {"18": 3, "50": 4}[epilogue["size"]]
    n_blocks = {"18": 8, "50": 16}[epilogue["size"]]
    assert len(fused) == 1 + n_blocks * (2 if epilogue["size"] == "18" else 3)
    assert all(m.impl == "kernel" for m in enc.modules() if isinstance(m, T.BNRelu))


def test_epilogue_train_outputs_stats_and_gradients_match(epilogue):
    size, model = epilogue["size"], epilogue["model"].train()
    model.load_state_dict(epilogue["init"], strict=True)
    temb, tproj = model(torch.from_numpy(epilogue["x"]))
    assert max_rel(temb, epilogue["emb"]) < TRAIN_RTOL[size]
    assert max_rel(tproj, epilogue["proj"]) < TRAIN_RTOL[size]
    got = model.state_dict()
    for key, want in epilogue["stats"].items():
        if "running" in key:
            assert max_rel(got[key], want.numpy()) < TRAIN_RTOL[size], key

    names = [n for n, _ in model.named_parameters()]
    loss = (tproj * torch.from_numpy(epilogue["w"])).sum()
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    errs, norms = [], []
    for name in names:
        g, w = grads[name].double(), epilogue["grads"][name].double()
        if name == "projection_head.fc1.bias":
            # feeds a train-mode BatchNorm: its gradient is 0 up to rounding
            # (measured 7.4e-8 of the largest gradient of fc1.weight)
            scale = float(epilogue["grads"]["projection_head.fc1.weight"].abs().max())
            assert float((g - w).abs().max()) <= 1e-6 * scale, name
            continue
        err = float((g - w).norm() / w.norm())
        assert err <= GRAD_RTOL[size], (name, err)
        errs.append(float((g - w).norm()) ** 2)
        norms.append(float(w.norm()) ** 2)
    assert (sum(errs) / sum(norms)) ** 0.5 <= GRAD_ALL_RTOL[size]


def test_epilogue_eval_outputs_match(epilogue):
    """After one train-mode forward updated the statistics of both models:
    a fixed affine map per layer (measured <= 2.1e-4 of the largest output
    for ResNet-50), tolerance as in tests/test_torch_models.py."""
    model = epilogue["model"]
    model.load_state_dict(epilogue["stats"], strict=True)
    with torch.no_grad():
        temb, tproj = model.eval()(torch.from_numpy(epilogue["x"]))
    emb, proj = epilogue["eval"]
    assert max_rel(temb, emb) < 2e-3
    assert max_rel(tproj, proj) < 2e-3


def test_epilogue_decay_mask_matches_wd_mask():
    shapes = jax.eval_shape(JModel(resnet_size="18", bn_fused="epilogue_xla").init,
                            jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    params, batch_stats = (jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes[k])
                           for k in ("params", "batch_stats"))
    mask = jax.tree.map(lambda m, p: np.full(p.shape, float(m)), wd_mask(params), params)
    want = {k: bool(v.flatten()[0]) for k, v in from_flax_variables(mask, batch_stats).items()
            if "running" not in k and "num_batches" not in k}
    model = TModel("18", bn_fused="epilogue")
    assert dict(zip([n for n, _ in model.named_parameters()], decay_mask(model))) == want
    assert want["encoder.layer1.0.bn2.weight"] is False


def test_epilogue_takes_precedence_over_subsample_and_stop_grad():
    """The reference's quirk (resnet.py:173): bn_fused="epilogue" ignores
    bn_subsample and bn_stop_gradient_stats; downsample BatchNorms stay
    exact, not subsampled."""
    torch.manual_seed(0)
    plain = TModel("18", bn_fused="epilogue")
    quirk = TModel("18", bn_fused="epilogue", bn_subsample=2, bn_stop_gradient_stats=True)
    quirk.load_state_dict(plain.state_dict(), strict=True)
    assert [type(m) for m in plain.modules()] == [type(m) for m in quirk.modules()]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, SIDE, SIDE, 3)).astype(np.float32))
    outs = []
    for model in (plain, quirk):
        _, proj = model.train()(x)
        outs.append([proj, *torch.autograd.grad(proj.square().sum(), list(model.parameters()))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_bn_fused_values():
    from simhand_tpu_torch.models.fused_bn import FusedBatchNorm

    # "xla" builds what True builds, as the reference's bn_fused="xla" does
    for value, impl in (("pallas", "kernel"), (True, "plain"), ("xla", "plain")):
        sites = [m for m in TModel("18", bn_fused=value).encoder.modules()
                 if isinstance(m, BatchNorm2d)]
        assert len(sites) == 20
        assert all(isinstance(m, FusedBatchNorm) and m.reduce_impl == impl for m in sites)
    for bad in ("epilogue_pallas", None):
        with pytest.raises(ValueError, match="bn_fused"):
            TModel("18", bn_fused=bad)
    with pytest.raises(ValueError, match="maxpool"):
        TModel("18", maxpool="max")
    fused = [m for m in TModel("18", bn_fused="epilogue_xla").modules()
             if isinstance(m, T.BNRelu)]
    assert len(fused) == 17 and all(m.impl == "plain" for m in fused)
