"""The port's NT-Xent kernels (``simhand_tpu_torch/losses/ntxent_kernels.py``)
against the JAX package's Pallas kernels, run as their own tests run them
on the CPU (``interpret=True``).

On the CPU the wrappers take their kernels' plain versions; the CUDA
kernels themselves run only on the card (``tests/test_torch_gpu_kernels.py``
and ``chip_smoke.py``). Inputs are made from a seed with numpy.
"""
import math

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
@pytest.mark.parametrize("etype", ["simclr", "simhand_w", "peclr", "simhand-base"])
def test_contrastive_loss_from_projections_matches(etype, use_pallas):
    """Both routes of the dispatch: B = 256 passes the 2B % 512 gate when
    use_pallas is on, so both packages take their kernel route (the plain
    family's: nt_xent_pallas in JAX, #1's and #3's plain versions here)."""
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


# --------------------------------------------------------------------------
# the grid of the tensor-core kernels #1-#4 and their three-pass TF32 products
# --------------------------------------------------------------------------

# (M, N) and the splits at them by the kernel's tile width, as the note of
# csrc/ntxent.cu states them for an H100's 132 SMs; the partial plane holds
# splits x M floats for #1/#2, splits x M x 128 for #3/#4, and is not used
# with one split
GRAD_GRIDS = [(512, 512), (512, 16384), (16384, 16384)]
SPLITS = {32: (16, 16, 1), 64: (8, 16, 1)}
PARTIAL_FLOATS_A_ROW = {"ntxent_denominator": 1, "weighted_ntxent_denominator": 1,
                        "ntxent_grad": K.D, "weighted_grad_rows": K.D}
PARTIAL_BYTES = {("ntxent_denominator", 512, 512): 16 * 2**10,
                 ("ntxent_denominator", 512, 16384): 32 * 2**10,
                 **{("weighted_ntxent_denominator", 512, n): 32 * 2**10 for n in (512, 16384)},
                 **{(name, 512, n): 4 * 2**20 for name in ("ntxent_grad", "weighted_grad_rows")
                    for n in (512, 16384)}}


@pytest.mark.parametrize("name", list(PARTIAL_FLOATS_A_ROW))
@pytest.mark.parametrize("m,n", GRAD_GRIDS, ids=["512x512", "512x16384", "16384x16384"])
def test_weighted_grad_grid_covers_every_column_tile_once(monkeypatch, m, n, name):
    """The planner of #1-#4 (one CTA an SM), at each kernel's tile width:
    64 columns for #1, 32 for #2-#4."""
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    tile = K._TILE[name]
    got, cols = K._tensor_core_grid(m, n, None, tile)
    partial_bytes = got * m * PARTIAL_FLOATS_A_ROW[name] * 4 if got > 1 else 0
    splits = SPLITS[tile][GRAD_GRIDS.index((m, n))]
    assert (got, partial_bytes) == (splits, PARTIAL_BYTES.get((name, m, n), 0))
    assert cols % tile == 0
    # split s takes the columns [s * cols, (s + 1) * cols) of N
    tiles = [t for s in range(got)
             for t in range(s * cols // tile, math.ceil(min(n, (s + 1) * cols) / tile))]
    assert sorted(tiles) == list(range(math.ceil(n / tile)))  # each tile exactly once
    assert (got - 1) * cols < n                                 # no split is empty
    assert got * math.ceil(m / K._GBM) <= 132 or got == 1       # one wave where split


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest, ties
    away from 0, through the bit pattern: the kernel's tf32_rna."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in float32 with the operands' TF32 splits: three passes (lo*hi,
    hi*lo, hi*hi) as the kernel's wgmma runs them, or hi*hi alone."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def weighted_grad_tf32(zr, zc, jr, jc, inv_r, inv_c, ids, d_max, d_min, passes):
    """weighted_grad_rows_plain with both products through tf32_matmul."""
    w = K._weights_plain(jr, jc, d_max, d_min)
    g = torch.exp(tf32_matmul(zr, zc.T, passes) * w / T) * w * (inv_r[:, None] + inv_c[None, :])
    g = torch.where(K._self_mask(ids, zc.shape[0]), 0.0, g)
    return tf32_matmul(g, zc, passes)


def weighted_denominator_tf32(zr, zc, jr, jc, inv_r, inv_c, ids, d_max, d_min, passes):
    """weighted_ntxent_denominator_plain with its product through tf32_matmul."""
    w = K._weights_plain(jr, jc, d_max, d_min)
    s = torch.exp(tf32_matmul(zr, zc.T, passes) * w / T)
    return torch.where(K._self_mask(ids, zc.shape[0]), 0.0, s).sum(dim=1)


def plain_denominator_tf32(zr, zc, jr, jc, inv_r, inv_c, ids, d_max, d_min, passes):
    """ntxent_denominator_plain with its product through tf32_matmul."""
    s = torch.exp(tf32_matmul(zr, zc.T, passes) / T)
    return torch.where(K._self_mask(ids, zc.shape[0]), 0.0, s).sum(dim=1)


def plain_grad_tf32(zr, zc, jr, jc, inv_r, inv_c, ids, d_max, d_min, passes):
    """ntxent_grad_plain with both products through tf32_matmul."""
    g = torch.exp(tf32_matmul(zr, zc.T, passes) / T) * (inv_r[:, None] + inv_c[None, :])
    g = torch.where(K._self_mask(ids, zc.shape[0]), 0.0, g)
    return tf32_matmul(g, zc, passes)


TF32_CASES = {
    "weighted_grad_rows": (weighted_grad_tf32, ("z_rows", "z_cols", "j_rows", "j_cols",
                                                "inv_rows", "inv_cols", "row_ids", "d_max",
                                                "d_min")),
    "weighted_ntxent_denominator": (weighted_denominator_tf32,
                                    ("z_rows", "z_cols", "j_rows", "j_cols", "row_ids",
                                     "d_max", "d_min")),
    "ntxent_grad": (plain_grad_tf32, ("z_rows", "z_cols", "inv_rows", "inv_cols", "row_ids")),
    "ntxent_denominator": (plain_denominator_tf32, ("z_rows", "z_cols", "row_ids")),
}
DENOMINATORS = ("ntxent_denominator", "weighted_ntxent_denominator")


@pytest.mark.parametrize("name", list(TF32_CASES))
def test_three_tf32_passes_keep_the_gradient_within_its_limit(name):
    """The kernels' products, emulated: three TF32 passes stay within the
    card's limit of the float64 function at 512 rows against 2,048 columns,
    one pass does not. The limits: 1e-5 of max|G| for the gradients #3 and
    #4, rel 1e-5 for the denominators #1 and #2. A denominator sums positive terms,
    so one pass's rounding of c averages out over the columns unless the
    rows' own rounding errors do not: the projections here share a
    direction, as an encoder's often do."""
    rng = np.random.default_rng(3)
    n, m = 2048, 512
    z = rng.normal(size=(n, 128))
    if name in DENOMINATORS:
        z = z + 2.0 * rng.normal(size=(1, 128))
    zc = torch.from_numpy(normalize(z))
    jc = torch.from_numpy(rng.uniform(0, 128, (n, 21, 2)).astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    d = torch.cdist(jc.double().permute(1, 0, 2), jc.double().permute(1, 0, 2)).mean(0)
    d_max, d_min = d.max().float(), d.min().float()
    inv = (1.0 / K.ntxent_denominator_plain(zc.double(), zc.double(), ids, T)).float()
    args = (zc[:m], zc, jc[:m], jc, inv[:m], inv, ids[:m], d_max, d_min)
    names = ("z_rows", "z_cols", "j_rows", "j_cols", "inv_rows", "inv_cols", "row_ids",
             "d_max", "d_min")
    emulate, keys = TF32_CASES[name]
    want = getattr(K, f"{name}_plain")(*(a.double() if a.is_floating_point() else a
                                          for k, a in zip(names, args) if k in keys), T)
    got = {p: emulate(*args, p).double() for p in (3, 1)}
    if name in DENOMINATORS:
        limit, errs = 1e-5, {p: float(((g - want) / want).abs().max()) for p, g in got.items()}
    else:
        limit = 1e-5 * float(want.abs().max())
        errs = {p: float((g - want).abs().max()) for p, g in got.items()}
    assert errs[3] <= limit < errs[1], (errs, limit)
