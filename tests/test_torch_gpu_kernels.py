"""The CUDA kernels on the card (the NT-Xent kernels of ``csrc/ntxent.cu``,
the BatchNorm backward reduces of ``csrc/bn_epilogue.cu``, the 1x1
convolution with statistics of ``csrc/conv1x1.cu``, and the convolution with
a bias / residual / ReLU epilogue of ``csrc/conv_bias.cu`` with the whole
bottleneck block built on it), against their plain PyTorch versions; and
the input path on the card (the augmentation against the CPU on the same
draws, the prefetched batches against the host's); and similar-hand mining
on the card against the CPU, bit for bit.

These tests need a CUDA card and ``nvcc``; without them they skip. They
import no JAX, so they run where the card is, without the repository's
``conftest.py`` (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_kernels.py

The NT-Xent kernels run in float32 with TF32 off. Denominators are held to
rtol 1e-5 (a sum of N positive terms in another order); gradients to 1e-5
of their largest element (a sum of N vectors of both signs). The BN
kernels run in float32 and bf16; each test states its tolerance.
"""
import pytest
import torch

from simhand_tpu_torch.losses import contrastive as dense
from simhand_tpu_torch.losses import ntxent_kernels as K
from simhand_tpu_torch.losses.weights import linear_weights, pairwise_minmax

torch.set_num_threads(2)
T = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, m, n, offset):
    z_cols = torch.randn(n, 128, device="cuda", generator=gen)
    z_cols = z_cols / z_cols.norm(dim=1, keepdim=True)
    j_cols = torch.rand(n, 21, 2, device="cuda", generator=gen) * 128
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    inv_cols = 1.0 / K.ntxent_denominator_plain(z_cols, z_cols, ids, T)
    d_min, d_max = pairwise_minmax(j_cols, "mpjpe")
    rows = slice(offset, offset + m)
    return {
        "ntxent_denominator": (z_cols[rows], z_cols, ids[rows]),
        "weighted_ntxent_denominator": (z_cols[rows], z_cols, j_cols[rows], j_cols,
                                        ids[rows], d_max, d_min),
        "ntxent_grad": (z_cols[rows], z_cols, inv_cols[rows], inv_cols, ids[rows]),
        "weighted_grad_rows": (z_cols[rows], z_cols, j_cols[rows], j_cols, inv_cols[rows],
                               inv_cols, ids[rows], d_max, d_min),
    }


# (M, N, row offset): the training step's shape, and ragged shapes that end
# inside a tile (every row and column edge is masked in the kernels; 4,099
# columns end inside #4's 32-column tile and #1's 64-column one and leave
# #4's copies of joints and 1/neg ragged tails, 509 rows end inside the
# 64-row block)
NTXENT_CASES = [(512, 512, 0), (300, 700, 37), (1, 65, 64), (509, 4099, 37)]
NTXENT_IDS = ["step", "ragged-shard", "one-row", "ragged-tile"]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,offset", NTXENT_CASES, ids=NTXENT_IDS)
def test_kernels_match_plain_versions(cuda, m, n, offset):
    """Each kernel against its plain version."""
    K.reset_launches()
    for name, args in _inputs(cuda, m, n, offset).items():
        args = tuple(a.contiguous() for a in args)
        got, want = getattr(K, name)(*args, T), getattr(K, f"{name}_plain")(*args, T)
        torch.cuda.synchronize()
        if "grad" in name:
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert [fn.launches for fn in K.KERNELS] == [1, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ntxent_denominator", "weighted_ntxent_denominator",
                                  "ntxent_grad", "weighted_grad_rows"])
@pytest.mark.parametrize("m,n,offset", NTXENT_CASES, ids=NTXENT_IDS)
def test_weighted_grad_rows_repeats_bit_for_bit(cuda, m, n, offset, name):
    """The tensor-core kernels #1-#4 (three-pass TF32 products, column
    splits added in a fixed order): a second launch gives the same bits,
    within the limit of the plain version."""
    args = tuple(a.contiguous() for a in _inputs(cuda, m, n, offset)[name])
    kernel = getattr(K, name)
    K.reset_launches()
    got, again = kernel(*args, T), kernel(*args, T)
    want = getattr(K, f"{name}_plain")(*args, T)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if "grad" in name:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert kernel.launches == 2


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = _inputs(cuda, 64, 64, 0)["ntxent_denominator"]
    z, ids = args[1], args[2]
    with pytest.raises(TypeError, match="float32"):
        K.ntxent_denominator(z.half(), z.half(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        K.ntxent_denominator(z.T.contiguous().T, z, ids)
    with pytest.raises(ValueError, match="shape"):
        K.ntxent_denominator(z[:, :64].contiguous(), z, ids)
    with pytest.raises(ValueError, match="several devices"):
        K.ntxent_denominator(z, z.cpu(), ids)


@pytest.mark.gpu
def test_kernel_losses_match_the_dense_losses(cuda):
    """The two autograd Functions (kernel forward and backward) against the
    dense losses that autograd differentiates, at B = 256 pairs."""
    b = 256
    z = torch.randn(2 * b, 128, device="cuda", generator=cuda)
    z = z / z.norm(dim=1, keepdim=True)
    j1, j2 = (torch.rand(b, 21, 2, device="cuda", generator=cuda) * 128 for _ in range(2))
    pw, nw = linear_weights(j1, j2, "mpjpe")
    d_min, d_max = pairwise_minmax(torch.cat([j1, j2]), "mpjpe")
    minmax = torch.stack([d_max, d_min])
    cases = {
        "plain": (lambda a, c: K.nt_xent_kernel(a, c, T), lambda a, c: dense.nt_xent(a, c, T)),
        "weighted": (
            lambda a, c: K.weighted_nt_xent_kernel(a, c, torch.cat([j1, j2]), pw, minmax, T),
            lambda a, c: dense.weighted_nt_xent(a, c, pw, nw, T)),
    }
    for name, (kernel_loss, dense_loss) in cases.items():
        results = []
        for fn in (kernel_loss, dense_loss):
            z1, z2 = z[:b].clone().requires_grad_(), z[b:].clone().requires_grad_()
            loss = fn(z1, z2)
            results.append((loss.item(), torch.autograd.grad(loss, (z1, z2))))
        (lk, gk), (ld, gd) = results
        assert lk == pytest.approx(ld, rel=1e-5), name
        for a, c in zip(gk, gd):
            # the same terms summed in other orders, and the dense route's
            # distances divided by 21 where the kernel multiplies by 1/21
            assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max()), name


# --------------------------------------------------------------------------
# the fused BN+ReLU backward kernels (csrc/bn_epilogue.cu)
# --------------------------------------------------------------------------

def _bn_inputs(gen, shape, dtype, offset=0):
    """x, r, g with the channel on dim 1 and channels-last strides, each
    ``offset`` elements into its storage, the affine constants of x's
    statistics, and P."""
    from simhand_tpu_torch.models import bn_epilogue as E

    n, c, h, w = shape

    def plane():
        t = torch.randn(n * h * w * c + offset, device="cuda", generator=gen).to(dtype)
        return t[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    x, r, g = plane(), plane(), plane()
    scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
    mu, _, inv = E.batch_stats(x, 1e-5)
    return x, r, g, [*E._affine_consts(mu, inv, scale, bias)], scale * inv


# (label, NCHW shape, element offset of the planes): ragged M and C (no
# multiple of 8 rows, C dividing no 2,048: the per-element walk); widths of
# the ResNet sites on the ring, one with more rows than its ring has stages;
# and a layer1 width at a base that no bulk copy takes
BN_CASES = [("1000x96", (8, 96, 5, 25), 0), ("231x100", (3, 100, 7, 11), 0),
            ("4000x64", (8, 64, 25, 20), 0), ("126x256", (2, 256, 7, 9), 0),
            ("18x2048", (3, 2048, 2, 3), 0), ("32768x256", (128, 256, 16, 16), 0),
            ("offset-126x256", (2, 256, 7, 9), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,offset", [c[1:] for c in BN_CASES], ids=[c[0] for c in BN_CASES])
def test_bn_epilogue_kernels_match_plain_versions(cuda, shape, offset, dtype):
    """Kernels #5-#8 against their plain versions, with a gradient that is
    not channels-last (the wrapper copies it). Sums to rel 1e-5 of the
    largest (the same float32 terms added in another order); dres and dx
    equal bit for bit (the same float32 operations, each rounded, in the
    same order); a second launch of each gives the same bits, sums
    included."""
    from simhand_tpu_torch.models import bn_epilogue as E

    x, r, g, consts, P = _bn_inputs(cuda, shape, dtype, offset)
    g = g.contiguous()                                    # NCHW, not channels-last
    m = x.numel() // x.shape[1]
    g2d, x2d, r2d = E.as_rows(g), E.as_rows(x), E.as_rows(r)
    E.reset_launches()

    sums = E.masked_dual_reduce(g, x, *consts)
    want_sums = E.masked_dual_reduce_plain(g2d, x2d, *consts)
    for a, b in zip(sums, want_sums):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    again = E.masked_dual_reduce(g, x, *consts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, sums))
    k = [v / m for v in want_sums]
    dx = E.masked_dx(g, x, *consts, P, *k)
    dx_again = E.masked_dx(g, x, *consts, P, *k)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(E.as_rows(dx), E.masked_dx_plain(g2d, x2d, *consts, P, *k))
    assert torch.equal(dx_again, dx)

    *res_sums, dres = E.masked_dual_reduce_res(g, x, r, *consts)
    *want_sums, want_dres = E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *consts)
    for a, b in zip(res_sums, want_sums):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert dres.shape == r.shape and dres.dtype == dtype
    assert dres.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(E.as_rows(dres), want_dres)
    k = [v / m for v in want_sums]
    dx = E.masked_dx_res(E.from_rows(want_dres, x), x, *consts[2:], P, *k)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(E.as_rows(dx), E.masked_dx_res_plain(want_dres, x2d, *consts[2:], P, *k))

    *again, dres2 = E.masked_dual_reduce_res(g, x, r, *consts)
    dx2 = E.masked_dx_res(E.from_rows(want_dres, x), x, *consts[2:], P, *k)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, res_sums))
    assert torch.equal(dres2, dres) and torch.equal(dx2, dx)
    assert [fn.launches for fn in E.KERNELS] == [2, 2, 2, 2]


@pytest.mark.gpu
def test_bn_epilogue_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from simhand_tpu_torch.models import bn_epilogue as E

    x, r, g, consts, P = _bn_inputs(cuda, (2, 64, 4, 4), torch.bfloat16)
    k = [torch.zeros(64, device="cuda")] * 2
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        E.masked_dual_reduce(g.half(), x.half(), *consts)
    with pytest.raises(ValueError, match="channels-last"):
        E.masked_dual_reduce(g, x.contiguous(), *consts)
    with pytest.raises(ValueError, match="residual"):
        E.masked_dual_reduce_res(g, x, r.float(), *consts)
    with pytest.raises(ValueError, match="A"):
        E.masked_dual_reduce(g, x, consts[0].double(), *consts[1:])
    with pytest.raises(ValueError, match="several devices"):
        E.masked_dual_reduce(g, x.cpu(), *consts)
    _, _, dres = E.masked_dual_reduce_res(g, x, r, *consts)
    with pytest.raises(ValueError, match="dres"):
        E.masked_dx_res(dres.float(), x, *consts[2:], P, *k)
    with pytest.raises(ValueError, match="dres: must be channels-last"):
        E.masked_dx_res(dres.contiguous(), x, *consts[2:], P, *k)
    with pytest.raises(ValueError, match="P"):
        E.masked_dx_res(dres, x, *consts[2:], P[:-1], *k)


@pytest.mark.gpu
def test_bn_ring_fits_mirrors_the_source(cuda):
    """bn_epilogue.ring_fits (what the CPU tests and chip_smoke.py ask)
    answers as the CUDA source's own test, bn_ring_fits, at every BN_CASES
    width, both dtypes, aligned and unaligned bases."""
    from simhand_tpu_torch.models import bn_epilogue as E

    for _, (_, c, _, _), _ in BN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            esize = torch.empty(0, dtype=dtype).element_size()
            for ptrs in ((), (0, 256), (0, esize), (16, 32 + esize)):
                assert E.kernel_ring_fits(c, dtype, *ptrs) == E.ring_fits(c, esize, *ptrs)
    assert E.kernel_ring_fits(256, torch.bfloat16, 0, 512)
    assert not E.kernel_ring_fits(96, torch.bfloat16, 0, 512)


@pytest.mark.gpu
def test_bnrelu_kernel_backward_matches_plain_backward(cuda):
    """BNAddReluTrain, impl="kernel" against impl="plain", with the gradient
    the mean pool hands back (an expanded, stride-0 tensor)."""
    from simhand_tpu_torch.models import bn_epilogue as E

    x, r, _, _, _ = _bn_inputs(cuda, (16, 256, 8, 8), torch.bfloat16)
    scale = torch.ones(256, device="cuda", requires_grad=True)
    bias = torch.zeros(256, device="cuda", requires_grad=True)
    out = []
    for impl in ("kernel", "plain"):
        xx, rr = x.clone().requires_grad_(), r.clone().requires_grad_()
        y, _, _ = E.BNAddReluTrain.apply(xx, rr, scale, bias, 1e-5, impl)
        out.append([y, *torch.autograd.grad(y.float().mean(dim=(2, 3)).sum(),
                                             (xx, rr, scale, bias))])
    (y, dx, dres, ds, db), (y_, dx_, dres_, ds_, db_) = out
    assert torch.equal(y, y_) and torch.equal(dres, dres_)      # the same forward; dres = dy
    # the sums, and so k1 and k2, differ in their last bits: a dx element may
    # round to the neighbouring bf16 value
    a, b = dx.float(), dx_.float()
    assert ((a - b).abs() <= 2.0**-7 * b.abs() + 1e-6 * b.abs().max()).all()
    for a, b in ((ds, ds_), (db, db_)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# --------------------------------------------------------------------------
# kernel #9, the two reduces of the plain BatchNorm backward (fused_bn.py)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,offset", [c[1:] for c in BN_CASES], ids=[c[0] for c in BN_CASES])
def test_bn_backward_reduces_matches_plain_version(cuda, shape, offset, dtype):
    """Kernel #9 at the shapes of BN_CASES (the ring and the per-element
    walk), with a channels-last gradient and one that is not (the wrapper
    copies it); sums to rel 1e-5 of the largest (the same float32 terms,
    each rounded in the plain version's order, added in another order); a
    second launch gives the same bits."""
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F

    x, _, g, _, _ = _bn_inputs(cuda, shape, dtype, offset)
    mu, _, inv = E.batch_stats(x, 1e-5)
    want = F.bn_backward_reduces_plain(E.as_rows(x), E.as_rows(g), mu, inv)
    F.reset_launches()
    for dy in (g, g.contiguous()):
        got = F.bn_backward_reduces(x, dy, mu, inv)
        again = F.bn_backward_reduces(x, dy, mu, inv)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert F.bn_backward_reduces.launches == 4
    with pytest.raises(ValueError, match="channels-last"):
        F.bn_backward_reduces(x.contiguous(), g, mu, inv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        F.bn_backward_reduces(x.half(), g.half(), mu, inv)


@pytest.mark.gpu
def test_fused_batchnorm_kernel_backward_matches_plain_backward(cuda):
    """BNTrain, reduce_impl="kernel" against "plain": the same forward, and
    gradients whose sums differ in their last bits."""
    from simhand_tpu_torch.models import fused_bn as F

    x, _, g, _, _ = _bn_inputs(cuda, (16, 256, 8, 8), torch.bfloat16)
    scale = torch.rand(256, device="cuda", generator=cuda).add_(0.5).requires_grad_()
    bias = torch.zeros(256, device="cuda", requires_grad=True)
    out = []
    for impl in ("kernel", "plain"):
        xx = x.clone().requires_grad_()
        y, _, _ = F.BNTrain.apply(xx, scale, bias, 1e-5, False, impl)
        out.append([y, *torch.autograd.grad(y, (xx, scale, bias), g)])
    (y, dx, ds, db), (y_, dx_, ds_, db_) = out
    assert torch.equal(y, y_)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    a, b = dx.float(), dx_.float()
    assert ((a - b).abs() <= 2.0**-7 * b.abs() + 1e-6 * b.abs().max()).all()
    for a, b in ((ds, ds_), (db, db_)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# --------------------------------------------------------------------------
# kernels #10/#11, the 1x1 convolution with statistics (ops/conv1x1.py)
# --------------------------------------------------------------------------

def assert_y_within_one_ulp(got, want, x2d, w):
    """bf16 y against the plain version's (cuBLAS in float32, TF32 off): one
    bf16 ulp at the larger magnitude, plus 2^-16 * sum_k |x||w|, an allowance
    for the two float32 accumulations' different order (their difference is
    of the order of K * 2^-24 * |y|, which only matters where y is near 0)."""
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    floor = 2.0**-16 * (x2d.float().abs() @ w.float().abs().T)
    assert ((a - b).abs() <= ulp + floor).all(), float((a - b).abs().max())


def assert_stats_of(y, s1, s2):
    """s1, s2 against the float64 column sums of the kernel's own y: rel
    1e-5 of the largest (float32 sums of rounded values, in tiles)."""
    y64 = y.double()
    for got, want in ((s1, y64.sum(0)), (s2, (y64 * y64).sum(0))):
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def conv1x1_operands(gen, m, cin, cout):
    x2d = torch.randn(m, cin, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(cout, cin, device="cuda", generator=gen) / cin**0.5).bfloat16()
    A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
    B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
    return x2d, w, A, B


@pytest.mark.gpu
@pytest.mark.parametrize("m,cin,cout", [
    (1000, 96, 40), (300, 200, 136), (128, 8, 8), (72, 8, 8), (40, 64, 16), (1000, 256, 2048),
    (20000, 512, 256), (40000, 64, 128), (65535 * 128 + 1, 8, 8),
], ids=["1000x96-40", "300x200-136", "one-tile", "72x8-8", "m-below-64", "ragged-m-2048",
        "persistent-256", "persistent-128", "past-old-grid"])
def test_conv1x1_kernels_match_plain_versions(cuda, m, cin, cout):
    """The edges of the TMA + wgmma design: K below the 64-wide box (8) and
    K not a multiple of it (96, 200); N below a 128-wide tile (40, 16), of
    two 256-wide tiles (136) and of eight (2,048) at a ragged M; one row
    tile, M below a warpgroup's 64 rows; more tiles than the card has SMs
    at both tile widths; more rows than 65,535 tiles of 128. The statistics
    against the plain version's to rel 1e-3 of the largest (a y element
    that rounds to the neighbouring bf16 value moves them)."""
    from simhand_tpu_torch.ops import conv1x1 as C

    x2d, w, A, B = conv1x1_operands(cuda, m, cin, cout)
    C.reset_launches()
    xa = torch.relu(x2d.float() * A + B).bfloat16()
    for got, want, xin in ((C.conv1x1_stats(x2d, w), C.conv1x1_stats_plain(x2d, w), x2d),
                           (C.conv1x1_bn_relu_stats(x2d, w, A, B),
                            C.conv1x1_bn_relu_stats_plain(x2d, w, A, B), xa)):
        torch.cuda.synchronize()
        y, s1, s2 = got
        assert y.shape == (m, cout) and y.dtype == torch.bfloat16
        assert_y_within_one_ulp(y, want[0], xin, w)
        assert_stats_of(y, s1, s2)
        for a, b in zip((s1, s2), want[1:]):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert [fn.launches for fn in C.KERNELS] == [1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("m,cin,cout", [(20000, 512, 256), (40000, 64, 128), (1000, 96, 40)],
                         ids=["persistent-256", "persistent-128", "1000x96-40"])
def test_conv1x1_kernels_repeat_bit_for_bit(cuda, m, cin, cout):
    """No atomics and a fixed order of every sum: a second launch on the
    same inputs gives the same y, s1 and s2 bit for bit."""
    from simhand_tpu_torch.ops import conv1x1 as C

    x2d, w, A, B = conv1x1_operands(cuda, m, cin, cout)
    for kernel in (lambda: C.conv1x1_stats(x2d, w), lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B)):
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_conv1x1_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from simhand_tpu_torch.ops import conv1x1 as C

    x2d = torch.randn(64, 32, device="cuda", generator=cuda).bfloat16()
    w = torch.randn(16, 32, device="cuda", generator=cuda).bfloat16()
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        C.conv1x1_stats(x2d.half(), w.half())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        C.conv1x1_stats(x2d.float(), w)
    with pytest.raises(ValueError, match="row-major"):
        C.conv1x1_stats(x2d.T.contiguous().T, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        C.conv1x1_stats(x2d[:, :28].contiguous(), w[:, :28].contiguous())
    with pytest.raises(ValueError, match="multiples of 8"):
        C.conv1x1_stats(x2d, w[:12].contiguous())
    with pytest.raises(ValueError, match="w: expected"):
        C.conv1x1_stats(x2d, w[:, :16].contiguous())
    with pytest.raises(ValueError, match="A"):
        C.conv1x1_bn_relu_stats(x2d, w, torch.ones(16, device="cuda"),
                                torch.zeros(32, device="cuda"))
    with pytest.raises(ValueError, match="several devices"):
        C.conv1x1_stats(x2d, w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("m,cin,cout", [(1000, 96, 40), (300, 200, 136), (20000, 512, 256)],
                         ids=["1000x96-40", "300x200-136", "20000x512-256"])
def test_conv1x1_float32_kernels_match_plain_versions(cuda, m, cin, cout):
    """The float32 instantiations (CUDA-core float32, no TF32) against the
    plain version (cuBLAS float32 with TF32 off): y within 1e-5 of its
    largest element (the same products summed in another order), s1 and s2
    within rel 1e-5 of the float64 sums of the kernel's own y and of the
    plain version's; ragged M, K and N; a second launch bit-equal."""
    from simhand_tpu_torch.ops import conv1x1 as C

    x2d, w, A, B = (t.float() for t in conv1x1_operands(cuda, m, cin, cout))
    C.reset_launches()
    for kernel, plain in ((lambda: C.conv1x1_stats(x2d, w), lambda: C.conv1x1_stats_plain(x2d, w)),
                          (lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B),
                           lambda: C.conv1x1_bn_relu_stats_plain(x2d, w, A, B))):
        (y, s1, s2), want = kernel(), plain()
        torch.cuda.synchronize()
        assert y.shape == (m, cout) and y.dtype == torch.float32
        assert float((y - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())
        assert_stats_of(y, s1, s2)
        for a, b in zip((s1, s2), want[1:]):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        assert all(torch.equal(u, v) for u, v in zip(kernel(), (y, s1, s2)))
    assert [fn.launches for fn in C.KERNELS] == [2, 2]


# --------------------------------------------------------------------------
# the convolution with a bias / residual / ReLU epilogue (ops/conv_bias.py)
# --------------------------------------------------------------------------

def conv_operands(gen, n, h, w, cin, cout, k):
    """x, the tap-major weight with the scale of a folded convolution, the
    float32 bias."""
    x = torch.randn(n, h, w, cin, device="cuda", generator=gen).bfloat16()
    wt = (torch.randn(cout, k * k * cin, device="cuda", generator=gen) / (k * k * cin) ** 0.5)
    return x, wt.bfloat16(), 0.1 * torch.randn(cout, device="cuda", generator=gen)


def assert_conv_within_one_ulp(got, want, x, w, kernel, stride, pads):
    """y against the plain version: one bf16 ulp at the larger magnitude plus
    2^-16 * sum |x||w| over the window (the float32 sums' other order)."""
    from simhand_tpu_torch.ops import conv_bias as CB

    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    floor = 2.0**-16 * (CB.patches(x.float().abs(), kernel, stride, pads) @ w.float().abs().T)
    assert ((a - b).abs() <= ulp + floor.view(a.shape)).all(), float((a - b).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,padding", [
    (2, 9, 11, 40, 72, 3, 1, "SAME"), (3, 16, 16, 64, 136, 3, 2, "SAME"),
    (2, 32, 32, 3, 64, 7, 2, ((3, 3), (3, 3))), (4, 4, 4, 512, 512, 3, 1, "SAME"),
    (1, 300, 2, 8, 8, 1, 1, "SAME"),
], ids=["3x3s1-odd", "3x3s2", "stem", "layer4-3x3", "1x1-long-row"])
def test_conv_bias_act_matches_plain_version(cuda, n, h, w, cin, cout, k, stride, padding):
    """Stride 1 at odd H and W (taps past every edge read TMA's zero fill,
    Cin and Cout not multiples of 64), stride 2 (element strides; XLA's (0,
    1) pads), the stem's patch route (Cin = 3), layer4's 3x3 (eight images a
    tile, BN 128) and a 1x1 given as one long row; each with and without the
    residual and ReLU. A second launch is bit-equal."""
    from simhand_tpu_torch.ops import conv_bias as CB

    x, wt, b = conv_operands(cuda, n, h, w, cin, cout, k)
    pads = CB.conv_pads(h, w, (k, k), stride, padding)
    oh, ow = CB.out_size(h, w, (k, k), stride, pads)
    res = torch.randn(n, oh, ow, cout, device="cuda", generator=cuda).bfloat16()
    CB.reset_launches()
    for relu, r in ((False, None), (True, res)):
        kw = dict(kernel=(k, k), stride=stride, padding=padding, relu=relu, res=r)
        got, want = CB.conv_bias_act(x, wt, b, **kw), CB.conv_bias_act_plain(x, wt, b, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (n, oh, ow, cout) and got.dtype == torch.bfloat16
        assert_conv_within_one_ulp(got, want, x, wt, (k, k), stride, pads)
        assert torch.equal(CB.conv_bias_act(x, wt, b, **kw), got)
    assert CB.conv_bias_act.launches == 4


@pytest.mark.gpu
def test_conv_bias_act_refuses_what_the_kernel_does_not_take(cuda):
    from simhand_tpu_torch.ops import conv_bias as CB

    x, wt, b = conv_operands(cuda, 2, 8, 8, 16, 24, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        CB.conv_bias_act(x.float(), wt, b, kernel=(3, 3))
    with pytest.raises(ValueError, match="channels-last"):
        CB.conv_bias_act(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), wt, b,
                         kernel=(3, 3))
    with pytest.raises(ValueError, match="res: expected"):
        CB.conv_bias_act(x, wt, b, kernel=(3, 3), res=x[..., :8].contiguous())
    with pytest.raises(ValueError, match="several devices"):
        CB.conv_bias_act(x, wt, b.cpu(), kernel=(3, 3))


# --------------------------------------------------------------------------
# kernel #12, the whole frozen bottleneck block (ops/bottleneck_block.py)
# --------------------------------------------------------------------------

def block_operands(gen, imgs, hw, cin, cm):
    """x and the K-contiguous folded weights of one identity block, with the
    scales of a folded ResNet block (weights ~ 1/sqrt(fan-in))."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    x = randn(imgs * hw[0] * hw[1], cin).bfloat16()
    w1 = randn(cm, cin, scale=cin**-0.5).bfloat16()
    w2 = randn(cm, 9, cm, scale=(9 * cm) ** -0.5).bfloat16()
    w3 = randn(cin, cm, scale=cm**-0.5).bfloat16()
    return x, w1, 0.1 * randn(cm), w2, 0.1 * randn(cm), w3, 0.1 * randn(cin)


def block_differences(got, want):
    """(max abs difference, share of elements more than one bf16 ulp apart
    at the larger magnitude)."""
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    diff = (a - b).abs()
    return float(diff.max()), float((diff > torch.ldexp(torch.ones_like(a), e - 8)).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("imgs,hw,cin,cm", [(256, (4, 4), 2048, 512), (4, (2, 3), 256, 128),
                                             (9, (7, 7), 2048, 512), (1, (32, 32), 256, 64)],
                         ids=["layer4-128", "ragged-2x3", "layer4-224-part", "layer1-128"])
def test_bottleneck_block_matches_plain_version(cuda, imgs, hw, cin, cm):
    """The main path's shape (eight images a tile), the JAX test's
    non-square (2, 3), 7x7 (two images, 98 rows a tile) and one image of
    layer1 at 128x128 (32 x 32, four rows a tile; the whole-image design
    refused it). y within the JAX test's rtol = atol = 2e-2 of the plain
    version (float32 sums of the same bf16 products in another order: an
    element of h1 or h2 that rounds to its other neighbour moves y), and at
    most 2% of y more than one bf16 ulp from it (measured 0.44-0.51% at
    layer4 on an H100 by the earlier design, four times that)."""
    from simhand_tpu_torch.ops import bottleneck_block as BB

    args = block_operands(cuda, imgs, hw, cin, cm)
    from simhand_tpu_torch.ops import conv_bias as CB

    BB.reset_launches()
    CB.reset_launches()
    got = BB.bottleneck_block(*args, hw=hw)
    want = BB.bottleneck_block_plain(*args, hw=hw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert BB.bottleneck_block.launches == 1 and CB.conv_bias_act.launches == 3
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    err, share = block_differences(got, want)
    print(f"bottleneck_block {imgs}x{hw} {cin}/{cm}: max abs err {err:.3e}, "
          f"share over one ulp {share:.3e}")
    assert share <= 2e-2


@pytest.mark.gpu
def test_bottleneck_block_refuses_what_the_kernel_does_not_take(cuda):
    from simhand_tpu_torch.ops import bottleneck_block as BB

    x, w1, b1, w2, b2, w3, b3 = block_operands(cuda, 2, (4, 4), 256, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        BB.bottleneck_block(x.float(), w1, b1, w2, b2, w3, b3, hw=(4, 4))
    with pytest.raises(ValueError, match="w2"):
        BB.bottleneck_block(x, w1, b1, w2[:, :, :96], b2, w3, b3, hw=(4, 4))
    with pytest.raises(ValueError, match="multiples of 8"):
        BB.bottleneck_block(x[:, :100].contiguous(), w1[:, :100].contiguous(), b1, w2, b2,
                            w3[:100].contiguous(), b3[:100].contiguous(), hw=(4, 4))
    with pytest.raises(ValueError, match="several devices"):
        BB.bottleneck_block(x, w1.cpu(), b1, w2, b2, w3, b3, hw=(4, 4))


# the augmentation on the card against the CPU with the same draws
# (tests/test_torch_augment.py's chain tolerances, on the 0-255 scale): all
# but 1e-4 of the image elements within 0.05, the crop box and angle
# exactly, the joints within 1e-3 px
AUGMENT_FLAGS = {"main": dict(crop=True, resize=True, rotate=True),
                 "all": dict(color_drop=True, color_jitter=True, crop=True, cut_out=True,
                             gaussian_blur=True, random_crop=True, resize=True, rotate=True,
                             gaussian_noise=True, sobel_filter=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["main", "all"])
def test_augmentation_on_the_card_matches_the_cpu(cuda, which):
    from simhand_tpu_torch.data import augment as A
    from simhand_tpu_torch.data.sources import SyntheticHandSource

    src = SyntheticHandSource(32, side=224, seed=1)
    images = torch.from_numpy(src.images).cuda()
    joints = torch.from_numpy(src.joints3d).cuda()
    flags, params = A.AugmentFlags(**AUGMENT_FLAGS[which]), A.AugmentParams()
    draws = A.sample_augment(A.seeded_generator("cuda", 0, 3), 32, 224, flags, params, 128)
    cpu_draws = A.AugmentDraws(*(None if t is None else t.cpu() for t in draws))
    got = A.apply_augment(images, joints, draws, flags, params, 128)
    want = A.apply_augment(images.cpu(), joints.cpu(), cpu_draws, flags, params, 128)
    box = A.warp_box(joints, draws, flags, params, (224, 224), 128)
    cpu_box = A.warp_box(joints.cpu(), cpu_draws, flags, params, (224, 224), 128)
    for got_t, want_t in zip(box, cpu_box):
        assert torch.equal(got_t.cpu(), want_t)
    assert torch.equal(got.angle.cpu(), want.angle)
    diff = (got.images.cpu() - want.images).abs() * (255.0 * min(A.IMAGENET_STD))
    assert float((diff > 0.05).double().mean()) <= 1e-4
    assert float((got.joints.cpu() - want.joints).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_prefetched_batches_equal_the_hosts(cuda):
    import numpy as np

    from simhand_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"image1": rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8),
                "joints1": rng.normal(size=(8, 21, 3)).astype(np.float32)} for _ in range(5)]
    seen = 0
    for got, want in zip(device_prefetch(iter(batches)), batches):
        # work on the consumer's stream between batches, as a step does
        torch.matmul(torch.randn(2048, 2048, device="cuda"), torch.randn(2048, 2048, device="cuda"))
        for k, v in want.items():
            assert got[k].is_cuda and torch.equal(got[k].cpu(), torch.from_numpy(v)), k
        seen += 1
    assert seen == 5


@pytest.mark.gpu
def test_staged_batches_reach_the_card_bit_for_bit(cuda, tmp_path):
    """``device_prefetch(batch_iterator(..., raw=True))``, a new pair each
    epoch as experiments/main.py makes them, over 3 epochs of a small cache
    and then one epoch as one rank's rows, with a consumer slowed on the card
    and waiting for it, so that the staging pool runs at its bound: every
    batch on the card equals the host's gather bit for bit, every batch goes
    straight from page-locked staging, and the pool allocates nothing after
    the first epoch."""
    import types

    import numpy as np

    from simhand_tpu_torch.data import staging
    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
    from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
    from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
    from simhand_tpu_torch.data.prefetch import device_prefetch
    from simhand_tpu_torch.data.sources import SyntheticHandSource
    from simhand_tpu_torch.parallel import mesh
    from simhand_tpu_torch.utils import trace

    n, pairs, seed = 512, 32, 2**31 + 11
    build_crop_cache(SyntheticHandSource(n, side=224, seed=3), str(tmp_path), shard_size=200)
    ds = PretrainDataset(CachedHand100MSource(str(tmp_path)), "simhand_w",
                         AugmentFlags(crop=True, resize=True, rotate=True), AugmentParams())
    per_epoch = n // pairs

    def epoch(e: int, axis=None) -> None:
        order = np.arange(n)
        np.random.default_rng([seed, e]).shuffle(order)
        kept = []
        for got in mesh.device_prefetch(batch_iterator(ds, pairs, seed=seed, epoch=e, raw=True),
                                        axis, "cuda"):
            torch.cuda._sleep(20_000_000)           # ~10 ms of the card's time a step
            kept.append({k: v.clone() for k, v in got.items()})
            torch.cuda.current_stream().synchronize()
        rows = slice(None) if axis is None else slice(pairs // 2, pairs)
        for b, got in enumerate(kept):
            want = ds.raw_batch(order[b * pairs:(b + 1) * pairs])
            for k, v in want.items():
                assert torch.equal(got[k].cpu(), torch.from_numpy(v[rows])), (e, b, k)
        assert len(kept) == per_epoch

    before = trace.counters()
    epoch(0)
    first = trace.counters()
    for e in (1, 2):
        epoch(e)
    epoch(3, types.SimpleNamespace(size=2, index=1))
    after = trace.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("feed.batches", "feed.pinned_batches", "feed.staging_allocs")}
    pool = staging.shared_pool()
    print(f"staged on the card: {delta}, allocations after the first epoch "
          f"{after.get('feed.staging_allocs', 0) - first.get('feed.staging_allocs', 0)}, "
          f"blocks {pool.blocks} of {pool.limit}, free {pool.free_blocks()}")
    assert delta["feed.batches"] == delta["feed.pinned_batches"] == 4 * per_epoch
    assert after.get("feed.staging_allocs", 0) == first.get("feed.staging_allocs", 0)
    assert 0 < pool.blocks <= staging.LIMIT
    assert pool.free_blocks() == pool.blocks        # the finished epochs keep none


@pytest.mark.gpu
def test_int8_compute_walk_on_the_card_equals_its_cpu_run(cuda):
    """The W8A8 encoder (ResNet-18 at 64x64, calibrated on the CPU) on the
    card against the same module on the CPU: every int8 activation of the
    walk equal (exact int8 GEMMs, the same float64 epilogue on both), so the
    embeddings agree within rel 1e-5 (the float32 pool and head alone
    differ in their order of sums)."""
    import copy

    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.serving.int8_infer import (build_encoder_int8,
                                                      random_calibration_batches)

    torch.manual_seed(0)
    model = ContrastiveModel("18").eval()
    calib = random_calibration_batches(side=64, batch=4, n=2)
    cpu, _ = build_encoder_int8(model, calib_batches=calib)
    card = copy.deepcopy(cpu).cuda()
    seen = {"cpu": {}, "cuda": {}}

    def record(module, where):
        requant, conv = module.ops._requant, module.ops.conv_bn_relu

        def _requant(key, y, lo=-127):
            out = requant(key, y, lo)
            seen[where][key] = out[0].cpu()
            return out

        def conv_bn_relu(key, xq_s, *args, **kw):
            out = conv(key, xq_s, *args, **kw)
            seen[where][key] = out[0].cpu()
            return out

        module.ops._requant, module.ops.conv_bn_relu = _requant, conv_bn_relu

    record(cpu, "cpu")
    record(card, "cuda")
    x = torch.from_numpy(random_calibration_batches(side=64, batch=24, n=1, seed=1)[0])
    with torch.no_grad():
        want, got = cpu(x), card(x.cuda())
    assert seen["cpu"].keys() == seen["cuda"].keys() and len(seen["cpu"]) == 18
    for key, a in seen["cpu"].items():
        assert torch.equal(a, seen["cuda"][key]), key
    for k in ("embedding", "projection"):
        err = (got[k].cpu() - want[k]).abs().max() / want[k].abs().max()
        assert err <= 1e-5, (k, float(err))


@pytest.mark.gpu
def test_artifacts_exported_on_the_cpu_serve_on_the_card(cuda, tmp_path):
    """load_artifact moves a program exported on the CPU to the card, the
    constants made inside the forward (the detnet's pose tile) included: a
    float32 detnet (ResNet-18, 64x64) within 1e-4 of its CPU run (TF32 off),
    the W8A8 encoder within rel 1e-5."""
    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.serving.export import (build_detnet_forward, export_forward,
                                                  load_artifact, save_artifact)
    from simhand_tpu_torch.serving.int8_infer import (build_encoder_int8,
                                                      random_calibration_batches)

    torch.manual_seed(0)
    det = build_detnet_forward(DetNet("18", hm_res=16))
    enc, _ = build_encoder_int8(ContrastiveModel("18").eval(),
                                calib_batches=random_calibration_batches(side=64, batch=4))
    x = torch.from_numpy(random_calibration_batches(side=64, batch=6, n=1, seed=2)[0])
    # h_map alone of the detnet: the argmax of its near-flat random maps (uv,
    # xyz, delta) can move with the last bits of a sum
    for name, forward, keys in (("detnet", det, ("h_map",)),
                                ("encoder", enc, ("embedding", "projection"))):
        path = str(tmp_path / f"{name}.pt2")
        save_artifact(path, export_forward(forward, side=64), {"side": 64})
        on_cpu = load_artifact(path, "cpu")[0](x)
        on_card = load_artifact(path, "cuda")[0](x.cuda())
        for k in keys:
            assert on_card[k].device.type == "cuda"
            err = (on_card[k].cpu() - on_cpu[k]).abs().max()
            limit = 1e-4 if name == "detnet" else 1e-5 * float(on_cpu[k].abs().max())
            assert err <= limit, (name, k, float(err))


@pytest.mark.gpu
def test_mining_on_the_card_equals_the_cpu(cuda):
    """Similar-hand mining on a corpus of hands on the integer grid
    {0, 1, 2, 3} (copies of 64 poses over 16 videos, so exact ties abound),
    k = 3, ragged chunks, both query routes: the card's distances equal the
    CPU's bit for bit and its indices equal them, the order of ties
    included (``min``'s first index on both devices)."""
    import numpy as np

    from simhand_tpu_torch.mining import mine_similar_hands

    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, size=(64, 21, 2)).astype(np.float32)
    kp = base[rng.integers(0, 64, size=1024)]
    vids = rng.integers(0, 16, size=1024).astype(np.int32)
    kw = dict(k=3, query_chunk=300, db_chunk=384)
    want_d, want_i = mine_similar_hands(kp, vids, device="cpu", **kw)
    assert int((np.diff(want_d, axis=1) == 0).sum()) > 100
    for single in (True, False):
        got_d, got_i = mine_similar_hands(kp, vids, single_program=single, **kw)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d.view(np.uint32), want_d.view(np.uint32))
