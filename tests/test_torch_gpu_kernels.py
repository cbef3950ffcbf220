"""The CUDA NT-Xent kernels on the card, against their plain PyTorch versions.

These tests need a CUDA card and ``nvcc``; without them they skip. They
import no JAX, so they run where the card is, without the repository's
``conftest.py`` (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_kernels.py

float32 throughout with TF32 off. Denominators are held to rtol 1e-5 (a sum
of N positive terms in another order); gradients to 1e-5 of their largest
element (a sum of N vectors of both signs).
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


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,offset", [(512, 512, 0), (300, 700, 37), (1, 65, 64)],
                         ids=["step", "ragged-shard", "one-row"])
def test_kernels_match_plain_versions(cuda, m, n, offset):
    """The training step's shape, and ragged shapes that end inside a tile
    (every row and column edge is masked in the kernel)."""
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
