"""The port's convolution with a bias / residual / ReLU epilogue
(``simhand_tpu_torch.ops.conv_bias``) against the JAX package on the CPU.

``conv_bias_act_plain`` (what the wrapper runs on CPU tensors) against the
reference's convolution, ``jax.lax.conv_general_dilated(...,
preferred_element_type=float32) + b`` (+ the residual), ReLU, one rounding to
bf16 (``simhand_tpu/ops/bottleneck_block.py:186-204``), at the serving walk's
kinds of convolution: the 7x7/2 stem with pads (3, 3), 3x3/1 'SAME' (odd H
and W), 3x3/2 'SAME' on an even input (XLA pads (0, 1)), 1x1/1 and 1x1/2.
The port's weight is (Cout, kh * kw * Cin), tap-major; the reference's HWIO:
the tests transpose. Inputs are made from a seed with numpy. Also the pieces
of the card's route that run in Python: the stem's patch gather, the block
as three convolutions, and the wrapper's checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simhand_tpu.ops import bottleneck_block as JB
from simhand_tpu_torch.ops import bottleneck_block as TB
from simhand_tpu_torch.ops import conv_bias as C

torch.set_num_threads(2)

# (N, H, W, Cin, Cout, kernel, stride, padding, relu)
CASES = {
    "stem-7x7s2": (2, 16, 16, 3, 16, 7, 2, ((3, 3), (3, 3)), True),
    "3x3s1-odd": (2, 9, 11, 16, 24, 3, 1, "SAME", True),
    "3x3s2-even": (2, 8, 8, 16, 16, 3, 2, "SAME", True),
    "1x1s1": (2, 5, 7, 32, 48, 1, 1, "SAME", True),
    "1x1s2": (2, 8, 8, 32, 64, 1, 2, "SAME", False),
}


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def operands(n, h, w, cin, cout, k, stride, padding, seed=0):
    """(JAX x, w, b, res) and (port x, w, b, res): bf16 x and w with the
    scale of a folded convolution, a float32 bias, a bf16 residual."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, h, w, cin)), jnp.bfloat16)
    w_hwio = jnp.asarray(rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin),
                         jnp.bfloat16)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    pads = C.conv_pads(h, w, (k, k), stride, padding)
    oh, ow = C.out_size(h, w, (k, k), stride, pads)
    res = jnp.asarray(rng.standard_normal((n, oh, ow, cout)), jnp.bfloat16)
    tx = torch.from_numpy(f32(x).copy()).bfloat16()
    tw = torch.from_numpy(f32(w_hwio).transpose(3, 0, 1, 2).reshape(cout, -1).copy()).bfloat16()
    tres = torch.from_numpy(f32(res).copy()).bfloat16()
    return (x, w_hwio, b, res, pads), (tx, tw, torch.from_numpy(b), tres)


def jax_conv(x, w_hwio, b, res, pads, stride, relu):
    """The reference's convolution: float32 sums, + b (+ res), act, one rounding."""
    y = jax.lax.conv_general_dilated(x, w_hwio, (stride, stride), list(pads),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.float32) + b
    if res is not None:
        y = y + res.astype(jnp.float32)
    return (jax.nn.relu(y) if relu else y).astype(jnp.bfloat16)


def ulp_differences(got, want):
    """(share of elements that differ, whether every difference is within one
    bf16 ulp at the larger magnitude)."""
    a, b = (t.float() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t, np.float32))
            for t in (got, want))
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    diff = (a - b).abs()
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return float((diff > 0).float().mean()), bool((diff <= ulp).all())


@pytest.mark.parametrize("with_res", [False, True], ids=["bias", "bias+res"])
@pytest.mark.parametrize("case", CASES.values(), ids=CASES)
def test_plain_version_matches_the_reference(case, with_res):
    """The same bf16 products (exact in float32), summed in float32 in
    another order, + b (+ res), act, rounded once: equal except where the
    order flips a rounding, by one ulp; at most 1% of y (measured:
    bit-equal in every case on the CPU)."""
    n, h, w, cin, cout, k, stride, padding, relu = case
    (x, w_hwio, b, res, pads), (tx, tw, tb, tres) = operands(n, h, w, cin, cout, k, stride,
                                                             padding)
    want = f32(jax_conv(x, w_hwio, b, res if with_res else None, pads, stride, relu))
    got = C.conv_bias_act(tx, tw, tb, kernel=(k, k), stride=stride, padding=padding, relu=relu,
                          res=tres if with_res else None)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert torch.equal(got, C.conv_bias_act_plain(tx, tw, tb, kernel=(k, k), stride=stride,
                                                  padding=pads, relu=relu,
                                                  res=tres if with_res else None))
    share, within_ulp = ulp_differences(got, want)
    assert within_ulp and share <= 1e-2, share


def test_same_pads_are_xlas():
    """A stride-2 3x3 'SAME' convolution of an even input pads (0, 1); the
    stem's explicit pads pass through; 1x1/2 pads nothing."""
    assert C.conv_pads(32, 32, (3, 3), 2, "SAME") == ((0, 1), (0, 1))
    assert C.conv_pads(9, 11, (3, 3), 1, "SAME") == ((1, 1), (1, 1))
    assert C.conv_pads(8, 8, (1, 1), 2, "SAME") == ((0, 0), (0, 0))
    assert C.conv_pads(128, 128, (7, 7), 2, ((3, 3), (3, 3))) == ((3, 3), (3, 3))
    assert C.out_size(128, 128, (7, 7), 2, ((3, 3), (3, 3))) == (64, 64)
    assert C.out_size(32, 32, (3, 3), 2, ((0, 1), (0, 1))) == (16, 16)
    with pytest.raises(ValueError, match="negative"):
        C.conv_pads(8, 8, (3, 3), 1, ((-1, 1), (1, 1)))


def test_stem_patch_route_matches_plain_version():
    """The card's route for the stem (Cin = 3 rows are not 16-byte aligned):
    the bf16 (M, 152) patch matrix, zero past column 147, against the zero-
    padded weight is the same convolution: every product and every sum term
    the same (the zero columns add exact zeros); measured bit-equal."""
    n, h, w, cin, cout, k, stride, padding, _ = CASES["stem-7x7s2"]
    _, (tx, tw, tb, _) = operands(n, h, w, cin, cout, k, stride, padding)
    pads = C.conv_pads(h, w, (k, k), stride, padding)
    cols = C.patches(tx, (k, k), stride, pads, 152)
    assert cols.shape == (n * 8 * 8, 152) and cols.dtype == torch.bfloat16
    assert not cols[:, 147:].any()
    got = torch.relu(cols.float() @ F.pad(tw, (0, 5)).float().T + tb).bfloat16()
    want = C.conv_bias_act_plain(tx, tw, tb, kernel=(k, k), stride=stride, padding=pads,
                                 relu=True)
    share, within_ulp = ulp_differences(got.view(want.shape), want)
    assert within_ulp and share <= 1e-2, share


@pytest.mark.parametrize("hw,imgs", [((4, 4), 8), ((2, 3), 4)], ids=["4x4x8", "2x3x4"])
def test_block_as_three_convolutions_matches_the_reference(hw, imgs):
    """Kernel #12's route on the card, ``three_convs`` (1x1 + ReLU, 3x3
    'SAME' + ReLU over w2's tap-major view, 1x1 + the residual + ReLU), run
    here through the plain convolutions, against the Pallas block in
    interpret mode and the block's plain version: the same products and
    roundings (h1, h2, y), sums in other orders, so y within one ulp on at
    most 1% of its elements (measured: bit-equal)."""
    h, w = hw
    rng = np.random.default_rng(0)
    cin, cm = 256, 128

    def pair(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(f32(j).copy()).bfloat16()

    x = pair(rng.standard_normal((imgs * h * w, cin)))
    w1, w2, w3 = (pair(rng.standard_normal(s) * 0.05)
                  for s in ((cin, cm), (9, cm, cm), (cm, cin)))
    b1, b2, b3 = (rng.standard_normal(n).astype(np.float32) for n in (cm, cm, cin))
    want = f32(JB.bottleneck_block(x[0], w1[0], jnp.asarray(b1), w2[0], jnp.asarray(b2), w3[0],
                                   jnp.asarray(b3), hw=hw))
    targs = (x[1], w1[1].T.contiguous(), torch.from_numpy(b1), w2[1].permute(2, 0, 1).contiguous(),
             torch.from_numpy(b2), w3[1].T.contiguous(), torch.from_numpy(b3))
    got = TB.three_convs(*targs, hw=hw)
    for ref in (want, TB.bottleneck_block_plain(*targs, hw=hw)):
        share, within_ulp = ulp_differences(got, ref)
        assert within_ulp and share <= 1e-2, share


def test_wrapper_checks_what_the_kernel_takes():
    """The checks the wrapper makes before a launch (here on CPU tensors):
    bf16 operands, an activation whose memory is NHWC (an NCHW view with
    channels-last strides passes, a plain NCHW tensor does not), the
    weight's (Cout, kh * kw * Cin) shape, Cout a multiple of 8, stride 1 or
    2."""
    _, (tx, tw, tb, tres) = operands(2, 9, 11, 16, 24, 3, 1, "SAME")
    nchw_cl = tx.permute(0, 3, 1, 2)                    # channels-last strides
    C._check(nchw_cl.permute(0, 2, 3, 1), tw, tb, tres, (3, 3), 1)
    with pytest.raises(ValueError, match="channels-last"):
        C._check(nchw_cl.contiguous().permute(0, 2, 3, 1), tw, tb, None, (3, 3), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        C._check(tx.float(), tw, tb, None, (3, 3), 1)
    with pytest.raises(ValueError, match="w: expected"):
        C._check(tx, tw, tb, None, (1, 1), 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        C._check(tx, tw[:20].contiguous(), tb[:20].contiguous(), None, (3, 3), 1)
    with pytest.raises(ValueError, match="stride"):
        C._check(tx, tw, tb, None, (3, 3), 3)
    with pytest.raises(ValueError, match="b: expected"):
        C._check(tx, tw, tb.double(), None, (3, 3), 1)
