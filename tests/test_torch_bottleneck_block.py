"""The port's whole-block bottleneck (``simhand_tpu_torch.ops.bottleneck_block``)
and the serving fold and walks (``simhand_tpu_torch.serving.int8_infer``)
against the JAX package on the CPU.

Block level: ``bottleneck_block_plain`` (what the wrapper runs on CPU
tensors) against the Pallas kernel of ``simhand_tpu/ops/bottleneck_block.py``
in interpret mode, at ``tests/test_bottleneck_block.py``'s shapes. The port
takes K-contiguous weights, the reference (Cin, Cm), (9, Cm, Cm), (Cm, Cout):
the tests transpose. Model level: the fold of a ResNet-18 and a ResNet-50
whose BatchNorm parameters and statistics are not the init's, carried over
with ``convert.from_flax_variables``, and the float32 and bf16 walks.
Inputs are made from a seed with numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.ops import bottleneck_block as JB
from simhand_tpu.serving import int8_infer as JI
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.ops import bottleneck_block as TB
from simhand_tpu_torch.serving import int8_infer as TI

torch.set_num_threads(2)
SIDE, B = 64, 2
BLOCKS = ("layer4_1", "layer4_2")


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def bf16_pair(a):
    """numpy -> (JAX bf16, port bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(f32(j).copy()).bfloat16()


def block_operands(hw, imgs, cin=256, cm=128, seed=0):
    """The JAX test's operands: (JAX args, port args), the port's weights
    K-contiguous."""
    h, w = hw
    rng = np.random.default_rng(seed)
    x = bf16_pair(rng.standard_normal((imgs * h * w, cin)))
    w1 = bf16_pair(rng.standard_normal((cin, cm)) * 0.05)
    w2 = bf16_pair(rng.standard_normal((9, cm, cm)) * 0.05)
    w3 = bf16_pair(rng.standard_normal((cm, cin)) * 0.05)
    b1, b2, b3 = (rng.standard_normal(n).astype(np.float32) for n in (cm, cm, cin))
    jargs = (x[0], w1[0], jnp.asarray(b1), w2[0], jnp.asarray(b2), w3[0], jnp.asarray(b3))
    targs = (x[1], w1[1].T.contiguous(), torch.from_numpy(b1), w2[1].permute(2, 0, 1).contiguous(),
             torch.from_numpy(b2), w3[1].T.contiguous(), torch.from_numpy(b3))
    return jargs, targs


@pytest.mark.parametrize("tap_mode", ["loop", "im2col"])
@pytest.mark.parametrize("hw,imgs", [((4, 4), 8), ((2, 3), 4)], ids=["4x4x8", "2x3x4"])
def test_plain_block_matches_pallas(hw, imgs, tap_mode):
    """The same products, rounded to bf16 at the same points (h1, h2, y):
    only the order of the float32 sums differs, which can round an element
    of h1, h2 or y to its neighbour. So y within one bf16 ulp of the larger
    magnitude (the JAX test allows 2e-2 between XLA and Pallas); measured
    bit-equal on the CPU. (2, 3) is non-square: the tap masks of rows and
    columns differ. Only the plain version takes ``tap_mode``; the wrapper
    on CPU tensors runs its "loop" order."""
    jargs, targs = block_operands(hw, imgs)
    want = f32(JB.bottleneck_block(*jargs, hw=hw, tap_mode=tap_mode))
    got = TB.bottleneck_block_plain(*targs, hw=hw, tap_mode=tap_mode)
    if tap_mode == "loop":
        assert torch.equal(TB.bottleneck_block(*targs, hw=hw), got)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    a, b = got.float(), torch.from_numpy(want.copy())
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    assert ((a - b).abs() <= torch.ldexp(torch.ones_like(a), e - 8)).all()


def test_block_checks_match_the_reference():
    _, (x, w1, b1, w2, b2, w3, b3) = block_operands((4, 4), 2)
    with pytest.raises(ValueError, match="Cin == Cout"):
        TB.bottleneck_block(x, w1, b1, w2, b2, torch.zeros(512, 128).bfloat16(),
                            torch.zeros(512), hw=(4, 4))
    with pytest.raises(ValueError, match="not a multiple of H\\*W=16"):
        TB.bottleneck_block(x[:24], w1, b1, w2, b2, w3, b3, hw=(4, 4))
    with pytest.raises(ValueError, match="tap_mode"):
        TB.bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3, hw=(4, 4), tap_mode="roll")


def test_block_override_skips_strided_blocks():
    """The hook refuses layer4_0 (stride 2 and a projection shortcut):
    registering it is a silent no-op, not wrong math."""
    ops = TB.FoldedBf16Ops({}, {"layer4_0": object()})
    x = torch.zeros((1, 64, 8, 8), dtype=torch.bfloat16)
    assert ops.block_override("layer4_0", x, 2, 64, 128) is None


def test_block_override_runs_the_block_on_the_nhwc_plane():
    """A registered identity block: the (M, C) plane of the NCHW view, image
    major, and the result back in NCHW."""
    jargs, targs = block_operands((2, 3), 4)
    x = targs[0].view(4, 2, 3, 256).permute(0, 3, 1, 2)
    y = TB.FoldedBf16Ops({}, {"layer3_1": targs[1:]}).block_override("layer3_1", x, 1, 256, 256)
    want = f32(JB.bottleneck_block(*jargs, hw=(2, 3))).reshape(4, 2, 3, 256)
    assert y.shape == (4, 256, 2, 3)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).float().numpy(), want)


# --------------------------------------------------------------------------
# the fold and the walks, on one model of each kind
# --------------------------------------------------------------------------

def _with_frozen_stats(variables, seed):
    """numpy copies of the variables with BatchNorm scale ~ 1 + N(0, 0.1^2),
    bias ~ N(0, 0.1^2), running mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def params(path, a):
        leaf, owner = path[-1].key, path[-2].key
        if "bn" in owner and leaf == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bn" in owner and leaf == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    def stats(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(params, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])}


@functools.cache
def _models(size: str):
    """(backbone, JAX variables, the port's float32 model in eval mode,
    images) for one backbone, made once and shared by the tests below."""
    jm = JModel(resnet_size=size, dtype=jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    variables = _with_frozen_stats(variables, seed=1)
    model = TModel(size)
    model.load_state_dict(from_flax_variables(variables["params"], variables["batch_stats"]),
                          strict=True)
    images = np.random.default_rng(2).normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
    return size, variables, model.eval(), images


@pytest.fixture(params=["18", "50"])
def models(request):
    return _models(request.param)


def test_fold_is_bit_equal_to_the_reference(models):
    """float32 s = scale / sqrt(var + eps), b = bias - mean * s, k * s: each a
    correctly rounded IEEE operation in the same order, so equal bit for bit
    (OIHW against HWIO)."""
    size, variables, model, _ = models
    want = JI._fold_resnet(variables["params"]["encoder"], variables["batch_stats"]["encoder"],
                           size)
    got = TI._fold_resnet(model.encoder, size)
    assert list(got) == list(want) and len(got) == {"18": 20, "50": 53}[size]
    for key, (k, b) in want.items():
        np.testing.assert_array_equal(got[key][0].permute(2, 3, 1, 0).numpy(), k, err_msg=key)
        np.testing.assert_array_equal(got[key][1].numpy(), b, err_msg=key)


def test_f32_walk_matches_the_reference_and_the_eval_forward(models):
    """The float32 folded forward against the JAX one (the same folded
    weights; XLA's and oneDNN's convolutions sum in other orders: measured
    <= 8e-7 of the largest output) and against the port's own eval forward
    within 1e-4 of its scale, as tests/test_int8_infer.py holds the JAX
    walk to flax's."""
    size, variables, model, images = models
    want = jax.jit(JI.fold_encoder_f32(variables, size))(jnp.asarray(images))
    got = TI.fold_encoder_f32(model)(torch.from_numpy(images))
    for key in ("embedding", "projection"):
        b = np.asarray(want[key])
        assert got[key].shape == b.shape and got[key].dtype == torch.float32
        assert np.abs(got[key].numpy() - b).max() <= 1e-5 * np.abs(b).max(), key
    with torch.no_grad():
        emb, proj = model(torch.from_numpy(images))
    scale = float(emb.abs().max())
    assert float((got["embedding"] - emb).abs().max()) < 1e-4 * scale
    np.testing.assert_allclose(got["projection"].numpy(), proj.numpy(), rtol=1e-3, atol=1e-4)


def test_f32_walk_records_the_references_maxima(models):
    """``_CalibOps.maxes``: max|t| at every quantization point of the walk,
    the same sites as the JAX walk's (its calibration reads them), each
    within 1e-5 relative (the float32 walks agree to ~8e-7 of their
    outputs)."""
    size, variables, model, images = models
    fw = JI._fold_resnet(variables["params"]["encoder"], variables["batch_stats"]["encoder"],
                         size)

    def jax_maxes(x):
        ops = JI._CalibOps(fw)
        JI._walk_resnet(ops, size, x, pool=True)
        return ops.maxes

    want = jax.tree.map(float, jax.jit(jax_maxes)(jnp.asarray(images)))
    ops = TI._CalibOps(TI._fold_resnet(model.encoder, size))
    with torch.no_grad():
        TI._walk_resnet(ops, size, torch.from_numpy(images), pool=True)
    assert sorted(ops.maxes) == sorted(want)
    for key, value in want.items():
        assert float(ops.maxes[key]) == pytest.approx(value, rel=1e-5), key


def test_bf16_walk_matches_the_reference():
    """ResNet-50, side 64, B = 2, layer4_1/2 through the block (its plain
    version here) against the JAX walk with its Pallas block. Each
    convolution's float32 sum takes the bias and is rounded once, as the
    reference's ``preferred_element_type=float32`` convolution is; the sums
    run in another order, so an element can round to its other neighbour
    (the first such flip on this input is at layer2_0/conv2, one element),
    and 14 residual blocks carry the flips to the embedding: measured
    6.5e-3 of the largest element, held to 1e-2 (the walk that rounded each
    convolution twice measured 6.7e-3 here, held to 2e-2: the largest
    difference does not tell one rounding from two, the test below does),
    and a cosine above 0.99999 per row (measured 0.9999915; twice rounded
    0.99998). The port's walk with and without the block differs by conv3's
    rounding before the shortcut's add at two blocks: 1e-2 (measured
    2.3e-3; the JAX test allows 3e-2 between its two arms)."""
    _, variables, model, images = _models("50")
    x = torch.from_numpy(images)
    want = f32(JB.make_folded_encoder_bf16(variables, "50", pallas_blocks=BLOCKS)(
        jnp.asarray(images)))
    got = TB.make_folded_encoder_bf16(model, BLOCKS)(x)
    plain_walk = TB.make_folded_encoder_bf16(model)(x)
    assert got.shape == (B, 2048) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-2 * scale
    cos = (got.numpy() * want).sum(1) / np.linalg.norm(got.numpy(), axis=1) / np.linalg.norm(
        want, axis=1)
    assert (cos > 0.99999).all(), cos
    assert float((got - plain_walk).abs().max()) <= 1e-2 * scale


class _Recorder:
    """An ops object that hands every call to ``ops`` and keeps each
    result, with the op's name and site key."""

    def __init__(self, ops):
        self.ops, self.out = ops, []

    def __getattr__(self, name):
        fn = getattr(self.ops, name)

        def record(*args):
            y = fn(*args)
            if y is not None:
                self.out.append((name, args[0] if isinstance(args[0], str) else "", y))
            return y

        return record


def test_bf16_walk_rounds_once_per_convolution():
    """The walks op by op, ResNet-50 at side 64, B = 2: the input, the stem,
    the max pool, layer1's 13 ops and layer2_0/conv1 equal the JAX walk's in
    all but at most 0.1% of elements, each within one bf16 ulp (measured:
    bit-equal). A convolution that rounds its sum to bf16 before the float32
    bias and rounds again (the walk's earlier route) differs from the
    reference's in 14.2% of the stem's elements."""
    _, variables, model, images = _models("50")
    fw = JI._fold_resnet(variables["params"]["encoder"], variables["batch_stats"]["encoder"],
                         "50")
    want = _Recorder(JB.FoldedBf16Ops(fw))
    JI._walk_resnet(want, "50", jnp.asarray(images), pool=True)
    got = _Recorder(TB.FoldedBf16Ops(TI._fold_resnet(model.encoder, "50")))
    with torch.no_grad():
        TI._walk_resnet(got, "50", torch.from_numpy(images), pool=True)
    first = [name for _, name, _ in got.out].index("layer2_0/conv1") + 1
    assert len(got.out) == len(want.out) and first == 17
    for (op, key, a), (_, _, b) in zip(want.out[:first], got.out[:first]):
        a, b = torch.from_numpy(f32(a).copy()), b.float().permute(0, 2, 3, 1)
        _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
        diff = (a - b).abs()
        assert (diff <= torch.ldexp(torch.ones_like(a), e - 8)).all(), (op, key)
        assert float((diff > 0).float().mean()) <= 1e-3, (op, key)
