"""The port's W8A8 serving path (``simhand_tpu_torch.serving.int8_infer``)
against the JAX package's (``simhand_tpu/serving/int8_infer.py``) on the CPU.

One module fixture: the JAX ``DetNet`` at ResNet-50, 64x64 (hm_res 16),
its BatchNorm statistics redrawn from a seed so that the fold does work,
carried into the port's ``DetNet`` with ``convert.detnet_from_flax_variables``;
the encoder surface is the same ResNet-50 with a projection head
(``ContrastiveModel``). Inputs: two images from numpy's seeded normal.

What is held:
- ``quantize_folded``: the int8 kernels, scales and biases bit for bit.
- The int8 walk with the reference's calibrated scales injected: every int8
  activation at every quantization point of the detnet (backbone and map
  heads) equal to JAX's, all 2,043,392 of them. XLA's CPU backend
  multiplies by the float32 reciprocal of a scale and contracts
  ``float32(y) * c + d`` into one fused multiply-add
  (``test_xla_cpu_epilogue_arithmetic``); the port computes both so
  (module docstring).
- The port's own calibration: scales within rel 1e-5 of JAX's; the int8
  embedding's min cosine > 0.995 and the projection's > 0.99 against the eval
  forward, the detnet within the reference test's limits
  (``tests/test_int8_infer.py:57-76``, ``:160-168``).
- ``fold_detnet_f32`` against JAX's and the eval forward, atol 1e-5, uv equal.
- ``export.main --quantize int8_compute`` (ResNet-18 at 32x32) for N = 1, 3, 5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.finetune.detnet import DetNet as JDetNet
from simhand_tpu.models.projection import ProjectionHead as JProjectionHead
from simhand_tpu.serving import int8_infer as J
from simhand_tpu_torch.convert import detnet_from_flax_variables, from_flax_variables
from simhand_tpu_torch.finetune.detnet import DetNet
from simhand_tpu_torch.models import ContrastiveModel
from simhand_tpu_torch.serving import int8_infer as P

torch.set_num_threads(4)
SIDE = 64


def _stats(tree, rng, key=None):
    """BatchNorm statistics away from the init's 0 / 1."""
    if isinstance(tree, dict):
        return {k: _stats(v, rng, k) for k, v in tree.items()}
    if key == "mean":
        return (0.1 * rng.normal(size=tree.shape)).astype(np.float32)
    return (0.5 + rng.random(tree.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    jdet = JDetNet(resnet_size="50", dtype=jnp.float32, hm_res=SIDE // 4)
    dv = jax.tree.map(np.asarray, jax.jit(jdet.init)(jax.random.key(0),
                                                    jnp.zeros((1, SIDE, SIDE, 3))))
    dv = {"params": dv["params"], "batch_stats": _stats(dv["batch_stats"], rng)}
    det = DetNet("50", hm_res=SIDE // 4).eval()
    det.load_state_dict(detnet_from_flax_variables(dv["params"], dv["batch_stats"]), strict=True)

    hv = jax.tree.map(np.asarray, JProjectionHead().init(jax.random.key(1),
                                                         jnp.zeros((2, 2048))))
    ev = {"params": {"encoder": dv["params"]["encoder"], "projection_head": hv["params"]},
          "batch_stats": {"encoder": dv["batch_stats"]["encoder"],
                          "projection_head": _stats(hv["batch_stats"], rng)}}
    enc = ContrastiveModel("50").eval()
    enc.load_state_dict(from_flax_variables(ev["params"], ev["batch_stats"]), strict=True)
    x = rng.normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
    calib = J.random_calibration_batches(side=SIDE, batch=4, n=2)
    return {"dv": dv, "det": det, "ev": ev, "enc": enc,
            "x": x, "calib": calib}


@pytest.fixture(scope="module")
def jax_detnet_int8(nets):
    forward, report = J.build_detnet_int8(nets["dv"], "50", calib_batches=nets["calib"],
                                          hm_res=SIDE // 4)
    return forward, report


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                             * np.linalg.norm(b, axis=-1))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_quantize_folded_matches_the_reference(nets):
    """The fold and its int8 quantization, backbone and map heads, bit for
    bit (the reference's HWIO kernels against the port's OIHW)."""
    p, s = nets["dv"]["params"], nets["dv"]["batch_stats"]
    want = J.quantize_folded({**J._fold_resnet(p["encoder"], s["encoder"], "50"),
                              **J._fold_detnet_heads(p, s)})
    got = P.quantize_folded(P._detnet_fold(nets["det"], "50"))
    assert got.keys() == want.keys() and len(got) == 56
    for key, (q, sw, b) in got.items():
        wq, wsw, wb = want[key]
        assert q.dtype == np.int8
        np.testing.assert_array_equal(q, wq.transpose(3, 2, 0, 1), err_msg=key)
        np.testing.assert_array_equal(sw, wsw, err_msg=key)
        np.testing.assert_array_equal(b, wb, err_msg=key)


class _RecordingOps(J._QuantOps):
    """The reference's int8 ops, recording every int8 activation."""

    seen: dict = {}

    def _requant(self, key, y):
        out = super()._requant(key, y)
        self.seen[key] = out[0]
        return out

    def conv_bn_relu(self, key, xq_s, stride, padding, out_f32=False):
        out = super().conv_bn_relu(key, xq_s, stride, padding, out_f32)
        if not out_f32:
            self.seen[key] = out[0]
        return out


def _record_port(module) -> dict:
    seen = {}
    ops = module.ops
    requant, conv = ops._requant, ops.conv_bn_relu

    def _requant(key, y, lo=-127):
        out = requant(key, y, lo)
        seen[key] = out[0]
        return out

    def conv_bn_relu(key, xq_s, stride, padding, out_f32=False):
        out = conv(key, xq_s, stride, padding, out_f32)
        if not out_f32:
            seen[key] = out[0]
        return out

    ops._requant, ops.conv_bn_relu = _requant, conv_bn_relu
    return seen


def test_xla_cpu_epilogue_arithmetic():
    """What the reference's epilogue computes on XLA's CPU backend, on
    numpy-seeded values: ``y / s`` as ``y * float32(1 / s)`` (not a true
    division) and ``float32(y32) * c + d`` as one fused multiply-add (not
    two roundings); the port's ``_QuantOps`` reproduces both."""
    rng = np.random.default_rng(0)
    y = (50 * rng.normal(size=1 << 16)).astype(np.float32)
    s = 0.0123456789
    got = np.asarray(jax.jit(lambda v: v / s)(y))
    np.testing.assert_array_equal(got, y * (np.float32(1) / np.float32(s)))
    assert (got != y / np.float32(s)).any()
    y32 = rng.integers(-2 ** 22, 2 ** 22, size=(512, 64)).astype(np.int32)
    c = (1e-4 * rng.random(64)).astype(np.float32)
    d = rng.normal(size=64).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: v.astype(jnp.float32) * c + d)(y32))
    fma = (y32.astype(np.float32).astype(np.float64) * c + d.astype(np.float64))
    np.testing.assert_array_equal(got, fma.astype(np.float32))
    assert (got != y32.astype(np.float32) * c + d).any()
    t = torch.from_numpy(y32)
    np.testing.assert_array_equal(
        P._fma(torch.from_numpy(d.astype(np.float64)), t,
               torch.from_numpy(c.astype(np.float64))).numpy(), got)


def test_int8_walk_with_the_references_scales(nets, jax_detnet_int8):
    """Every int8 activation of the detnet's walk (input, stem, every
    block's convolutions and output, the three heads' inputs) equal to the
    reference's under the same scales, bit for bit; the maps then within
    1e-5."""
    _, report = jax_detnet_int8
    p, s = nets["dv"]["params"], nets["dv"]["batch_stats"]
    fw = {**J._fold_resnet(p["encoder"], s["encoder"], "50"), **J._fold_detnet_heads(p, s)}
    ops = _RecordingOps(J.quantize_folded(fw), report["scales"])

    def walk(x):
        ops.seen = {}
        feats = J._walk_resnet(ops, "50", x, pool=False)
        out = J._detnet_tail(ops, p, s, feats, SIDE // 4, 21)
        return out, dict(ops.seen)

    want, want_seen = jax.jit(walk)(jnp.asarray(nets["x"]))
    port = P._int8_detnet(nets["det"], "50", report["scales"])
    seen = _record_port(port)
    with torch.no_grad():
        got = port(torch.from_numpy(nets["x"]))
    assert seen.keys() == want_seen.keys() and len(seen) == 53
    total = 0
    for key, q in seen.items():
        a, b = q.numpy(), np.asarray(want_seen[key])
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
        total += a.size
    assert total == 2_043_392
    for k in ("h_map", "d_map", "l_map", "xyz", "delta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["uv"].numpy(), np.asarray(want["uv"]))


def test_int8_encoder_with_the_references_scales(nets):
    """The encoder surface under the reference's calibrated scales: the
    embedding and the projection within rel 1e-5 of JAX's."""
    forward, report = J.build_encoder_int8(nets["ev"], "50", calib_batches=nets["calib"])
    want = jax.jit(forward)(jnp.asarray(nets["x"]))
    with torch.no_grad():
        got = P._int8_encoder(nets["enc"], report["scales"])(torch.from_numpy(nets["x"]))
    for k in ("embedding", "projection"):
        assert _rel(got[k], want[k]) <= 1e-5, k


def test_port_calibration_matches_the_reference(nets, jax_detnet_int8):
    """The port's float32 calibration: every scale within rel 1e-5 of
    JAX's, the encoder's and the detnet's; the encoder's int8 forward tracks
    the eval forward as the reference's test holds it."""
    _, jreport = J.build_encoder_int8(nets["ev"], "50", calib_batches=nets["calib"])
    forward, report = P.build_encoder_int8(nets["enc"], calib_batches=nets["calib"])
    assert report["scales"].keys() == jreport["scales"].keys() and report["sites"] == 50
    for k, v in report["scales"].items():
        assert abs(v - jreport["scales"][k]) <= 1e-5 * jreport["scales"][k], k
    _, det_report = P.build_detnet_int8(nets["det"], "50", calib_batches=nets["calib"])
    jdet = jax_detnet_int8[1]["scales"]
    assert det_report["scales"].keys() == jdet.keys()
    for k, v in det_report["scales"].items():
        assert abs(v - jdet[k]) <= 1e-5 * jdet[k], k
    x = torch.from_numpy(nets["x"])
    with torch.no_grad():
        emb, proj = nets["enc"](x)
        got = forward(x)
    assert _min_cos(got["embedding"], emb) > 0.995
    assert _min_cos(got["projection"], proj) > 0.99


def test_fold_detnet_f32_matches_the_reference_and_the_eval_forward(nets):
    jf = jax.jit(J.fold_detnet_f32(nets["dv"], "50", hm_res=SIDE // 4))(jnp.asarray(nets["x"]))
    got = P.fold_detnet_f32(nets["det"], "50")(torch.from_numpy(nets["x"]))
    with torch.no_grad():
        ev = nets["det"](torch.from_numpy(nets["x"]))
    for k in ("h_map", "d_map", "l_map", "xyz", "delta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jf[k]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), ev[k].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["uv"].numpy(), np.asarray(jf["uv"]))
    np.testing.assert_array_equal(got["uv"].numpy(), ev["uv"].numpy())


def test_build_detnet_int8_within_the_references_limits(nets):
    """The port's own calibrated W8A8 detnet against the float32 eval
    forward: h_map within 0.05, d_map / l_map within 0.05 * max(1, max|ref|),
    uv / xyz / delta finite (tests/test_int8_infer.py:160-168)."""
    forward, report = P.build_detnet_int8(nets["det"], "50", calib_batches=nets["calib"])
    assert report["sites"] > 50
    x = torch.from_numpy(nets["x"])
    with torch.no_grad():
        ref, got = nets["det"](x), forward(x)
    assert float((got["h_map"] - ref["h_map"]).abs().max()) < 0.05
    for k in ("d_map", "l_map"):
        limit = 0.05 * max(float(ref[k].abs().max()), 1.0)
        assert float((got[k] - ref[k]).abs().max()) < limit, k
    for k in ("uv", "xyz", "delta"):
        assert bool(got[k].float().isfinite().all()), k


def test_calibration_batches_are_the_references(tmp_path):
    """random_calibration_batches: numpy's draws, bit for bit;
    cache_calibration_batches: the reference's choice of crops through the
    serving preprocess (1e-5, as the preprocess itself)."""
    from simhand_tpu.serving.int8_infer import cache_calibration_batches as j_cache_batches
    from simhand_tpu_torch.data.cache import build_crop_cache
    from simhand_tpu_torch.data.sources.synthetic import SyntheticHandSource

    for got, want in zip(P.random_calibration_batches(side=16, batch=3, n=2, seed=4),
                         J.random_calibration_batches(side=16, batch=3, n=2, seed=4)):
        np.testing.assert_array_equal(got, want)
    cache = str(tmp_path / "cache")
    build_crop_cache(SyntheticHandSource(10, side=64, seed=3), cache, shard_size=4)
    got = P.cache_calibration_batches(cache, side=32, batch=4, n=2, device="cpu")
    want = j_cache_batches(cache, side=32, batch=4, n=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (4, 32, 32, 3) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_export_main_int8_compute_round_trip(tmp_path):
    """``export.main --random_init --quantize int8_compute`` (ResNet-18,
    32x32, calibrated on the default random batches): the artifact stores
    its kernels as int8, and N = 1, 3, 5 from it equal the W8A8 module built
    in memory from the same initialisation and batches."""
    from simhand_tpu_torch.serving import export as E
    from simhand_tpu_torch.train.state import init_weights

    path = str(tmp_path / "enc_int8.pt2")
    E.main(["--surface", "encoder", "--backbone", "18", "--side", "32", "--dtype", "f32",
            "--random_init", "--quantize", "int8_compute", "--device", "cpu", "--out", path])
    call, meta = E.load_artifact(path, "cpu")
    assert meta["quantize"] == "int8_compute" and meta["batch"] == "poly"
    int8 = [v for v in call.module.state_dict().values() if v.dtype == torch.int8]
    assert len(int8) == 20 and any(tuple(v.shape) == (64, 576) for v in int8)
    model = ContrastiveModel("18").eval()
    init_weights(model, torch.Generator().manual_seed(0))
    forward, _ = P.build_encoder_int8(model, P.random_calibration_batches(side=32))
    rng = np.random.default_rng(2)
    for n in (1, 3, 5):
        x = torch.from_numpy(rng.normal(size=(n, 32, 32, 3)).astype(np.float32))
        with torch.no_grad():
            want = forward(x)
        got = call(x)
        for k in ("embedding", "projection"):
            assert got[k].shape == want[k].shape
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
