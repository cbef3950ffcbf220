"""The port's serving artifacts (``simhand_tpu_torch.serving.export``,
``.quant``) and its released-checkpoint loaders (``simhand_tpu_torch.hub``)
against the JAX package's on the CPU, at ResNet-18 and 32x32 (ResNet-50 for
``load_resnet50_simhand``). Weights are the JAX model's, carried over with
``convert.py``; inputs come from numpy's seeded normal.

What is held: weight-only int8 ``q`` and ``scale`` bit for bit against
``quantize_tree``; the float32 artifact for N = 1, 3, 5 equal to the model
and within rel 1e-5 of the JAX forward; the weight-only artifact under 0.35x
the float32 file's bytes with embeddings at min cosine > 0.999; foreign files
refused by both packages; ``export.main --pth`` in both packages on one
``.pth`` (detnet h_map, xyz and delta within 1e-4; the encoder's embedding
within rel 1e-4, its projection head keeping each package's own init);
``--checkpoint``; ``shard_over_devices`` over two CPU
copies; the hub's strict loads; and every entry point raising without a
card unless asked for the CPU.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JContrastiveModel
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel
from simhand_tpu_torch.serving import export as E
from simhand_tpu_torch.serving import quant as Q

torch.set_num_threads(4)
SIDE = 32


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, SIDE, SIDE, 3)).astype(np.float32)


def _stats(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _stats(v, rng, k) for k, v in tree.items()}
    if key == "mean":
        return (0.1 * rng.normal(size=tree.shape)).astype(np.float32)
    return (0.5 + rng.random(tree.shape)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                             * np.linalg.norm(b, axis=-1))))


@pytest.fixture(scope="module")
def enc18(tmp_path_factory):
    """The JAX ContrastiveModel-18 (statistics redrawn), the port's with its
    weights, and the port's float32 artifact of it."""
    jm = JContrastiveModel(resnet_size="18", dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0),
                                                  jnp.zeros((2, SIDE, SIDE, 3))))
    v = {"params": v["params"], "batch_stats": _stats(v["batch_stats"], np.random.default_rng(0))}
    model = ContrastiveModel("18").eval()
    model.load_state_dict(from_flax_variables(v["params"], v["batch_stats"]), strict=True)
    forward = E.build_encoder_forward(model)
    path = str(tmp_path_factory.mktemp("artifacts") / "enc_f32.pt2")
    E.save_artifact(path, E.export_forward(forward, side=SIDE, batch="poly"),
                    {"surface": "encoder", "backbone": "18", "side": SIDE})
    return {"jm": jm, "v": v, "model": model, "forward": forward, "path": path}


def _torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """A flax kernel in the port's layout: conv (kh, kw, I, O) -> (O, I, kh,
    kw), transposed conv -> (I, O, kh, kw) with its taps reversed, dense
    (I, O) -> (O, I)."""
    if arr.ndim == 2:
        return arr.T
    if name.startswith("deconv"):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


def test_quantize_variables_matches_quantize_tree(enc18):
    """Every quantized weight of the encoder (convolutions, dense layers)
    and of a detnet (transposed convolutions, 1x1 predictions) equal to the
    reference's q and scale bit for bit; the same set of layers quantized."""
    from simhand_tpu.finetune.detnet import DetNet as JDetNet
    from simhand_tpu.serving.quant import quantize_tree, quantized_size_fraction
    from simhand_tpu_torch.convert import detnet_from_flax_variables
    from simhand_tpu_torch.finetune.detnet import DetNet

    jdet = JDetNet(resnet_size="18", dtype=jnp.float32, hm_res=SIDE // 4)
    dv = jax.tree.map(np.asarray, jax.jit(jdet.init)(jax.random.key(1),
                                                    jnp.zeros((1, SIDE, SIDE, 3))))
    det = DetNet("18", hm_res=SIDE // 4)
    det.load_state_dict(detnet_from_flax_variables(dv["params"], dv["batch_stats"]),
                        strict=True)
    for variables, model in ((enc18["v"], enc18["model"]), (dv, det)):
        want = {}

        def walk(tree, path=()):
            for k, leaf in tree.items():
                if isinstance(leaf, dict) and set(leaf) == {"q", "scale"}:
                    want[path + (k,)] = leaf
                elif isinstance(leaf, dict):
                    walk(leaf, path + (k,))

        walk(quantize_tree(variables["params"]))
        qmodel = Q.quantize_variables(model)
        got = {name: m for name, m in qmodel.named_modules() if hasattr(m, "weight_q")}
        assert len(got) == len(want) > 0
        for path, leaf in want.items():
            name = path[-2]
            q = _torch_layout(name, leaf["q"])
            mods = [m for n, m in got.items() if tuple(m.weight_q.shape) == q.shape
                    and np.array_equal(m.weight_q.numpy(), q)]
            assert len(mods) >= 1, path
            np.testing.assert_array_equal(mods[0].weight_scale.numpy().ravel(), leaf["scale"])
        assert all(isinstance(m.weight, torch.Tensor) for m in got.values())
        assert all(isinstance(p, torch.nn.Parameter) for p in model.parameters())
        assert abs(Q.quantized_size_fraction(model)
                   - quantized_size_fraction(variables)) < 1e-3
    back = Q.dequantize_variables(Q.quantize_variables(enc18["model"]))
    conv = back.encoder.layer1[0].conv1
    assert isinstance(conv.weight, torch.nn.Parameter) and not hasattr(conv, "weight_q")


def test_float_artifact_serves_any_batch(enc18):
    """N = 1, 3, 5 from one artifact: equal to the model's eval forward, and
    within rel 1e-5 of the JAX forward on the same weights."""
    from simhand_tpu.serving import build_encoder_forward as j_build

    call, meta = E.load_artifact(enc18["path"], "cpu")
    assert meta["surface"] == "encoder" and meta["side"] == SIDE and "torch_version" in meta
    jf = jax.jit(j_build(enc18["v"], backbone="18", dtype=jnp.float32))
    for n in (1, 3, 5):
        x = _images(n, seed=n)
        got = call(x)
        with torch.no_grad():
            want = enc18["forward"](torch.from_numpy(x))
        ref = jf(jnp.asarray(x))
        for k in ("embedding", "projection"):
            assert got[k].shape == (n, 512 if k == "embedding" else 128)
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
            assert _rel(got[k], ref[k]) <= 1e-5, (n, k)


def test_weight_only_int8_artifact(enc18, tmp_path):
    """The weight-only int8 artifact stores int8: under 0.35x the float32
    file; its embedding at min cosine > 0.999 against the float32 forward
    and within rel 1e-5 of the reference's quantized export on the same
    weights, for N = 2 and 5."""
    from simhand_tpu.serving import encoder_apply as j_apply
    from simhand_tpu.serving import export_apply_quantized as j_quantized

    exported, qforward = E.export_apply_quantized(enc18["forward"], side=SIDE, batch="poly")
    assert isinstance(qforward.model.encoder.conv1, Q._DequantizedWeight)
    path = str(tmp_path / "enc_int8.pt2")
    E.save_artifact(path, exported, {"surface": "encoder", "side": SIDE, "quantize": "int8"})
    assert os.path.getsize(path) < 0.35 * os.path.getsize(enc18["path"])
    jexp, jweights = j_quantized(j_apply(backbone="18", dtype=jnp.float32), enc18["v"],
                                 side=SIDE, batch="poly", platforms=("cpu",))
    call, meta = E.load_artifact(path, "cpu")
    assert meta["quantize"] == "int8"
    for n in (2, 5):
        x = _images(n, seed=10 + n)
        got = call(x)
        with torch.no_grad():
            f32 = enc18["forward"](torch.from_numpy(x))
        ref = jexp.call(jweights, jnp.asarray(x))
        assert _min_cos(got["embedding"], f32["embedding"]) > 0.999
        for k in ("embedding", "projection"):
            assert _rel(got[k], ref[k]) <= 1e-5, (n, k)


def test_artifacts_refuse_each_others_files(enc18, tmp_path):
    from simhand_tpu.serving import load_artifact as j_load

    zipped = tmp_path / "not_an_artifact.pt2"
    zipped.write_bytes(b"PK\x03\x04 definitely a zip")
    jax_file = tmp_path / "jax.shlo"
    jax_file.write_bytes(b"SHTPU1\n" + b"\x00" * 16)
    for path in (zipped, jax_file):
        with pytest.raises(ValueError, match="not a simhand_tpu_torch serving artifact"):
            E.load_artifact(str(path), "cpu")
    with pytest.raises(ValueError, match="not a simhand_tpu serving"):
        j_load(enc18["path"])


def _jax_export_main(argv, variables, monkeypatch):
    """The reference's export.main. Its ``_init_variables`` initialises the
    model eagerly (tens of seconds for a detnet on a CPU) for ``--pth`` to replace
    (the encoder's head excepted); here it is handed the test's own
    variables of the same model instead."""
    from simhand_tpu.serving import export as JE

    monkeypatch.setattr(JE, "_init_variables", lambda *args: variables)
    JE.main(argv)


def test_export_main_detnet_pth_in_both_packages(tmp_path, capsys, monkeypatch):
    """One detnet .pth (the reference's writer) through both packages'
    export.main at float32 and 128x128 (the reference's main initialises its
    detnet at hm_res 32 before it loads the .pth, so it takes no other side):
    h_map, and xyz / delta (the location and delta maps at the heatmap
    argmax, where the uv agree) within 1e-4."""
    side = 128
    from simhand_tpu.finetune.detnet import DetNet as JDetNet
    from simhand_tpu.finetune.torch_port_detnet import detnet_to_torch_state_dict
    from simhand_tpu.serving import load_artifact as j_load

    jdet = JDetNet(resnet_size="18", dtype=jnp.float32, hm_res=side // 4)
    dv = jax.tree.map(np.asarray, jax.jit(jdet.init)(jax.random.key(2),
                                                    jnp.zeros((1, side, side, 3))))
    dv = {"params": dv["params"], "batch_stats": _stats(dv["batch_stats"],
                                                        np.random.default_rng(2))}
    pth = str(tmp_path / "detnet.pth")
    torch.save({k: torch.tensor(np.ascontiguousarray(v)) for k, v in
                detnet_to_torch_state_dict(dv["params"], dv["batch_stats"]).items()}, pth)
    flags = ["--surface", "detnet", "--backbone", "18", "--side", str(side), "--dtype", "f32",
             "--batch", "2", "--pth", pth]
    _jax_export_main(flags + ["--platforms", "cpu", "--out", str(tmp_path / "j.shlo")],
                     dv, monkeypatch)
    info = E.main(flags + ["--device", "cpu", "--out", str(tmp_path / "p.pt2")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == info
    assert info["surface"] == "detnet" and info["batch"] == 2
    jcall, _ = j_load(str(tmp_path / "j.shlo"))
    call, meta = E.load_artifact(str(tmp_path / "p.pt2"), "cpu")
    assert meta["quantize"] is None and meta["dtype"] == "f32"
    x = np.random.default_rng(5).normal(size=(2, side, side, 3)).astype(np.float32)
    got, want = call(x), jcall(jnp.asarray(x))
    assert set(got) == set(want) == {"h_map", "uv", "xyz", "delta"}
    np.testing.assert_allclose(got["h_map"].numpy(), np.asarray(want["h_map"]), rtol=0,
                               atol=1e-4)
    same = (got["uv"].numpy() == np.asarray(want["uv"])).all(-1)
    assert same.mean() > 0.9
    for k in ("xyz", "delta"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same], rtol=0,
                                   atol=1e-4)


def test_export_main_detnet_at_side_256(tmp_path):
    """The port's export.main exports a detnet at a side other than 128
    (the JAX package's main raises there; ``_init_variables`` states the
    departure): the artifact equals the module it was exported from, whose
    maps are 64x64."""
    side = 256
    flags = ["--surface", "detnet", "--backbone", "18", "--side", str(side), "--dtype", "f32",
             "--batch", "1", "--random_init", "--device", "cpu", "--out", str(tmp_path / "d.pt2")]
    info = E.main(flags)
    assert info["surface"] == "detnet" and info["batch"] == 1
    call, meta = E.load_artifact(str(tmp_path / "d.pt2"), "cpu")
    assert meta["side"] == side
    forward = E._init_variables("detnet", "18", side, torch.float32, torch.device("cpu")).eval()
    x = np.random.default_rng(8).normal(size=(1, side, side, 3)).astype(np.float32)
    got = call(x)
    with torch.no_grad():
        want = forward(torch.from_numpy(x))
    assert set(got) == set(want) == {"h_map", "uv", "xyz", "delta"}
    assert got["h_map"].shape == (1, side // 4, side // 4, 21)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_export_main_encoder_pth_in_both_packages(enc18, tmp_path, monkeypatch):
    """A torchvision-layout encoder .pth written by the reference
    (``save_torch_checkpoint``) through both packages' export.main: the
    embedding within rel 1e-4. The projection heads keep each package's own
    initialisation, so they are not compared."""
    from simhand_tpu.serving import load_artifact as j_load
    from simhand_tpu.train.torch_port import save_torch_checkpoint

    pth = str(tmp_path / "encoder.pth")
    save_torch_checkpoint(pth, enc18["v"]["params"]["encoder"],
                          enc18["v"]["batch_stats"]["encoder"])
    flags = ["--surface", "encoder", "--backbone", "18", "--side", str(SIDE), "--dtype", "f32",
             "--batch", "4", "--pth", pth]
    _jax_export_main(flags + ["--platforms", "cpu", "--out", str(tmp_path / "j.shlo")],
                     enc18["v"], monkeypatch)
    E.main(flags + ["--device", "cpu", "--out", str(tmp_path / "p.pt2")])
    jcall, _ = j_load(str(tmp_path / "j.shlo"))
    call, meta = E.load_artifact(str(tmp_path / "p.pt2"), "cpu")
    assert meta["batch"] == 4
    x = _images(4, seed=6)
    got = call(x)
    assert _rel(got["embedding"], jcall(jnp.asarray(x))["embedding"]) <= 1e-4
    with torch.no_grad():
        want = enc18["forward"](torch.from_numpy(x))["embedding"]
    torch.testing.assert_close(got["embedding"], want, rtol=0, atol=0)


def test_export_main_from_a_checkpoint_directory(enc18, tmp_path):
    """--checkpoint (the port's checkpoint directory, its latest step)
    exports the saved model; no weights flag is refused."""
    from simhand_tpu_torch.train.checkpoint import CheckpointManager
    from simhand_tpu_torch.train.optimizer import Optimizer, OptimizerConfig, decay_mask
    from simhand_tpu_torch.train.state import TrainState

    model = enc18["model"]
    state = TrainState(model, Optimizer(OptimizerConfig(), list(model.parameters()),
                                        decay_mask(model)))
    CheckpointManager(str(tmp_path / "ckpt")).save(3, state, {"contrastive_loss": 1.0})
    flags = ["--surface", "encoder", "--backbone", "18", "--side", str(SIDE), "--dtype", "f32",
             "--device", "cpu"]
    E.main(flags + ["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path / "c.pt2")])
    x = _images(2, seed=7)
    call, _ = E.load_artifact(str(tmp_path / "c.pt2"), "cpu")
    with torch.no_grad():
        want = enc18["forward"](torch.from_numpy(x))
    for k in ("embedding", "projection"):
        torch.testing.assert_close(call(x)[k], want[k], rtol=0, atol=0)
    with pytest.raises(SystemExit):
        E.main(flags + ["--out", str(tmp_path / "none.pt2")])


def test_shard_over_devices_on_two_cpu_copies(enc18):
    """Two copies of the program, each on half of the batch: equal to one;
    a batch that two do not divide is refused."""
    call, _ = E.load_artifact(enc18["path"], "cpu")
    sharded, n = E.shard_over_devices(call, ["cpu", "cpu"])
    assert n == 2
    x = _images(6, seed=8)
    got, want = sharded(x), call(x)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        sharded(_images(3))


def test_hub_loads_reference_and_released_state_dicts(enc18, tmp_path):
    """A state dict written by the reference's encoder_to_torch_state_dict
    loads into the port's ContrastiveModel with strict=True and gives JAX's
    embedding; a released-layout ResNet-50 file (with the classifier's fc
    keys) loads into load_resnet50_simhand's model."""
    from simhand_tpu.train.torch_port import encoder_to_torch_state_dict
    from simhand_tpu_torch.hub import load_encoder_into_contrastive, load_resnet50_simhand
    from simhand_tpu_torch.models.resnet import RESNETS

    v = enc18["v"]
    pth = str(tmp_path / "ref.pth")
    torch.save({k: torch.tensor(np.ascontiguousarray(a)) for k, a in encoder_to_torch_state_dict(
        v["params"]["encoder"], v["batch_stats"]["encoder"]).items()}, pth)
    model = load_encoder_into_contrastive(ContrastiveModel("18").eval(), pth)
    x = _images(2, seed=9)
    with torch.no_grad():
        emb, _ = model(torch.from_numpy(x))
    want, _ = enc18["jm"].apply(v, jnp.asarray(x), train=False)
    assert _rel(emb, want) <= 1e-5

    torch.manual_seed(1)
    released = RESNETS["50"]()
    sd = {**released.state_dict(), "fc.weight": torch.zeros(1000, 2048),
          "fc.bias": torch.zeros(1000)}
    torch.save(sd, str(tmp_path / "resnet50_simhand.pth"))
    loaded = load_resnet50_simhand(str(tmp_path / "resnet50_simhand.pth"), device="cpu")
    for k, t in loaded.state_dict().items():
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(enc18, tmp_path):
    from simhand_tpu_torch.hub import load_resnet50_simhand
    from simhand_tpu_torch.serving import embed, server

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = str(tmp_path / "x.pt2")
    calls = [
        lambda: E.main(["--surface", "encoder", "--backbone", "18", "--random_init",
                        "--out", out]),
        lambda: E.load_artifact(enc18["path"]),
        lambda: E.shard_over_devices(enc18["path"]),
        lambda: E.encoder_apply("18"),
        lambda: E.detnet_apply("18"),
        lambda: embed.main(["--artifact", enc18["path"], "--images", "*.png", "--out", out]),
        lambda: server.main(["--artifact", enc18["path"], "--port", "0"]),
        lambda: server.serve(enc18["path"], 0, 8, 5.0),
        lambda: load_resnet50_simhand(str(tmp_path / "missing.pth")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(out)
