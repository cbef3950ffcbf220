"""The port's demo and renderer (``simhand_tpu_torch.finetune.demo``,
``.render``) against the JAX package on the CPU.

What is held: the renderer's frames (``render_mesh_shaded``,
``render_mesh_panel``, ``draw_skeleton``), ``vertex_normals`` and
``view_matrix`` bit for bit; the per-frame function ``track_frame`` on both
shape routes against the JAX demo's loop body (One-Euro, ShapeNet or the
one-shot PSO, ``reconstruct``) on the same predictions; the demo CLI
(ResNet-18, 2 frames of a synthetic video) from a random init, a
``--pretrain`` .pth and an ``--artifact``, with and without
``--shape_net``, writing the 120 x 240 frame with its mesh panel;
``track_frame`` in a process where ``import cv2`` fails; the CLI raising
without a card unless asked for the CPU. JAX's demo itself is not run
again (``tests/test_mano.py`` runs it).
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mano as tm  # noqa: E402  (the synthetic MANO, both packages)
from simhand_tpu.finetune import demo as jdemo
from simhand_tpu.finetune import lm_fit as jlm
from simhand_tpu.finetune import recon as jrecon
from simhand_tpu.finetune import render as jrender
from simhand_tpu.finetune import shape_net as jsn
from simhand_tpu.finetune import smoother as jsmooth
from simhand_tpu_torch.finetune import demo as pdemo
from simhand_tpu_torch.finetune import render as prender

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
TETRA = (np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
         np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]))


@pytest.fixture(scope="module")
def params():
    return tm.synthetic_params()


@pytest.fixture(scope="module")
def jm(params):
    return tm.jmano.ManoModel(params=params)


@pytest.fixture(scope="module")
def pm(params):
    return tm.pmano.ManoModel(params=params, device="cpu")


@pytest.fixture(scope="module")
def mano_pkl(params, tmp_path_factory):
    path = tmp_path_factory.mktemp("mano") / "mano.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return str(path)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("video") / "in.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    rng = np.random.default_rng(0)
    for _ in range(3):
        w.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    w.release()
    return path


def mesh(jm):
    verts, _ = jm(jnp.broadcast_to(jnp.eye(3), (1, 16, 3, 3)), jnp.zeros((1, 10)))
    faces = np.random.default_rng(1).integers(0, 778, (400, 3))
    return np.asarray(verts[0]), faces


def test_renderer_bit_for_bit(jm):
    for verts, faces in (TETRA, mesh(jm)):
        np.testing.assert_array_equal(prender.vertex_normals(verts, faces),
                                      jrender.vertex_normals(verts, faces))
        for kw in ({}, {"azimuth_deg": 90.0}, {"azimuth_deg": 33.0, "elevation_deg": -20.0}):
            got = prender.render_mesh_shaded(verts, faces, 96, **kw)
            assert got.shape == (96, 96, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, jrender.render_mesh_shaded(verts, faces, 96, **kw))
    np.testing.assert_array_equal(prender.view_matrix(33, -20), jrender.view_matrix(33, -20))
    verts, faces = mesh(jm)
    for f in (faces, None):
        got = pdemo.render_mesh_panel(verts, f, 120)
        assert got.any()
        np.testing.assert_array_equal(got, jdemo.render_mesh_panel(verts, f, 120))
    uv = np.random.default_rng(2).uniform(0, 120, (21, 2))
    frame = np.random.default_rng(3).integers(0, 255, (120, 120, 3), dtype=np.uint8)
    got = pdemo.draw_skeleton(frame.copy(), uv)
    np.testing.assert_array_equal(got, jdemo.draw_skeleton(frame.copy(), uv))
    assert (got != frame).any()
    assert pdemo.BONES == jdemo.BONES


def stub_predictions(jm, n: int):
    """n frames of detnet outputs near the rest skeleton: xyz (1, 21, 3)
    float32 and uv (1, 21, 2) integers."""
    rest = tm.rest_joints(jm)
    rng = np.random.default_rng(4)
    return [{"xyz": (rest + rng.normal(scale=0.003, size=(21, 3)))[None].astype(np.float32),
             "uv": rng.integers(0, 32, (1, 21, 2))} for _ in range(n)]


@pytest.mark.parametrize("route", ["pso", "shape_net"])
def test_track_frame_matches_the_jax_demo_loop(jm, pm, route):
    """The JAX demo's per-frame body (demo.py's loop after the decode) on
    the same predictions: the smoother's xyz bit for bit, beta and verts
    within 1e-5."""
    preds = stub_predictions(jm, 3)
    fp = tm.flax_shape_net_params(0)
    frames = iter(preds)
    state = pdemo.DemoState(apply=lambda images: {k: torch.from_numpy(v)
                                                  for k, v in next(frames).items()},
                            mano=pm,
                            shape_net=tm.port_shape_net(fp) if route == "shape_net" else None)
    smoother = jsmooth.OneEuroFilter(mincutoff=1.0, beta=0.0)
    shape_smoother = jsmooth.OneEuroFilter(mincutoff=4.0, beta=0.0)
    beta = None
    for p in preds:
        xyz, uv, verts, got_beta = pdemo.track_frame(state, np.zeros((128, 128, 3), np.float32))
        want_xyz = smoother.process(np.asarray(p["xyz"])[0])
        np.testing.assert_array_equal(xyz, want_xyz)
        np.testing.assert_array_equal(uv, p["uv"][0])
        if route == "shape_net":
            bones = jlm.ref_bones_from_joints(want_xyz[None])
            beta = shape_smoother.process(np.asarray(jsn.ShapeNet().apply(
                {"params": fp}, jnp.asarray(bones, jnp.float32)))[0])
        want_verts, _, _, beta = jrecon.reconstruct(jm, want_xyz, beta=beta)
        np.testing.assert_allclose(got_beta, beta, rtol=0, atol=1e-5)
        assert verts.shape == (778, 3)
        assert tm.rel_largest(verts, want_verts) <= 1e-5


def export_artifact(path: str) -> None:
    from simhand_tpu_torch.serving import export

    export.main(["--surface", "detnet", "--backbone", "18", "--side", "128", "--dtype", "f32",
                 "--random_init", "--device", "cpu", "--out", path])


@pytest.mark.parametrize("source,shape_net", [("init", False), ("init", True),
                                              ("pretrain", True), ("artifact", False)])
def test_demo_cli(mano_pkl, video, tmp_path, capsys, source, shape_net):
    """The demo CLI on 2 frames: the center-cropped 120 x 120 frame and the
    mesh panel beside it (the synthetic MANO has no faces: a vertex
    scatter), from each model source; with ``--shape_net`` the JAX
    package's flax msgpack or the port's file."""
    from flax import serialization

    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.finetune.train import init_detnet
    from simhand_tpu_torch.train.checkpoint import export_state_dict

    flags = ["--video", video, "--backbone", "18", "--max_frames", "2", "--mano", mano_pkl,
             "--device", "cpu", "--out", str(tmp_path / "out.mp4")]
    if source == "pretrain":
        model = DetNet("18")
        init_detnet(model, 3)
        export_state_dict(model, str(tmp_path / "detnet.pth"))
        flags += ["--pretrain", str(tmp_path / "detnet.pth")]
    elif source == "artifact":
        export_artifact(str(tmp_path / "detnet.pt2"))
        flags += ["--artifact", str(tmp_path / "detnet.pt2")]
    if shape_net:
        fp = tm.flax_shape_net_params(0)
        if source == "init":
            path = tmp_path / "sn.msgpack"
            path.write_bytes(serialization.to_bytes(fp))
        else:
            path = tmp_path / "sn.pt"
            torch.save(tm.port_shape_net(fp).state_dict(), path)
        flags += ["--shape_net", str(path)]
    pdemo.main(flags)
    assert capsys.readouterr().out.strip().endswith("processed 2 frames")
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (120, 240, 3)
    assert frame[:, 120:].any()


def test_track_frame_needs_no_cv2(mano_pkl):
    """In a process where ``import cv2`` fails, the demo's per-frame route
    runs (the card's machine has no cv2), and ``main`` raises there."""
    script = textwrap.dedent(f"""
        import argparse, sys
        sys.modules["cv2"] = None
        import numpy as np
        from simhand_tpu_torch.finetune import demo
        from simhand_tpu_torch.finetune.mano import ManoModel
        args = argparse.Namespace(artifact=None, backbone="18", pretrain=None)
        state = demo.DemoState(apply=demo.load_detnet(args, "cpu"),
                               mano=ManoModel({mano_pkl!r}, device="cpu"))
        rng = np.random.default_rng(0)
        for _ in range(2):
            xyz, uv, verts, beta = demo.track_frame(
                state, rng.uniform(-0.5, 0.5, (128, 128, 3)).astype(np.float32))
            assert verts.shape == (778, 3) and np.isfinite(verts).all(), verts
        try:
            demo.main(["--device", "cpu", "--max_frames", "1"])
        except ImportError:
            print("no cv2; ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "no cv2; ok" in res.stdout


def test_demo_needs_a_card_unless_asked_for_the_cpu(mano_pkl, video):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdemo.main(["--video", video, "--backbone", "18", "--max_frames", "1",
                    "--mano", mano_pkl])
