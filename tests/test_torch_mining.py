"""The port's mining stage (``simhand_tpu_torch.mining``) against the JAX
package's on the CPU, at small sizes.

What is held: the distance plane of ``_chunk_distances`` bit for bit
against the jitted reference (XLA's CPU arithmetic: an FMA a joint, a
product with the float32 reciprocal of 21); ``mine_similar_hands`` on the
corpora of ``tests/test_mining.py`` at k = 1 and 3, in both
``single_program`` modes, distances bit for bit and indices equal; a corpus
of hands on the integer grid {0, 1, 2, 3}, copies of a few poses across
videos, where exact ties abound: the indices equal, the order of ties
included; a single-video corpus (-1 and +inf in both, ``attach_positives``
raising in both); ``video_ids_from_annotations`` in both layouts;
``run.main`` against the JAX package's on a synthetic corpus, byte for
byte; ``pair_grid``, ``visualize.main`` and ``extract_frames.main`` on the
three manifest formats equal to the JAX package's; progress printed in
both modes; ``run.main`` in a process where ``import cv2`` fails; a mesh
refused; the entry point raising without a card unless asked for the CPU.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from simhand_tpu.mining import run as jrun
from simhand_tpu.mining import similar_hands as jsh
from simhand_tpu_torch.mining import run as prun
from simhand_tpu_torch.mining import similar_hands as psh

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
# (seed, N, videos, query_chunk, db_chunk) of tests/test_mining.py: chunks
# that divide N, a ragged N = 57, and N = 48 in one query chunk of 16
CORPORA = [(0, 64, 6, 16, 16), (7, 57, 5, 10, 16), (9, 48, 6, 16, 16)]


def _corpus(seed, n, videos):
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 1, size=(n, 21, 2)).astype(np.float32)
    return kp, rng.integers(0, videos, size=n).astype(np.int32)


def _tie_corpus(seed, n, poses, videos):
    """Hands on the integer grid {0, 1, 2, 3}: n copies of ``poses``
    distinct poses spread over videos, so each query meets exact ties."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=(poses, 21, 2)).astype(np.float32)
    return base[rng.integers(0, poses, size=n)], rng.integers(0, videos, size=n).astype(np.int32)


def _assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_chunk_distances_bit_equal_to_xla():
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 1, size=(256, 21, 2)).astype(np.float32)
    db = rng.uniform(0, 1, size=(512, 21, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jsh._chunk_distances)(q, db))
    got = psh._chunk_distances(torch.from_numpy(q), torch.from_numpy(db))
    assert got.dtype == torch.float32
    _assert_bits_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("seed,n,videos,query_chunk,db_chunk", CORPORA)
def test_mine_similar_hands_equals_jax(seed, n, videos, query_chunk, db_chunk, k):
    kp, vids = _corpus(seed, n, videos)
    for single in (True, False):
        want_d, want_i = jsh.mine_similar_hands(kp, vids, k=k, query_chunk=query_chunk,
                                                db_chunk=db_chunk, single_program=single)
        got_d, got_i = psh.mine_similar_hands(kp, vids, k=k, query_chunk=query_chunk,
                                              db_chunk=db_chunk, single_program=single,
                                              device="cpu")
        _assert_bits_equal(got_d, np.asarray(want_d, np.float32))
        assert got_i.dtype == np.int32
        np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("single", [True, False])
def test_progress_prints_the_queries_queued(single, capsys):
    """Both ``single_program`` values run one loop, which prints the
    queries queued when asked (the CLI asks)."""
    kp, vids = _corpus(7, 57, 5)
    psh.mine_similar_hands(kp, vids, query_chunk=20, db_chunk=16, single_program=single,
                           progress=True, device="cpu")
    assert capsys.readouterr().out.split("\n") == [
        "dispatched 20/57", "dispatched 40/57", "dispatched 57/57", ""]


def test_ties_keep_the_references_order():
    """Ragged chunks on both axes; ties inside a chunk and across the
    running best and a chunk (a lower index first)."""
    kp, vids = _tie_corpus(1, 300, 40, 12)
    want_d, want_i = jsh.mine_similar_hands(kp, vids, k=3, query_chunk=70, db_chunk=96)
    got_d, got_i = psh.mine_similar_hands(kp, vids, k=3, query_chunk=70, db_chunk=96,
                                          device="cpu")
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    _assert_bits_equal(got_d, np.asarray(want_d))
    # the corpus does exercise ties: equal distances within many rows
    assert int((np.diff(got_d, axis=1) == 0).sum()) > 100


def test_single_video_corpus_has_no_candidates_in_both_packages():
    kp, _ = _corpus(2, 20, 1)
    vids = np.zeros(20, np.int32)
    want_d, want_i = jsh.mine_similar_hands(kp, vids, k=2, query_chunk=8, db_chunk=8)
    got_d, got_i = psh.mine_similar_hands(kp, vids, k=2, query_chunk=8, db_chunk=8,
                                          device="cpu")
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    assert (got_i == -1).all() and np.isposinf(got_d).all()
    annotations = [{"hand_id": n} for n in range(20)]
    with pytest.raises(ValueError, match="no valid cross-video candidate"):
        jsh.attach_positives([dict(a) for a in annotations], want_d, want_i)
    with pytest.raises(ValueError, match="no valid cross-video candidate"):
        psh.attach_positives([dict(a) for a in annotations], got_d, got_i)


def test_video_ids_from_annotations_in_both_layouts():
    images = [
        {"id": 0, "file_name": "frames/vidA/frame_000000.jpg"},
        {"id": 1, "file_name": "frames/vidA/frame_000030.jpg"},
        {"id": 2, "file_name": "frames/vidB/frame_000000.jpg"},
        {"id": 3, "file_name": "frames/100DOH/video007_frame000004.jpg"},
        {"id": 4, "file_name": "frames/100DOH/video007_frame000012.jpg"},
        {"id": 5, "file_name": "frames/100DOH/video002_frame000012.jpg"},
        {"id": 6, "file_name": "lonely.jpg"},
    ]
    annotations = [{"image_id": i} for i in range(7)] + [{"image_id": 0, "video_id": "x"}]
    got = prun.video_ids_from_annotations(images, annotations)
    want = jrun.video_ids_from_annotations(images, annotations)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] != got[2] and got[3] == got[4] != got[5]


@pytest.fixture(scope="module")
def unpaired(tmp_path_factory):
    """A synthetic Hand100M corpus (the JAX package's generator) and its
    annotation JSON with the pairs stripped."""
    from simhand_tpu.data.sources import generate_synthetic_hand100m

    root = tmp_path_factory.mktemp("h100m")
    anno = generate_synthetic_hand100m(str(root / "corpus"), num_images=32, num_videos=4,
                                       side=64, scale="smoke")
    with open(anno) as f:
        data = json.load(f)
    for a in data["annotations"]:
        a["positive_sample"] = []
        a["distance"] = []
    path = root / "unpaired.json"
    path.write_text(json.dumps(data))
    return root, path


def test_run_main_writes_the_jax_packages_file(unpaired, tmp_path, capsys):
    _, src = unpaired
    flags = ["--input", str(src), "--k", "2", "--query_chunk", "8", "--db_chunk", "16"]
    jrun.main(flags + ["--output", str(tmp_path / "jax.json")])
    prun.main(flags + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("(32 annotations, k=2)")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    # --shard_db changes nothing on one device
    prun.main(flags + ["--output", str(tmp_path / "ring.json"), "--device", "cpu",
                       "--shard_db"])
    assert (tmp_path / "ring.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_run_main_needs_no_cv2(unpaired, tmp_path):
    """In a process where ``import cv2`` fails, the mining CLI runs and
    writes the file it writes here."""
    _, src = unpaired
    flags = ["--input", str(src), "--k", "1", "--query_chunk", "8", "--db_chunk", "16",
             "--device", "cpu"]
    prun.main(flags + ["--output", str(tmp_path / "here.json")])
    script = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        from simhand_tpu_torch.mining import run
        run.main({flags + ["--output", str(tmp_path / "there.json")]!r})
        try:
            import cv2
        except ImportError:
            print("no cv2; ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "no cv2; ok" in res.stdout
    assert (tmp_path / "there.json").read_bytes() == (tmp_path / "here.json").read_bytes()


def test_pair_grid_and_visualize_main_equal_jax(unpaired, tmp_path):
    from simhand_tpu.data.sources import Hand100MSource as JSource
    from simhand_tpu.mining import visualize as jvis
    from simhand_tpu_torch.data.sources import Hand100MSource
    from simhand_tpu_torch.mining import visualize as pvis

    root, _ = unpaired
    corpus = str(root / "corpus")
    kw = dict(source="100doh", scale="smoke")
    want = jvis.pair_grid(JSource(corpus, **kw), n=2, cell=32, seed=4)
    got = pvis.pair_grid(Hand100MSource(corpus, **kw), n=2, cell=32, seed=4)
    assert got.shape == (64, 128, 3) and got.dtype == np.uint8 and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    flags = ["--root", corpus, "--source", "100doh", "--scale", "smoke", "--n", "3"]
    jvis.main(flags + ["--out", str(tmp_path / "j.jpg")])
    pvis.main(flags + ["--out", str(tmp_path / "p.jpg")])
    assert (tmp_path / "p.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()


def test_extract_frames_main_equals_jax_on_three_manifest_formats(tmp_path):
    import cv2

    from simhand_tpu.mining.extract_frames import main as jmain
    from simhand_tpu_torch.mining.extract_frames import main as pmain

    vdir = tmp_path / "videos"
    vdir.mkdir()
    rng = np.random.default_rng(0)
    for name, frames in (("vid-a", 5), ("vid-b", 3), ("vid-c", 4)):
        w = cv2.VideoWriter(str(vdir / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                            (32, 32))
        for _ in range(frames):
            w.write(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        w.release()
    manifests = {
        "ego4d": "Number Name Size Length Width Height OFC SFC OFR SFR Time\n"
                 "0 vid-a.mp4 96188270 378.22 1440 1080 11346 378 30.0 1.0 0.22\n"
                 "1 missing-vid.mp4 1 1.0 1 1 1 1 30.0 1.0 0.0\n",
        "100doh": "vid-b 0 0 1280x720 30/1\nvid-a 0 0 1280x720 30/1\n",
        "bare": "vid-c\nmissing\n",
    }
    for kind, text in manifests.items():
        manifest = tmp_path / f"{kind}.txt"
        manifest.write_text(text)
        outs = {}
        for pkg, main in (("jax", jmain), ("port", pmain)):
            out = tmp_path / f"{kind}_{pkg}"
            main(["--manifest", str(manifest), "--video_dir", str(vdir), "--out_dir", str(out),
                  "--stride", "2"])
            outs[pkg] = {str(p.relative_to(out)): p.read_bytes()
                         for p in sorted(out.rglob("*.jpg"))}
        assert outs["port"] == outs["jax"] and len(outs["port"]) >= 2, kind


def test_a_mesh_is_refused_and_shard_db_needs_one():
    """Sharded mining is ported (tests/test_torch_sharded_mining.py holds it
    against JAX's): a mesh is no longer refused, and a one-rank mesh gives
    one device's result in each mode; shard_db without a mesh raises in both
    packages."""
    from torch_thread_axis import ThreadAxis, ThreadGroup

    kp, vids = _corpus(0, 16, 4)
    want = psh.mine_similar_hands(kp, vids, query_chunk=4, db_chunk=8, device="cpu")
    for single, ring in ((True, False), (False, False), (True, True)):
        got = psh.mine_similar_hands(kp, vids, query_chunk=4, db_chunk=8, device="cpu",
                                     mesh=ThreadAxis(ThreadGroup(1), 0),
                                     single_program=single, shard_db=ring)
        _assert_bits_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="requires a mesh"):
        psh.mine_similar_hands(kp, vids, shard_db=True, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        jsh.mine_similar_hands(kp, vids, shard_db=True)


def test_mining_needs_a_card_unless_asked_for_the_cpu(unpaired, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kp, vids = _corpus(0, 16, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.mine_similar_hands(kp, vids)
    _, src = unpaired
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prun.main(["--input", str(src), "--output", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()
