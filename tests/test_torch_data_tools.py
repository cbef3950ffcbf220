"""The port's data tools against the JAX package's on the CPU: the
integrity scanner (``data/validate.py``), the YouTube3DHands source
(``data/sources/youtube.py``) and the worker-process loader
(``data/grain_loader.py``, which needs no ``grain``).

What is held: ``scan_source`` and ``validate.main`` on a synthetic corpus
with a corrupt frame and a non-finite keypoint, the same findings and the
same CSV bytes; ``YoutubeSource`` samples, right and left hands, bit for
bit; both pre-training entry points refusing the YouTube source;
``grain_batch_iterator`` in this process against the JAX package's (grain's
``DataLoader``) for the host and the raw routes, each sample bit for bit and
the set of samples in each epoch and each of two shards equal to grain's;
with two worker processes, on the host-augment and the raw routes, the
in-process batches bit for bit where no worker drops a remainder, and grain's count of samples where each does
(grain batches each worker's share); a worker that dies raising in the
caller, not hanging it.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import pytest

from simhand_tpu.data.augment_cv2 import AugmentFlags as JFlags
from simhand_tpu.data.augment_cv2 import AugmentParams as JParams
from simhand_tpu.data.pipeline import PretrainDataset as JDataset
from simhand_tpu.data.sources import Hand100MSource as JSource
from simhand_tpu.data.sources import generate_synthetic_hand100m as jgenerate
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.grain_loader import _epoch_batches, grain_batch_iterator
from simhand_tpu_torch.data.pipeline import PretrainDataset
from simhand_tpu_torch.data.sources import Hand100MSource

cv2 = pytest.importorskip("cv2")
N, VIDEOS = 24, 4
KW = dict(source="100doh", scale="smoke")
# small views keep the host chain quick; the JAX package's parameters else
PARAMS = dict(resize_shape=(48, 48))
FLAGS = dict(crop=True, resize=True, rotate=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hand100m"))
    jgenerate(root, num_images=N, num_videos=VIDEOS, side=256)
    return root


@pytest.fixture
def broken_corpus(tmp_path):
    """A corpus whose frame 3 is not an image and whose annotation 5 holds a
    NaN keypoint."""
    root = str(tmp_path / "broken")
    anno = jgenerate(root, num_images=12, num_videos=3, side=128)
    with open(anno) as f:
        data = json.load(f)
    frame = os.path.join(root, data["images"][3]["file_name"])
    with open(frame, "wb") as f:
        f.write(b"not a jpeg")
    data["annotations"][5]["keypoint_25d"][4] = float("nan")
    with open(anno, "w") as f:
        json.dump(data, f)
    return root


def test_scan_source_and_validate_main_equal_jax(corpus, broken_corpus, tmp_path, capsys):
    from simhand_tpu.data import validate as jval
    from simhand_tpu_torch.data import validate as pval

    n, bad = pval.scan_source(Hand100MSource(corpus, **KW), limit=8)
    assert (n, bad) == (8, []) == jval.scan_source(JSource(corpus, **KW), limit=8)

    def broken(src):
        class _Broken:
            def __len__(self):
                return 3

            def __getitem__(self, i):
                if i == 1:
                    raise IOError("corrupt")
                s = src[i]
                if i == 2:
                    s["joints3D"] = s["joints3D"] * np.nan
                return s

        return _Broken()

    got = pval.scan_source(broken(Hand100MSource(corpus, **KW)))
    assert got == jval.scan_source(broken(JSource(corpus, **KW)))
    assert got[0] == 3 and [i for i, _ in got[1]] == [1, 2]
    assert "load_error" in got[1][0][1] and got[1][1][1] == "non_finite_joints"

    flags = ["--root", broken_corpus, "--source", "100doh", "--scale", "smoke"]
    jval.main(flags + ["--out", str(tmp_path / "j.csv")])
    pval.main(flags + ["--out", str(tmp_path / "p.csv")])
    assert capsys.readouterr().out.splitlines()[-1].startswith("checked 12 samples: 2 invalid")
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    with open(tmp_path / "p.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == ["index", "3", "5"]
    assert rows[1][1].startswith("load_error") and rows[2][1] == "non_finite_joints"


def test_youtube_source_equals_jax(tmp_path):
    from simhand_tpu.data.sources.youtube import YoutubeSource as JYoutube
    from simhand_tpu.finetune.mano import TIP_VERTEX_IDS as JTIPS
    from simhand_tpu_torch.core.joints import TIP_VERTEX_IDS
    from simhand_tpu_torch.data.sources.youtube import YoutubeSource

    assert TIP_VERTEX_IDS == JTIPS
    rng = np.random.default_rng(1)
    verts = rng.uniform(-0.1, 0.1, (778, 3))
    data = {
        "images": [{"id": 7, "name": "frames/f0.jpg"}, {"id": 8, "name": "frames/f1.jpg"}],
        "annotations": [{"id": 0, "image_id": 7, "vertices": verts.tolist()},
                        {"id": 1, "image_id": 8, "vertices": (verts * 2).tolist(),
                         "is_left": 1}],
    }
    (tmp_path / "frames").mkdir()
    for name, shape in (("f0", (64, 64, 3)), ("f1", (48, 80, 3))):
        cv2.imwrite(str(tmp_path / "frames" / f"{name}.jpg"),
                    rng.integers(0, 255, shape, dtype=np.uint8))
    (tmp_path / "youtube_train.json").write_text(json.dumps(data))
    reg = rng.uniform(0, 1, (16, 778)).astype(np.float32)
    reg /= reg.sum(1, keepdims=True)
    got_src = YoutubeSource(str(tmp_path), "train", mano_regressor=reg)
    want_src = JYoutube(str(tmp_path), "train", mano_regressor=reg)
    assert len(got_src) == len(want_src) == 2
    for i in range(2):
        got, want = got_src[i], want_src[i]
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, np.ndarray):
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert got[k] == w, k
    # the left hand is mirrored
    np.testing.assert_array_equal(got_src[1]["image"],
                                  cv2.cvtColor(cv2.imread(str(tmp_path / "frames/f1.jpg")),
                                               cv2.COLOR_BGR2RGB)[:, ::-1])
    for cls in (YoutubeSource, JYoutube):
        with pytest.raises(ValueError, match="J_regressor"):
            cls(str(tmp_path), "train")


def test_both_entry_points_refuse_the_youtube_source(tmp_path):
    from simhand_tpu.experiments.main import build_sources as jbuild
    from simhand_tpu_torch.experiments.main import build_sources

    args = argparse.Namespace(data_dir=str(tmp_path), datasets_scale=None,
                              sources=["youtube"], cache_size=None)
    for build in (jbuild, build_sources):
        with pytest.raises(NotImplementedError, match="youtube"):
            build(args, None)


def _datasets(root, experiment_type):
    jds = JDataset(JSource(root, **KW), experiment_type, JFlags(**FLAGS), JParams(**PARAMS),
                   seed=5)
    pds = PretrainDataset(Hand100MSource(root, **KW), experiment_type, AugmentFlags(**FLAGS),
                          AugmentParams(**PARAMS), seed=5)
    return jds, pds


def _by_sample(batches, key):
    """Each sample of the batches, keyed by the bytes of one of its fields
    (the synthetic frames are distinct, so the key names the sample)."""
    out = {}
    for b in batches:
        for r in range(len(b[key])):
            out[b[key][r].tobytes()] = {k: v[r] for k, v in b.items()}
    return out


def _assert_same_samples(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].keys() == w.keys()
        for field in w:
            assert got[key][field].dtype == w[field].dtype, field
            np.testing.assert_array_equal(got[key][field], w[field], err_msg=field)


@pytest.mark.parametrize("raw", [False, True], ids=["host", "raw"])
def test_grain_batch_iterator_in_process_equals_grains(corpus, raw):
    """Each epoch (0 and 1) and each of two shards: the set of samples
    equals grain's and each sample equals it bit for bit. Batch 4 divides
    the 24 records and the 12 of a shard, so grain drops nothing."""
    pytest.importorskip("grain")
    from simhand_tpu.data.grain_loader import grain_batch_iterator as jgrain

    jds, pds = _datasets(corpus, "simhand_w" if raw else "simclr")
    key = "image1" if raw else "transformed_image1"
    for epoch, shard_index, shard_count in ((0, 0, 1), (1, 0, 1), (1, 0, 2), (1, 1, 2)):
        kw = dict(batch_size=4, seed=3, epoch=epoch, num_workers=0, raw=raw,
                  shard_index=shard_index, shard_count=shard_count)
        want = list(jgrain(jds, **kw))
        got = list(grain_batch_iterator(pds, **kw))
        assert len(got) == len(want) == N // shard_count // 4
        assert all(len(b[key]) == 4 for b in got)
        _assert_same_samples(_by_sample(got, key), _by_sample(want, key))


def _two_workers_hold_the_in_process_samples(corpus, raw):
    _, pds = _datasets(corpus, "simhand_w" if raw else "simclr")
    key = "image1" if raw else "transformed_image1"
    t0 = time.perf_counter()
    inproc = list(grain_batch_iterator(pds, 4, seed=2, epoch=1, num_workers=0, raw=raw))
    forked = list(grain_batch_iterator(pds, 4, seed=2, epoch=1, num_workers=2, raw=raw))
    assert len(forked) == len(inproc) == 6
    _assert_same_samples(_by_sample(forked, key), _by_sample(inproc, key))
    per_worker = list(grain_batch_iterator(pds, 8, seed=2, num_workers=2, raw=raw))
    assert sum(len(b[key]) for b in per_worker) == 16 == 2 * (12 // 8) * 8
    assert len(_by_sample(per_worker, key)) == 16
    assert sum(map(len, _epoch_batches(N, 8, num_workers=0))) == 24
    assert time.perf_counter() - t0 < 120


def test_grain_batch_iterator_in_worker_processes(corpus):
    """Two fork-server workers under a deadline, on the raw route. Batch 4:
    each worker's 12 records divide, so the batches hold the in-process
    samples bit for bit. Batch 8: each worker drops 4 of its 12 (grain
    batches each worker's share), 16 samples as grain gives; in process
    all 24."""
    _two_workers_hold_the_in_process_samples(corpus, raw=True)


def test_grain_batch_iterator_host_route_in_worker_processes(corpus):
    """The same on the host-augment route: ``PretrainDataset.__getitem__(i,
    epoch)`` in a worker gives the in-process sample bit for bit."""
    _two_workers_hold_the_in_process_samples(corpus, raw=False)


def _helper_processes() -> set[str]:
    """Which of multiprocessing's helpers run as children of this process."""
    found = set()
    for entry in os.listdir("/proc"):
        try:
            stat = open(f"/proc/{entry}/stat").read() if entry.isdigit() else ""
            if stat and int(stat[stat.rindex(")") + 2:].split()[1]) == os.getpid():
                cmdline = open(f"/proc/{entry}/cmdline").read()
                found |= {h for h in ("forkserver", "resource_tracker")
                          if f"multiprocessing.{h}" in cmdline}
        except OSError:
            continue
    return found


def test_stop_worker_server_leaves_no_process(corpus):
    """After a loader with workers the fork server and the resource tracker
    still run; ``stop_worker_server`` ends both, and a later loader starts
    them again."""
    from simhand_tpu_torch.data.grain_loader import stop_worker_server

    _, pds = _datasets(corpus, "simhand_w")
    want = list(grain_batch_iterator(pds, 4, seed=2, num_workers=0, raw=True))
    for _ in range(2):
        got = list(grain_batch_iterator(pds, 4, seed=2, num_workers=1, raw=True))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_samples({0: g}, {0: w})
        assert _helper_processes() == {"forkserver", "resource_tracker"}
        stop_worker_server()
        assert _helper_processes() == set()


def test_a_worker_that_dies_raises_in_the_caller():
    from torch_loader_workers import DiesInTheWorker

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(grain_batch_iterator(DiesInTheWorker(), 2, num_workers=1, raw=True))
    assert time.perf_counter() - t0 < 60
