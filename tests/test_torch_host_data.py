"""The port's host data layer (``simhand_tpu_torch.data``: the Hand100M
annotations and source, the crops, the concat, the host augmenter and the
host route of the pipeline) against the JAX package on the CPU.

The JAX package writes a synthetic Hand100M corpus (``cv2`` is here); both
packages read it, and everything compared is exact: the port keeps the JAX
package's code paths and draws from the same ``numpy`` generators in the
same order, so a seed gives the same bits.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from simhand_tpu.data import annotations as jann
from simhand_tpu.data import crops as jcrops
from simhand_tpu.data.augment_cv2 import AugmentFlags as JFlags
from simhand_tpu.data.augment_cv2 import AugmentParams as JParams
from simhand_tpu.data.augment_cv2 import HostAugmenter as JAugmenter
from simhand_tpu.data.concat import ConcatSource as JConcat
from simhand_tpu.data.pipeline import PretrainDataset as JDataset
from simhand_tpu.data.pipeline import batch_iterator as jbatches
from simhand_tpu.data.sources import Hand100MSource as JSource
from simhand_tpu.data.sources import generate_synthetic_hand100m as jgenerate
from simhand_tpu.data.sources.hand100m import crop_and_resize_box as jcrop_box
from simhand_tpu_torch.data import annotations as ann
from simhand_tpu_torch.data import crops
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams, HostAugmenter
from simhand_tpu_torch.data.concat import ConcatSource
from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
from simhand_tpu_torch.data.sources import Hand100MSource
from simhand_tpu_torch.data.sources.hand100m import crop_and_resize_box

pytest.importorskip("cv2")
N, VIDEOS = 24, 4
FLAGS = [f.name for f in dataclasses.fields(AugmentFlags)]
EXPERIMENT_TYPES = ("simclr", "simclr_w", "peclr", "peclr_w", "simhand-base", "simhand",
                    "simhand_w", "simhand_vis")
# small views keep the host chain quick; the JAX package's parameters else
PARAMS = dict(resize_shape=(48, 48))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two JAX synthetic corpora (24 and 10 frames, other seeds) and the
    JAX and port sources over each."""
    root = tmp_path_factory.mktemp("hand100m")
    jgenerate(str(root / "a"), num_images=N, num_videos=VIDEOS, side=256)
    jgenerate(str(root / "b"), num_images=10, num_videos=2, side=200, seed=3)
    kw = dict(source="100doh", scale="smoke")
    return root, [(JSource(str(root / d), **kw), Hand100MSource(str(root / d), **kw))
                  for d in ("a", "b")]


def assert_samples_equal(got: dict, want: dict, what=""):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, (what, k)
            assert np.array_equal(g, w), (what, k)
        else:
            assert type(g) is type(w) and g == w, (what, k)


def test_annotations_match(corpus, tmp_path):
    root, _ = corpus
    for source, scale in (("ego4d", "1m"), ("100doh", "smoke"), ("Ego4D", "2m")):
        assert ann.annotation_path("r", source, scale) == jann.annotation_path("r", source, scale)
    path = ann.annotation_path(str(root / "a"), "100doh", "smoke")
    got, want = ann.load_hand100m(path), jann.load_hand100m(path)
    assert len(got) == len(want) == N
    assert got.image_by_id == want.image_by_id
    assert got.index_by_hand_id == want.index_by_hand_id
    for i in range(N):
        assert got.positive_index(i) == want.positive_index(i)
        assert np.array_equal(got.keypoints(i), want.keypoints(i))
        assert np.array_equal(got.boxes(i), want.boxes(i))
    # the writer: numpy scalars and arrays serialise as the JAX writer's
    images = [{"id": np.int64(0), "file_name": "f.jpg", "width": 4, "height": 4}]
    annos = [{"image_id": 0, "hand_id": np.int32(7), "boxes": np.arange(4.0),
              "keypoint_25d": np.zeros(63, np.float32), "left_right": "Left",
              "positive_sample": [7], "distance": [np.float32(0.5)]}]
    ann.write_hand100m(str(tmp_path / "p" / "a.json"), images, annos)
    jann.write_hand100m(str(tmp_path / "j" / "a.json"), images, annos)
    assert (tmp_path / "p" / "a.json").read_bytes() == (tmp_path / "j" / "a.json").read_bytes()
    with pytest.raises(ValueError, match="duplicate"):
        ann.Hand100MAnnotations(images=images, annotations=annos + annos)


@pytest.mark.parametrize("crop_size", [224, 160])
def test_hand100m_samples_match(corpus, crop_size):
    """Every sample of both corpora: the crop (int truncations kept), the
    left-hand flip, the pseudo depth, the positives."""
    root, pairs = corpus
    for d, (want_src, _) in zip("ab", pairs):
        got_src = Hand100MSource(str(root / d), source="100doh", scale="smoke",
                                 crop_size=crop_size)
        want_src = JSource(str(root / d), source="100doh", scale="smoke", crop_size=crop_size)
        assert len(got_src) == len(want_src)
        for i in range(len(want_src)):
            assert_samples_equal(got_src[i], want_src[i], (d, i))
    lefts = [a["left_right"] for a in pairs[0][1].db.annotations]
    assert "Left" in lefts and "Right" in lefts


def test_crop_helpers_match():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (180, 240, 3), dtype=np.uint8)
    for box in ([10.7, 20.2, 90.9, 101.5], [0, 0, 239, 179], [200.5, 150.2, 239.0, 179.9]):
        box = np.asarray(box, np.float32)
        for scale, size in ((1.3, 224), (1.0, 57)):
            assert np.array_equal(crop_and_resize_box(image, box, scale, size),
                                  jcrop_box(image, box, scale, size))
    joints = rng.uniform(30, 150, (21, 2)).astype(np.float32)
    K = np.array([[300.0, 0, 120], [0, 310.0, 90], [0, 0, 1]], np.float32)
    got = crops.crop_and_resize_via_joints(image, joints, 128, 1.5, K)
    want = jcrops.crop_and_resize_via_joints(image, joints, 128, 1.5, K)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError, match="empty crop"):
        crops.crop_and_resize_via_joints(image, np.full((21, 2), 500.0), 64, 1.0, K)


def test_concat_matches(corpus):
    _, ((ja, pa), (jb, pb)) = corpus
    got, want = ConcatSource([pa, pb, pa]), JConcat([ja, jb, ja])
    assert len(got) == len(want) == 2 * N + 10
    w = got.sample_weights()
    assert w.dtype == want.sample_weights().dtype and np.array_equal(w, want.sample_weights())
    for i in (0, N - 1, N, N + 9, N + 10, 2 * N + 9):
        assert_samples_equal(got[i], want[i], i)
    assert got[N + 3]["positive_sample_idx"] >= N


@pytest.mark.parametrize("flag", FLAGS + ["every"])
def test_host_augmenter_matches(corpus, flag):
    """transform on the same image, joints and numpy seed: the image, the
    joints, the 3x3 transform and the applied parameters, bit for bit, for
    each flag alone (with the override paths of rotate and crop) and for
    every flag on."""
    _, ((_, src), _) = corpus
    on = FLAGS if flag == "every" else [flag]
    kw = {f: True for f in on}
    if flag != "every":
        kw.setdefault("resize", False)
    got_aug = HostAugmenter(AugmentFlags(**kw), AugmentParams(**PARAMS))
    want_aug = JAugmenter(JFlags(**kw), JParams(**PARAMS))
    overrides = [{}, {"override_angle": 12.0}, {"override_jitter": [3, 5]}]
    for i, extra in zip((0, 5, 11, 17), overrides + [{}]):
        sample = src[i]
        joints = sample["joints3D"]
        for seed in range(3):
            g = got_aug.transform(sample["image"], joints, np.random.default_rng(seed), **extra)
            w = want_aug.transform(sample["image"], joints, np.random.default_rng(seed), **extra)
            for a, b in zip(g[:3], w[:3]):
                assert a.dtype == b.dtype and np.array_equal(a, b), (flag, i, seed)
            assert dataclasses.asdict(g[3]) == dataclasses.asdict(w[3]), (flag, i, seed)


@pytest.mark.parametrize("etype", EXPERIMENT_TYPES)
@pytest.mark.parametrize("crop", [True, False], ids=["crop", "no_crop"])
def test_pretrain_samples_match(corpus, etype, crop):
    """PretrainDataset[i] for every contrastive type (simhand_vis's companion
    views included), with the main path's flags and color jitter, and
    without crop (the zero-jitter override)."""
    _, ((jsrc, src), _) = corpus
    kw = dict(crop=crop, resize=True, rotate=True, color_jitter=True)
    got = PretrainDataset(src, etype, AugmentFlags(**kw), AugmentParams(**PARAMS), seed=7)
    want = JDataset(jsrc, etype, JFlags(**kw), JParams(**PARAMS), seed=7)
    for i, epoch in ((0, 0), (9, 0), (9, 2), (N - 1, 1)):
        assert_samples_equal(got.__getitem__(i, epoch), want.__getitem__(i, epoch),
                             (etype, i, epoch))


def test_host_batches_match(corpus):
    """batch_iterator(raw=False): shuffled, in order with the last batch
    kept, and drawn with the concat's weights."""
    _, ((ja, pa), (jb, pb)) = corpus
    flags = dict(crop=True, resize=True, rotate=True)
    cases = [
        (pa, ja, dict(batch_size=5, seed=3, epoch=1, num_threads=3)),
        (pa, ja, dict(batch_size=7, shuffle=False, drop_last=False)),
        (ConcatSource([pa, pb]), JConcat([ja, jb]), dict(batch_size=6, seed=1)),
    ]
    for src, jsrc, kw in cases:
        got_ds = PretrainDataset(src, "simhand_w", AugmentFlags(**flags),
                                 AugmentParams(**PARAMS), seed=2)
        want_ds = JDataset(jsrc, "simhand_w", JFlags(**flags), JParams(**PARAMS), seed=2)
        if isinstance(src, ConcatSource):
            kw = {**kw, "sample_weights": src.sample_weights()}
        got, want = list(batch_iterator(got_ds, **kw)), list(jbatches(want_ds, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_samples_equal(g, w, kw)


def test_supervised_route_is_not_ported(corpus):
    """The supervised route (named when it still raised; ported since) on
    the Hand100M corpus: every key bit for bit against JAX's but the
    recreated 3D joints, lifted through K's inverse (within 1e-6 of their
    largest; tests/test_torch_downstream.py holds it on a FreiHAND layout)."""
    _, ((jsrc, src), _) = corpus
    flags = dict(crop=True, resize=True, rotate=True)
    got_ds = PretrainDataset(src, "supervised", AugmentFlags(**flags), AugmentParams(**PARAMS))
    want_ds = JDataset(jsrc, "supervised", JFlags(**flags), JParams(**PARAMS))
    for i in (0, 5):
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        for k, w in want.items():
            if k == "joints3D_recreated":
                np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * np.abs(w).max())
            else:
                assert np.array_equal(got[k], w) and np.asarray(got[k]).dtype == w.dtype, k


def test_hand100m_reads_its_annotation_once(corpus, monkeypatch):
    """Hand100MSource parses its annotation file once and takes a given
    annotation object without reading the file."""
    root, _ = corpus
    path = ann.annotation_path(str(root / "a"), "100doh", "smoke")
    calls = []
    real_load = json.load

    def counting_load(f):
        calls.append(getattr(f, "name", ""))
        return real_load(f)

    monkeypatch.setattr(json, "load", counting_load)
    src = Hand100MSource(str(root / "a"), source="100doh", scale="smoke")
    assert calls == [path]
    Hand100MSource(str(root / "a"), annotations=src.db)
    assert calls == [path]
    assert os.path.exists(path)
