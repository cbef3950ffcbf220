"""The port's input path (``simhand_tpu_torch.data``: the packed crop cache,
the native gather, the raw pair batches, the synthetic corpus and the
prefetch) against the JAX package on the CPU.

The JAX package writes a synthetic Hand100M corpus (``cv2`` is here) and
its crop cache; the port must read that cache bit for bit, write one that
the JAX reader reads the same, and give the same raw batches for the same
seed and epoch. Everything compared here is exact: no arithmetic differs.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from simhand_tpu.data.augment_cv2 import AugmentFlags as JFlags
from simhand_tpu.data.augment_cv2 import AugmentParams as JParams
from simhand_tpu.data.cache import CachedHand100MSource as JCached
from simhand_tpu.data.cache import build_crop_cache as jbuild
from simhand_tpu.data.pipeline import PretrainDataset as JDataset
from simhand_tpu.data.pipeline import batch_iterator as jbatches
from simhand_tpu.data.sources import Hand100MSource
from simhand_tpu.data.sources import generate_synthetic_hand100m as jgenerate
from simhand_tpu_torch import gather
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
from simhand_tpu_torch.data.prefetch import device_prefetch
from simhand_tpu_torch.data.sources import SyntheticHandSource, generate_synthetic_hand100m
from simhand_tpu_torch.data.sources.synthetic import render_hands

pytest.importorskip("cv2")
torch.set_num_threads(2)
N, VIDEOS, SHARD = 24, 4, 10
REPO = pathlib.Path(__file__).resolve().parent.parent
MAIN_FLAGS = dict(crop=True, resize=True, rotate=True)
META = ("joints3d", "joints_raw", "positive_idx", "hand_id", "distance")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX package's synthetic corpus, its source and its crop cache."""
    root = tmp_path_factory.mktemp("hand100m")
    jgenerate(str(root / "data"), num_images=N, num_videos=VIDEOS, side=256)
    src = Hand100MSource(str(root / "data"), source="100doh", scale="smoke")
    jbuild(src, str(root / "jax_cache"), shard_size=SHARD)
    return root, src


def assert_sources_equal(got, want):
    assert len(got) == len(want)
    for name in META:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in b:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (i, k)
    idx = np.array([0, SHARD - 1, SHARD, N - 1, 3, 3])     # shard edges, a repeat
    assert np.array_equal(got.gather_crops(idx), want.gather_crops(idx))


def test_port_reads_the_jax_cache_bit_for_bit(corpus):
    root, _ = corpus
    assert_sources_equal(CachedHand100MSource(str(root / "jax_cache")),
                         JCached(str(root / "jax_cache")))


def test_jax_reads_the_port_cache_the_same(corpus):
    """The port's build_crop_cache over the same source: the same files
    (crop shards and index bit for bit, meta arrays equal), read the same
    by the JAX reader."""
    root, src = corpus
    build_crop_cache(src, str(root / "port_cache"), shard_size=SHARD)
    assert sorted(os.listdir(root / "port_cache")) == sorted(os.listdir(root / "jax_cache"))
    for name in os.listdir(root / "jax_cache"):
        if name != "meta.npz":
            assert (root / "port_cache" / name).read_bytes() == \
                (root / "jax_cache" / name).read_bytes(), name
    assert_sources_equal(JCached(str(root / "port_cache")), JCached(str(root / "jax_cache")))


@pytest.mark.parametrize("etype", ["simhand_w", "simclr"])
def test_raw_batches_match_jax(corpus, etype):
    """raw_batch and batch_iterator(raw=True) against JAX's for the same seed
    and epoch: simhand_w's mined positives, simclr's identity pairs."""
    root, src = corpus
    cache = str(root / "jax_cache")
    ours = PretrainDataset(CachedHand100MSource(cache), etype, AugmentFlags(**MAIN_FLAGS),
                           AugmentParams())
    theirs = JDataset(JCached(cache), etype, JFlags(**MAIN_FLAGS), JParams())
    idx = np.array([5, 0, 11, 23, 11])
    got, want = ours.raw_batch(idx), theirs.raw_batch(idx)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    if etype == "simclr":
        assert np.array_equal(got["image1"], got["image2"])
    else:
        assert not np.array_equal(got["image1"], got["image2"])
    # the per-sample route, on a source without the gather
    slow = PretrainDataset(src, etype, AugmentFlags(**MAIN_FLAGS), AugmentParams())
    pairs = [slow.raw_pair(int(i)) for i in idx]
    for k in want:
        assert np.array_equal(np.stack([p[k] for p in pairs]), want[k]), k
    kw = dict(batch_size=5, seed=3, epoch=1, raw=True)
    got = list(batch_iterator(ours, **kw))
    want = list(jbatches(theirs, **kw))
    assert len(got) == len(want) == N // 5
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k


def test_gather_matches_numpy_indexing():
    rng = np.random.default_rng(10)
    src = rng.integers(0, 255, (50, 8, 8, 3), dtype=np.uint8)
    idx = rng.integers(0, 50, 20)
    assert np.array_equal(gather.gather_records(src, idx), src[idx])
    shards = [rng.integers(0, 255, (n, 8, 8, 3), dtype=np.uint8) for n in (10, 10, 7)]
    shard_ids = np.array([2, 0, 1, 1, 2, 0, 0])
    rows = np.array([6, 0, 5, 5, 1, 3, 9])
    want = np.stack([shards[k][r] for k, r in zip(shard_ids, rows)])
    assert np.array_equal(gather.gather_records_sharded(shards, shard_ids, rows), want)
    out = np.empty_like(want)
    assert gather.gather_records_sharded(shards, shard_ids, rows, out=out) is out
    assert np.array_equal(out, want)
    with pytest.raises(IndexError):
        gather.gather_records(src, [50])
    with pytest.raises(IndexError):
        gather.gather_records_sharded(shards, [2], [7])
    with pytest.raises(ValueError):
        gather.gather_records(src[:, ::2], [0])


def test_batch_iterator_shuts_down_when_abandoned(corpus):
    """A generator closed mid-epoch joins its worker threads; a worker's
    error reaches the consumer."""
    root, _ = corpus
    ds = PretrainDataset(CachedHand100MSource(str(root / "jax_cache")), "simhand_w",
                         AugmentFlags(**MAIN_FLAGS), AugmentParams())
    before = set(threading.enumerate())
    it = batch_iterator(ds, batch_size=2, raw=True)
    next(it)
    assert len(set(threading.enumerate()) - before) == 2      # two workers, not more
    it.close()
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before

    class Broken(PretrainDataset):
        def raw_batch(self, indices):
            if 7 in indices:
                raise RuntimeError("corrupt shard")
            return super().raw_batch(indices)

    broken = Broken(ds.source, "simhand_w", AugmentFlags(**MAIN_FLAGS), AugmentParams())
    with pytest.raises(RuntimeError, match="corrupt shard"):
        for _ in batch_iterator(broken, batch_size=4, shuffle=False, raw=True):
            pass
    # the host route (raw=False) is ported too: host-augmented batches
    host = batch_iterator(ds, batch_size=4)
    assert next(host)["transformed_image1"].shape == (4, 128, 128, 3)
    host.close()


def test_synthetic_corpus_matches_jax(tmp_path):
    """The port's generator writes the JAX package's dataset for the same
    arguments; its numpy half (no cv2) builds a source whose positives are
    other videos' nearest hands, and a cache of it reads back the same."""
    jgenerate(str(tmp_path / "jax"), num_images=12, num_videos=3, side=64, seed=4)
    generate_synthetic_hand100m(str(tmp_path / "port"), num_images=12, num_videos=3,
                                side=64, seed=4)
    rel = os.path.join("annotations", "100DOH", "Hand100M_100DOH_smoke_v1-1.json")
    with open(tmp_path / "jax" / rel) as f, open(tmp_path / "port" / rel) as g:
        want, got = json.load(f), json.load(g)
    assert got == want
    for rec in want["images"]:
        assert (tmp_path / "port" / rec["file_name"]).read_bytes() == \
            (tmp_path / "jax" / rec["file_name"]).read_bytes()

    src = SyntheticHandSource(12, num_videos=3, side=64, seed=4)
    images, joints, left = render_hands(12, 64, seed=4)
    assert [a["left_right"] == "Left" for a in want["annotations"]] == left.tolist()
    assert [a["positive_sample"][0] for a in want["annotations"]] == src.positive_idx.tolist()
    assert ((src.positive_idx % 3) != (np.arange(12) % 3)).all()
    assert np.array_equal(src[1]["image"], images[1][:, ::-1] if left[1] else images[1])
    build_crop_cache(src, str(tmp_path / "cache"), shard_size=5)
    cached = CachedHand100MSource(str(tmp_path / "cache"))
    for i in range(12):
        assert np.array_equal(cached[i]["image"], src[i]["image"])
        assert np.array_equal(cached[i]["joints3D"], src[i]["joints3D"])
        assert cached[i]["positive_sample_idx"] == src[i]["positive_sample_idx"]


def test_prefetch_on_the_cpu_yields_the_batches():
    batches = [{"image1": np.full((2, 4, 4, 3), i, np.uint8),
                "joints1": np.full((2, 21, 3), i, np.float32)} for i in range(5)]
    got = list(device_prefetch(iter(batches), device="cpu"))
    assert len(got) == 5
    for g, w in zip(got, batches):
        for k in w:
            assert g[k].device.type == "cpu" and np.array_equal(g[k].numpy(), w[k])


def test_the_cards_path_needs_no_cv2(corpus):
    """In a process where ``import cv2`` fails: every module of the port's
    data package imports, and the cache-fed raw path runs on a cache written
    beforehand, through the prefetch and the augmentation (on the CPU)."""
    root, _ = corpus
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["cv2"] = None
        import torch
        import simhand_tpu_torch.data as data
        for m in pkgutil.walk_packages(data.__path__, "simhand_tpu_torch.data."):
            importlib.import_module(m.name)
        from simhand_tpu_torch.data.augment import prepare_views, seeded_generator
        from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
        from simhand_tpu_torch.data.cache import CachedHand100MSource
        from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
        from simhand_tpu_torch.data.prefetch import device_prefetch
        flags = AugmentFlags(crop=True, resize=True, rotate=True)
        ds = PretrainDataset(CachedHand100MSource({str(root / "jax_cache")!r}), "simhand_w",
                             flags, AugmentParams())
        n = 0
        for raw in device_prefetch(batch_iterator(ds, 4, raw=True), device="cpu"):
            views = prepare_views(raw, seeded_generator("cpu", 0, n), flags,
                                  AugmentParams(), 32)
            assert views["transformed_image1"].shape == (4, 32, 32, 3)
            assert bool(torch.isfinite(views["transformed_image2"]).all())
            n += 1
        assert n == {N // 4}
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


def test_no_module_of_the_port_imports_cv2_at_module_level():
    """The card's machine has no cv2: a module-level import would break the
    port's import there (an import inside a function, as the synthetic
    generator's, is allowed)."""
    pattern = re.compile(r"^(import|from)\s+cv2\b", re.M)
    files = sorted((REPO / "simhand_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
    assert "import cv2" in (REPO / "simhand_tpu_torch/data/sources/synthetic.py").read_text()
