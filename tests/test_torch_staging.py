"""The raw route's page-locked staging pool (``simhand_tpu_torch/data/staging.py``)
on the CPU, with ordinary memory in place of page-locked blocks and stand-ins
for the events of the copies to the card: a block is not handed out again
before its copies have completed, the pool holds its bound, blocks come back
from batches that never reach the card (an abandoned iterator too), and
``batch_iterator(raw=True)`` gives today's batches bit for bit through it."""
from __future__ import annotations

import ctypes
import threading
import time
import types

import numpy as np
import pytest
import torch

from simhand_tpu_torch.data import staging
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
from simhand_tpu_torch.data.prefetch import device_prefetch
from simhand_tpu_torch.data.sources import SyntheticHandSource
from simhand_tpu_torch.parallel import mesh
from simhand_tpu_torch.utils import trace

N, SIDE, PAIRS = 48, 16, 4
LAYOUT = {"a": ((3, 5), np.float32), "b": ((7,), np.uint8)}


class Copy:
    """A stand-in for the event of a copy to the card: complete once
    ``finish`` has run, on the test's word or after ``delay`` seconds."""

    def __init__(self, finish=None, delay: float | None = None):
        self._done = threading.Event()
        self._finish = finish
        if delay is not None:
            threading.Timer(delay, self.complete).start()

    def complete(self):
        if self._finish is not None:
            self._finish()
        self._done.set()

    def query(self) -> bool:
        return self._done.is_set()

    def synchronize(self):
        if not self._done.wait(10):
            raise TimeoutError("a copy's event never completed")


class Blocks:
    """The pool's allocator: ordinary memory, each block kept for the test."""

    def __init__(self):
        self.made: list[np.ndarray] = []

    def __call__(self, nbytes: int) -> np.ndarray:
        self.made.append(np.zeros(nbytes, np.uint8))
        return self.made[-1]


def block_of(arrays: dict) -> int:
    return min(a.ctypes.data for a in arrays.values())


def taker(pool):
    """``pool.take(LAYOUT)`` on a thread of its own, and what it gave."""
    got = {}
    t = threading.Thread(target=lambda: got.update(out=pool.take(LAYOUT)), daemon=True)
    t.start()
    return t, got


def test_a_block_waits_for_the_copies_out_of_it(monkeypatch):
    """A block given back with a pending copy is not handed out before the
    copy's event has completed, and then it is reused, not reallocated; a
    block whose copy has completed is reused at once. The arrays lie apart
    and aligned in their block, which is asked once, when it is made,
    whether it is page-locked."""
    asked = []
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda t: asked.append(t.numel()) or True)
    blocks = Blocks()
    pool = staging.StagingPool(limit=1, alloc=blocks)
    arrays = pool.take(LAYOUT)
    assert {k: (a.shape, a.dtype) for k, a in arrays.items()} == LAYOUT
    assert all((a.ctypes.data - block_of(arrays)) % staging.ALIGN == 0 for a in arrays.values())
    assert staging.page_locked({**arrays, "c": np.ones(2)}) == dict.fromkeys("abc", True)
    assert asked == [blocks.made[0].nbytes, 2]
    monkeypatch.undo()
    arrays["a"][:] = 1.5
    arrays["b"][:] = 7
    assert (arrays["a"] == 1.5).all() and (arrays["b"] == 7).all()
    first, copy = block_of(arrays), Copy()
    staging.after_copy(arrays.values(), copy)
    staging.after_copy([arrays["a"][1:]], copy)          # a view: the same event once
    del arrays
    t, got = taker(pool)
    t.join(0.3)
    assert t.is_alive() and not got                     # waiting for the copy
    copy.complete()
    t.join(10)
    assert not t.is_alive() and block_of(got["out"]) == first
    assert len(blocks.made) == pool.blocks == 1
    staging.after_copy(got.pop("out").values(), Copy(delay=0.0))
    time.sleep(0.05)
    assert block_of(pool.take(LAYOUT)) == first and len(blocks.made) == 1


def test_the_pool_holds_its_bound():
    """The first take allocates the pool's every block; then a worker waits
    for a returned block's copies rather than allocate; where every block is
    held by a live batch the pool gives none, at once, and allocates
    nothing."""
    blocks = Blocks()
    pool = staging.StagingPool(limit=2, alloc=blocks)
    before = trace.counters().get("feed.staging_allocs", 0)
    held = [pool.take(LAYOUT)]
    assert len(blocks.made) == pool.blocks == 2
    held.append(pool.take(LAYOUT))
    assert len({block_of(h) for h in held}) == 2
    assert pool.take(LAYOUT) is None                    # both held: none, no wait
    copies = [Copy(), Copy()]
    for arrays, c in zip(held, copies):
        staging.after_copy(arrays.values(), c)
    del held, arrays
    t, got = taker(pool)
    t.join(0.3)
    assert t.is_alive() and not got
    copies[0].complete()                                # the copies end in order
    t.join(10)
    assert not t.is_alive() and got["out"] is not None
    assert len(blocks.made) == pool.blocks == 2
    assert trace.counters().get("feed.staging_allocs", 0) - before == 2
    # a layout larger than every block: a free one is replaced, the limit kept
    copies[1].complete()
    big = pool.take({"c": ((1000,), np.float64)})
    assert big["c"].shape == (1000,) and len(blocks.made) == 3 and pool.blocks == 2


def corpus(tmp_path) -> PretrainDataset:
    source = SyntheticHandSource(N, num_videos=4, side=SIDE, seed=5)
    build_crop_cache(source, str(tmp_path / "cache"), shard_size=20)
    return PretrainDataset(CachedHand100MSource(str(tmp_path / "cache")), "simhand_w",
                           AugmentFlags(crop=True, resize=True, rotate=True), AugmentParams())


def staged(arrays) -> bool:
    """Every array lies in a block of the pool."""
    return all(staging._lease(a) is not None for a in arrays)


@pytest.mark.parametrize("consumer", ["host", "cpu_prefetch", "per_rank", "kept"])
def test_staged_batches_equal_todays(tmp_path, monkeypatch, consumer):
    """Two epochs of ``batch_iterator(raw=True)`` through the pool equal the
    unstaged batches bit for bit (keys, dtypes, order): taken one by one,
    through the CPU prefetch, as one rank's rows of the sharded prefetch,
    and all kept by the consumer at once (past the pool's bound: the rest
    are gathered into ordinary memory). Every block comes back."""
    ds = corpus(tmp_path)
    kw = dict(batch_size=PAIRS, seed=2**31 + 7, raw=True)
    want = [b for e in range(2) for b in batch_iterator(ds, epoch=e, **kw)]
    assert len(want) == 2 * (N // PAIRS) and not staged(want[0].values())
    pool = staging.StagingPool(alloc=Blocks())
    monkeypatch.setattr(staging, "shared_pool", lambda: pool)
    got = [b for e in range(2) for b in consumed(batch_iterator(ds, epoch=e, **kw), consumer)]
    rows = slice(PAIRS // 2, PAIRS) if consumer == "per_rank" else slice(None)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(np.asarray(g[k]), w[k][rows]), k
    assert sum(staged(b.values()) for b in got) == (staging.LIMIT if consumer == "kept" else 0)
    assert pool.blocks <= staging.LIMIT
    del got
    assert pool.free_blocks() == pool.blocks


def consumed(it, consumer: str) -> list[dict]:
    """The batches of ``it`` as ``consumer`` takes them: kept as they come,
    else copied out (each checked to be staged where it is a host batch)."""
    if consumer == "kept":
        return list(it)
    if consumer == "cpu_prefetch":
        it = device_prefetch(it, device="cpu")
    elif consumer == "per_rank":
        it = mesh.device_prefetch(it, types.SimpleNamespace(size=2, index=1), device="cpu")
    out = []
    for b in it:
        assert consumer != "host" or staged(b.values())
        out.append({k: np.array(np.asarray(v)) for k, v in b.items()})
    return out


def test_no_block_is_refilled_before_its_copy(tmp_path, monkeypatch):
    """Copies that complete late (a stand-in event reads the block back when
    it completes, 20 ms after the batch): every copy reads the batch it was
    made for, over two epochs, though the pool runs at its bound."""
    ds = corpus(tmp_path)
    pool = staging.StagingPool(alloc=Blocks())
    monkeypatch.setattr(staging, "shared_pool", lambda: pool)
    wrong: list[str] = []

    def reader(batch: dict):
        where = {k: (v.ctypes.data, v.nbytes, v.tobytes()) for k, v in batch.items()}

        def finish():
            for k, (address, n, data) in where.items():
                if bytes((ctypes.c_uint8 * n).from_address(address)) != data:
                    wrong.append(k)
        return finish

    seen = 0
    for e in range(2):
        for batch in batch_iterator(ds, PAIRS, seed=3, epoch=e, raw=True):
            if staged(batch.values()):
                staging.after_copy(batch.values(), Copy(reader(batch), delay=0.02))
                seen += 1
            del batch
    assert seen == 2 * (N // PAIRS) and not wrong
    time.sleep(0.05)
    assert pool.free_blocks() == pool.blocks == staging.LIMIT


def test_an_abandoned_iterator_gives_its_blocks_back(tmp_path, monkeypatch):
    """A generator closed after one batch: its workers end, and every block,
    those of the batches it never handed out too, comes back."""
    ds = corpus(tmp_path)
    pool = staging.StagingPool(alloc=Blocks())
    monkeypatch.setattr(staging, "shared_pool", lambda: pool)
    before = set(threading.enumerate())
    it = batch_iterator(ds, PAIRS, raw=True)
    first = next(it)
    time.sleep(0.05)                  # the workers fill the window
    it.close()
    assert staged(first.values()) and pool.free_blocks() == pool.blocks - 1
    del first
    assert pool.free_blocks() == pool.blocks > 1
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before
    # raw_batch outside batch_iterator gives ordinary arrays
    assert not staged(ds.raw_batch(np.arange(PAIRS)).values())
