"""The port's spans and counters (``simhand_tpu_torch/utils/trace.py``) on the
CPU: the train step's five phase spans, the feed's queue span, the gather's
counters under concurrent gathers, and a span that costs nothing with no
profiler running."""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from simhand_tpu_torch import gather
from simhand_tpu_torch.utils import trace

PHASES = ["simhand.step.augment", "simhand.step.forward", "simhand.step.loss",
          "simhand.step.backward", "simhand.step.optimizer"]


def spans(prof, prefix: str) -> list[tuple[str, float, float]]:
    """(name, start, end) of the profiled ranges whose names start with
    ``prefix``, in order of their start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda r: r[1])


def hands(rng, b, side):
    """(b, 21, 3) pixel-space hands inside the crop, depth 1."""
    j = rng.uniform(0.3, 0.7, (b, 21, 2)) * side
    return np.concatenate([j, np.ones((b, 21, 1))], -1).astype(np.float32)


def test_train_step_phase_spans():
    """One augmenting step under a profiler: the five phases once each, in
    order, none overlapping the next, all inside the step."""
    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
    from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
    from simhand_tpu_torch.train import OptimizerConfig, create_train_state, make_train_step

    out, b, side = 32, 4, 64
    rng = np.random.default_rng(0)
    j1, j2 = hands(rng, b, side), hands(rng, b, side)
    raw = {"image1": rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8),
           "image2": rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8),
           "joints1": j1, "joints2": j2, "joints_raw1": j1 / side, "joints_raw2": j2 / side}
    raw = {k: torch.from_numpy(v) for k, v in raw.items()}
    model = ContrastiveModel("18")
    state = create_train_state(model, OptimizerConfig(train_iters_per_epoch=1, warmup_epochs=1,
                                                      epochs=10),
                               0, input_shape=(2, out, out, 3), device="cpu")
    cfg = ContrastiveConfig(experiment_type="simhand_w", augmentation=("crop", "resize"),
                            image_side=float(out))
    step = make_train_step(model, cfg, augment=(AugmentFlags(crop=True, resize=True),
                                                AugmentParams(), out))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.step"):
            state, metrics = step(state, raw)
    assert torch.isfinite(metrics["contrastive_loss"])
    got = spans(prof, "simhand.step.")
    assert [n for n, _, _ in got] == PHASES
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert end <= start
    (_, lo, hi), = spans(prof, "test.step")
    assert all(lo <= s and e <= hi for _, s, e in got)


class _RawDataset:
    """A raw route's dataset: each batch is its indices' rows of a table."""

    def __init__(self, n: int):
        self.table = np.arange(n * 4, dtype=np.int64).reshape(n, 4)

    def __len__(self) -> int:
        return len(self.table)

    def raw_batch(self, idxs, stage=None) -> dict:
        return {"rows": self.table[np.asarray(idxs)]}


def test_batch_iterator_queue_span():
    """The consuming thread's work with the queue is ``simhand.feed.queue``:
    once to start the workers, once a batch, once to stop them."""
    from simhand_tpu_torch.data.pipeline import batch_iterator

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = list(batch_iterator(_RawDataset(24), 4, seed=3, num_threads=2, raw=True))
    assert len(batches) == 6
    assert sorted(np.concatenate([x["rows"][:, 0] for x in batches]).tolist()) == \
        list(range(0, 96, 4))
    queue = [e for e in prof.events() if e.name == "simhand.feed.queue"]
    assert len(queue) == 6 + 2
    assert len({e.thread for e in queue}) == 1


def _delta(before: dict, name: str) -> int:
    return trace.counters().get(name, 0) - before.get(name, 0)


def test_gather_counts_its_bytes():
    """Both gathers add the bytes of the records they wrote and a positive
    time; two threads gathering at once lose no count."""
    src = np.arange(64 * 3 * 5, dtype=np.float32).reshape(64, 3, 5)
    idx = np.array([5, 0, 63, 7, 7])
    shards = [src[:40], src[40:]]
    before = trace.counters()
    assert np.array_equal(gather.gather_records(src, idx), src[idx])
    assert _delta(before, "gather.bytes") == 5 * 3 * 5 * 4
    assert _delta(before, "gather.busy_ns") > 0
    before = trace.counters()
    gather.gather_records_sharded(shards, [0, 1, 1], [3, 0, 23])
    assert _delta(before, "gather.bytes") == 3 * 3 * 5 * 4

    calls, threads = 200, 2
    before = trace.counters()

    def work():
        for _ in range(calls):
            gather.gather_records(src, idx)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in pool)
    assert _delta(before, "gather.bytes") == threads * calls * 5 * 3 * 5 * 4


def test_counters_lose_no_add_under_contention():
    """More adding threads than cores, with the interpreter switching
    threads often: every add is counted."""
    counts = trace.Counters()
    threads, adds = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda: [counts.add("n", 3) for _ in range(adds)])
                for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert counts.counters() == {"n": 3 * threads * adds}
    snapshot = counts.counters()
    snapshot["n"] = 0
    assert counts.counters()["n"] == 3 * threads * adds          # a copy
    counts.reset()
    assert counts.counters() == {}


def test_span_without_a_profiler_is_a_shared_no_op(monkeypatch):
    """No profiler running: one shared no-op context, no record_function
    made, and the profiler's state as it was."""
    assert not autograd_profiler._is_profiler_enabled

    def refuse(name):
        raise AssertionError("record_function made with no profiler running")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    a, b = trace.span("simhand.step.forward"), trace.span("simhand.feed.pin")
    assert a is b
    with a:
        pass
    assert not autograd_profiler._is_profiler_enabled
    assert not torch.autograd._profiler_enabled()


def test_span_under_a_profiler_records_its_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("simhand.feed.pin"):
            torch.ones(3).sum()
    assert [n for n, _, _ in spans(prof, "simhand.")] == ["simhand.feed.pin"]
    assert not autograd_profiler._is_profiler_enabled


@pytest.mark.parametrize("name", ["feed.batches", "feed.h2d_bytes", "feed.pinned_batches"])
def test_prefetch_counts_only_the_cards_route(name):
    """The CPU route of device_prefetch hands batches over without copies:
    it adds to none of the feed counters."""
    from simhand_tpu_torch.data.prefetch import device_prefetch

    before = trace.counters()
    out = list(device_prefetch(iter([{"x": np.ones((2, 3), np.float32)}] * 3), "cpu"))
    assert len(out) == 3 and out[0]["x"].shape == (2, 3)
    assert _delta(before, name) == 0
