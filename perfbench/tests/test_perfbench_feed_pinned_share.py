"""``feed_pinned_share`` as the per-phase metrics are read
(``perfbench/tests/test_perfbench_phases.py``): its arithmetic on a session's
counters, and nothing read off a traced run, with no batch, or from a program
that does not count staged batches (the parent of the staging pool)."""
from __future__ import annotations

import pytest

from perfbench import phases as P
from perfbench.run import Context
from perfbench.spec import load_module, load_spec
from perfbench.tests.toy import REPO


def ctx(counted: dict | None, trace: bool = True) -> Context:
    c = Context(None, 1.0, 4, 4096, 2.0, 0.25, 2**30, object() if trace else None)
    if counted is not None:
        vars(c)["_phases"] = P.Phases(12, 0.25, {}, {}, {"other": 0.0}, 0.0, 0.0, None, 0.0,
                                      0.0, [], {}, counted=counted)
    return c


def metric():
    return load_module(REPO, "metrics", "feed_pinned_share")


@pytest.mark.parametrize("pinned,want", [(12, 100.0), (9, 75.0), (0, 0.0)])
def test_share_of_the_epochs_batches(pinned, want):
    counted = {"feed.batches": 12, "feed.pinned_batches": pinned, "feed.h2d_bytes": 1}
    assert metric().read(ctx(counted)) == pytest.approx(want)


@pytest.mark.parametrize("counted", [{"feed.batches": 12}, {"feed.pinned_batches": 0}, {}],
                         ids=["parent", "no-batch", "empty"])
def test_nothing_to_read(counted):
    assert metric().read(ctx(counted)) is None
    assert metric().read(ctx(None, trace=False)) is None


def test_listed_for_every_cell():
    for cell in ("rn50_pretrain", "rn152_pretrain", "rn50_pretrain_stopgrad"):
        entry, = [m for m in load_spec(REPO, cell).per_layer if m["name"] == "feed_pinned_share"]
        assert (entry["unit"], entry["layer"], entry["moves"]) == ("%", "feed", "samples_per_s")
