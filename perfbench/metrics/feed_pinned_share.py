"""The share of the traced epoch's batches that the card's prefetch sent
straight from page-locked staging, with no copy on the step's thread: the
program's ``feed.pinned_batches`` over ``feed.batches``, both counted in
data/prefetch.py over the traced epoch (``perfbench/phases.py``). A program
that does not count the first reads nothing."""

from perfbench import phases

UNIT = "%"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    p = phases.of(ctx)
    if p is None or "feed.pinned_batches" not in p.counted:
        return None
    batches = p.counted.get("feed.batches", 0)
    if not batches:
        return None
    return 100.0 * p.counted["feed.pinned_batches"] / batches
