"""The rate of the feed's copies to the card: bytes a batch (the program's
``feed.h2d_bytes`` over ``feed.batches``, counted in data/prefetch.py over
the traced epoch) over the device seconds a step of the operations launched
in its ``simhand.feed.h2d`` span (``perfbench/phases.py``). At most the
card's PCIe rate, 64 GB/s one way on Gen5 x16."""

from perfbench import phases

UNIT = "GB/s"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    p = phases.of(ctx)
    if p is None:
        return None
    nbytes, batches = p.counted.get("feed.h2d_bytes", 0), p.counted.get("feed.batches", 0)
    device_s = p.device_s.get("simhand.feed.h2d", 0.0)
    if not nbytes or not batches or not device_s:
        return None
    return nbytes / batches / device_s / 1e9
