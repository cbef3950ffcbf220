"""The native gather's rate: the bytes of records it wrote over its
nanoseconds inside the library, summed over the feed's worker threads
(the program's ``gather.bytes`` and ``gather.busy_ns``, gather.py ->
csrc/batch_gather.cpp), both over the process's life up to the traced
epoch's end (``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "GB/s"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    p = phases.of(ctx)
    if p is None:
        return None
    nbytes, ns = p.lifetime.get("gather.bytes", 0), p.lifetime.get("gather.busy_ns", 0)
    if not nbytes or not ns:
        return None
    return nbytes / ns
