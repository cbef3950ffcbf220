"""Host milliseconds a step copying the batch into pinned buffers on the
step's own thread: the program's ``simhand.feed.pin`` span in
data/prefetch.py's ``_Slot.fill``, over a traced epoch
(``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    return phases.host_ms(ctx, "simhand.feed.pin")
