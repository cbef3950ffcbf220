"""Host milliseconds a step the step's thread waited for the feed's worker
threads (the native gather, and the restart at each epoch): the program's
``simhand.feed.queue`` span in data/pipeline.py's ``batch_iterator``, over a
traced epoch (``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    return phases.host_ms(ctx, "simhand.feed.queue")
