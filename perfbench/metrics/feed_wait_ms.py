"""Host milliseconds a step spent in ``next()`` on the prefetch iterator
over the window: what the step waited for its batch (data/cache.py,
data/pipeline.py, gather.py -> csrc/batch_gather.cpp, data/prefetch.py)."""

UNIT = "ms"
LAYER = "feed"
MOVES = "samples_per_s"


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.feed_wait_s / ctx.steps * 1e3
