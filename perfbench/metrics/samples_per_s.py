"""Samples completed in the window over the window's seconds; the window
ends in a synchronize, so every step counted has finished. The cell's
configuration says what a sample is (pre-training: one positive pair, two
views)."""

UNIT = "samples/s"
LAYER = "end to end"
MOVES = None


def read(ctx):
    return ctx.samples / ctx.window_s
