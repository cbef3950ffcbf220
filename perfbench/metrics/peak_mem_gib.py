"""The most device memory allocated at once over the window (after the
peak is reset at its start), in GiB: the headroom bounds the batch a card
takes."""

UNIT = "GiB"
LAYER = "device memory"
MOVES = "samples_per_s"


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / 2**30
