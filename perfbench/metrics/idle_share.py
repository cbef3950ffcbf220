"""Share of the traced window in which no operation ran on the device:
1 - (union of the device's busy intervals) / (the window on the host's
clock), over profiled steps that end in a synchronize."""

UNIT = "%"
LAYER = "device"
MOVES = "samples_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
