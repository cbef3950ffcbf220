"""Seconds from the process's start to the first timed step: imports, the
corpus, the weights, building and warming up the program and its checked
steps (a checkout's first run also builds its kernels)."""

UNIT = "s"
LAYER = "end to end"
MOVES = None


def read(ctx):
    return ctx.setup_s
