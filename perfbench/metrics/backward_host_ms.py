"""Host milliseconds a step dispatching the whole backward (autograd, from its
device thread too): the program's ``simhand.step.backward`` span in
train/loop.py, less the runtime calls in it that blocked for more than
``trace.BLOCKED_S`` (dispatch_ms's rule), over a traced epoch
(``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "step host side"
MOVES = "samples_per_s"


def read(ctx):
    return phases.dispatch_ms(ctx, "simhand.step.backward")
