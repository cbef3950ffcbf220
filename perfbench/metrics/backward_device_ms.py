"""Device milliseconds a step of the operations launched for the whole
backward (autograd, from its device thread too): those whose runtime call
started inside the program's ``simhand.step.backward`` span in
train/loop.py, over a traced epoch (``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "step device side"
MOVES = "samples_per_s"


def read(ctx):
    return phases.device_ms(ctx, "simhand.step.backward")
