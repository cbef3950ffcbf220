"""Device milliseconds a step of the operations launched for the optimizer's
update (train/optimizer.py: LARS, Adam): those whose runtime call started
inside the program's ``simhand.step.optimizer`` span in train/loop.py, over
a traced epoch (``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "step device side"
MOVES = "samples_per_s"


def read(ctx):
    return phases.device_ms(ctx, "simhand.step.optimizer")
