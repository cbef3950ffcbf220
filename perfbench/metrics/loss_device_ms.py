"""Device milliseconds a step of the operations launched for the contrastive
loss with its weights and the NT-Xent kernels (models/contrastive.py,
losses/*): those whose runtime call started inside the program's
``simhand.step.loss`` span in train/loop.py, over a traced epoch
(``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "step device side"
MOVES = "samples_per_s"


def read(ctx):
    return phases.device_ms(ctx, "simhand.step.loss")
