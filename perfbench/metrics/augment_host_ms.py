"""Host milliseconds a step dispatching augmenting both views on the card
(data/augment.py): the program's ``simhand.step.augment`` span in
train/loop.py, less the runtime calls in it that blocked for more than
``trace.BLOCKED_S`` (dispatch_ms's rule), over a traced epoch
(``perfbench/phases.py``)."""

from perfbench import phases

UNIT = "ms"
LAYER = "step host side"
MOVES = "samples_per_s"


def read(ctx):
    return phases.dispatch_ms(ctx, "simhand.step.augment")
