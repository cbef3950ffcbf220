"""Host milliseconds a step spends dispatching itself: the traced steps'
``perfbench.step`` spans (the step call: train/loop.py, train/optimizer.py,
the Python of models/* and the launches), less the runtime calls in them that
blocked on the device (``trace.py``'s host_step_s). A step whose device work
outlasts this is device-bound."""

UNIT = "ms"
LAYER = "step host side"
MOVES = "samples_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.host_step_s is None:
        return None
    return ctx.trace.host_step_s * 1e3
