"""The whole step's share of the card's bf16 peak: the analytic FLOPs a
sample (the cell driver's, from the configuration's forward GFLOP at 224^2,
times (side / 224)^2, times 3 for forward and backward, times 2 views; no
recomputed work) times the samples a second of the run's unprofiled window,
over 989 TFLOP/s (H100 SXM, dense, at 700 W)."""

from perfbench import peaks

UNIT = "%"
LAYER = "whole step"
MOVES = "samples_per_s"


def read(ctx):
    flops = getattr(ctx.cell, "flops_per_sample", None)
    if not flops:
        return None
    return flops * ctx.samples / ctx.window_s / peaks.BF16_TENSOR_OPS_PER_S * 100.0
