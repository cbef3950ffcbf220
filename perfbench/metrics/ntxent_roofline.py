"""The weighted NT-Xent kernels' share of their roofline: the least time
their work could take on the card (the bound below, at the cell's 2B x 2B
shapes, d = 128) over the device time a step of the kernels named here, as
the trace records them. losses/ntxent_kernels.py -> csrc/ntxent.cu: #2
(weighted denominator) and #4 (weighted gradient rows), with their sum pass.

A named kernel that the trace does not find is an error, not a zero; a cell
whose step launches none of them (``ntxent_rows`` unset) reads nothing."""

from perfbench import peaks

UNIT = "%"
LAYER = "loss kernels"
MOVES = "samples_per_s"

#: kernel (a part of its name) -> the work it bounds
KERNELS = {"weighted_denom_kernel": "weighted_ntxent_denominator",
           "weighted_grad_kernel": "weighted_grad_rows"}
#: the second pass that adds the kernels' column splits, part of their work
SUM_PASS = "sum_splits_kernel"


def bound_s(name: str, m: int, n: int) -> float:
    """Least seconds for float32-accurate work: the largest of the bytes
    (each input read once, each output written once) over the memory rate,
    the products on the tensor cores in three TF32 passes (2 * 128 flops a
    pair for a denominator, 4 * 128 for a gradient), and the rest on the
    CUDA cores, per pair: exp, divide, mask and sum 3; the weighted kernels
    21 * 7 for the joint distances and 4 for the weight; the gradients 2 for
    the (1/neg_m + 1/neg_j) factor."""
    d, weighted, grad = 128, "weighted" in name, "grad" in name
    pairs = float(m) * n
    t_tensor = 3 * pairs * 2 * d * (2 if grad else 1) / peaks.TF32_TENSOR_OPS_PER_S
    t_cuda = pairs * (3 + (21 * 7 + 4 if weighted else 0) + (2 if grad else 0)) \
        / peaks.FP32_OPS_PER_S
    nbytes = 4 * ((m + n) * d + m)
    nbytes += 4 * ((m + n) * 42 + 2) if weighted else 0
    nbytes += 4 * (m + n) if grad else 0
    nbytes += 4 * m * (d if grad else 1)
    return max(nbytes / peaks.HBM_BYTES_PER_S, t_tensor, t_cuda)


def read(ctx):
    rows = getattr(ctx.cell, "ntxent_rows", None)
    if ctx.trace is None or not rows:
        return None
    kernels = ctx.trace.kernels
    device_s = 0.0
    for part in KERNELS:
        found = [s for k, s in kernels.items() if part in k]
        if not found:
            raise RuntimeError(f"ntxent_roofline: the trace holds no {part}")
        device_s += sum(found)
    device_s += sum(s for k, s in kernels.items() if SUM_PASS in k)
    least = sum(bound_s(work, rows, rows) for work in KERNELS.values())
    return least / device_s * 100.0
