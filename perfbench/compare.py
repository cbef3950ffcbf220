"""The numbers that decide ``correct`` for a training cell: the program's
readings of its first steps against the plain reference's.

  loss_gap    the largest |loss - reference loss| / |reference loss| over the steps
  grad_gap    the first gradient as Adam holds it (its first moment over 1 - b1),
              by the worst leaf: |norm - reference norm| over the larger of the
              reference's norm of that leaf and the median leaf's
  change_gap  each leaf's change by the last step, parameters and BatchNorm
              running statistics apart, by the worst leaf in the same measure

Where a number swings by its nature, or the control does not fail it
(PERF.md gives the readings, the look and the cause), a cell compares a
steady one in its place; each cell's workload file names what it compares:

  grad_median_gap    grad_gap's measure at the median leaf
  var_gap            the first step's batch variance at each BatchNorm, a
                     statistic of millions of values that rounding biases:
                     |difference| / |reference|, the median site
  change_median_gap  change_gap's measure at the median parameter
  stats_median_gap   change_gap's measure at the median running statistic
  emb_gap            the encoder's output of the first step (2B x 2048):
                     |difference| / |reference|; recorded, not compared (the
                     untrained network's forward turns bf16 rounding into
                     ~15% of it)

A parameter whose reference gradient is under a thousandth of the median
leaf's (a bias that BatchNorm cancels) moves under Adam by round-off alone:
it is left out of the changes by that rule, never by name.
"""
from __future__ import annotations

import statistics

NOUGHT = 1e-3


def loss_gap(prog: list[float], ref: list[float]) -> float:
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program losses against {len(ref)} reference losses")
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gap(prog: dict, ref: dict, names: list[str]) -> tuple[float, str]:
    """(gap, leaf) of the worst leaf among ``names``."""
    missing = [n for n in names if n not in prog]
    if missing:
        raise KeyError(f"the program has no reading of {missing[:4]}")
    med = statistics.median(ref[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(ref[n], med), n) for n in names)


def median_gap(prog: dict, ref: dict, names: list[str]) -> float:
    """The median leaf's gap, in the measure of ``leaf_gap``."""
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def rel_diff(prog, ref) -> float:
    """|prog - ref| / |ref| of two matrices; infinite where the program's has
    another shape (rows left out)."""
    if prog.shape != ref.shape:
        return float("inf")
    return float((prog - ref).norm() / ref.norm())


def gaps(prog: dict, ref: dict, detail: dict | None = None) -> dict[str, float]:
    """The three numbers of ``prog``'s readings against ``ref``'s; with
    ``detail``, the worst leaf of each goes there."""
    grads = ref["first_grad"]
    params = sorted(grads)
    median = statistics.median(grads.values())
    moved = [n for n in params if grads[n] >= NOUGHT * median]
    buffers = sorted(n for n in ref["change"] if n not in grads)
    grad, grad_leaf = leaf_gap(prog["first_grad"], grads, params)
    change = max(leaf_gap(prog["change"], ref["change"], moved),
                 leaf_gap(prog["change"], ref["change"], buffers) if buffers else (0.0, ""))
    if detail is not None:
        detail.update(grad_leaf=grad_leaf, change_leaf=change[1],
                      left_out=[n for n in params if n not in moved])
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]), "grad_gap": grad,
            "change_gap": change[0],
            "grad_median_gap": median_gap(prog["first_grad"], grads, params),
            "emb_gap": rel_diff(prog["embeddings"], ref["embeddings"]),
            "var_gap": statistics.median(rel_diff(prog["batch_var"][n], v)
                                         for n, v in ref["batch_var"].items()),
            "change_median_gap": median_gap(prog["change"], ref["change"], moved),
            "stats_median_gap": median_gap(prog["change"], ref["change"], buffers)
            if buffers else 0.0}
