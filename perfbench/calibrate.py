"""The readings that a cell's limits are set from, on the card at the cell's
own size, in one process:

  python3 perfbench/calibrate.py --workload <name> --seeds 12 --faults 3 \
      [--first-seed N] [--out chiprun_out/calibrate_<name>.jsonl]

For each seed: the program's checked steps (set up as a run sets them up)
against the plain reference, the lower reading. For the first ``--faults``
seeds also: the control, the reference computed in float8 (one precision
below the configuration's bf16) in the program's place, and the fault of half
of each batch left out (the reference on the first half of the pairs), each
against the float32 reference; these give the upper readings. A state left
unchanged reads 1 on grad_gap and change_gap by their definition and is not
run. Each seed's numbers are one JSON line in ``--out``; the last line of
standard output sums them up. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(spec, seeds: list[int], faults: int, device, out) -> list[dict]:
    import torch

    from perfbench import compare
    from perfbench.run import cache_dirs
    from perfbench.spec import load_module

    work_dir = cache_dirs(spec.root)
    driver = load_module(spec.root, "drivers", spec.config["driver"])
    # the checked steps alone: no warm-up beyond them
    spec = dataclasses.replace(spec, traffic={**spec.traffic, "warmup_steps": 0})
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        cell = driver.Cell(spec, seed, torch.device(device), work_dir)
        cell.setup()
        cell.close_program()
        ref = cell.reference_readings()
        detail: dict = {}
        row = {"seed": seed, "program": compare.gaps(cell.readings, ref, detail), **detail,
               "losses": cell.readings["losses"], "reference_losses": ref["losses"]}
        if i < faults:
            row["control"] = compare.gaps(cell.reference_readings(compute="fp8"), ref)
            row["half_batch"] = compare.gaps(cell.reference_readings(half_batch=True), ref)
            # the look: the reference against itself, its weights moved by a
            # millionth, shows how far a number swings by its nature
            row["look"] = compare.gaps(cell.reference_readings(perturb=1e-6), ref)
            # the second witness: the reference itself computed in bf16
            row["bf16"] = compare.gaps(cell.reference_readings(compute="bf16"), ref)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
        del cell
    return rows


def summary(rows: list[dict]) -> dict:
    names = list(rows[0]["program"])
    out = {}
    for n in names:
        out[n] = {"lower": max(r["program"][n] for r in rows),
                  "program": sorted(r["program"][n] for r in rows)}
        for kind in ("control", "half_batch", "look", "bf16"):
            seen = [r[kind][n] for r in rows if kind in r]
            if seen:
                out[n][kind] = min(seen) if kind in ("control", "half_batch") else max(seen)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from perfbench.spec import load_spec

    spec = load_spec(ROOT, args.workload)
    path = args.out or os.path.join(ROOT, "chiprun_out", f"calibrate_{args.workload}.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    with open(path, "w") as out:
        rows = readings(spec, seeds, args.faults, args.device, out)
    print(json.dumps({"workload": args.workload, "seeds": len(rows), **summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
