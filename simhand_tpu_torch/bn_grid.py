"""The BatchNorm-variant grid: does ``--bn_variant stop_grad`` transfer as
well as exact BatchNorm over several pre-training corpora? The port's copy
of the JAX package's ``scripts/bn_grid.py``, the evidence behind its
promotion of ``stop_grad``.

It runs the transfer miniature (``transfer_check.run_transfer_check``) over
``--seeds`` corpus seeds x ``--variants`` at ResNet-18 and
``--pretrain_steps``, then one ResNet-50 arm at ``--rn50_seed`` and
``--rn50_pretrain_steps``. The cells run variant-major, so the first-listed
variant completes across all seeds first; the ResNet-50 arm comes last.
A cell is ``[backbone, seed, variant, pretrain_steps]``, and its record
``{"cell": ..., "pretrained": ..., "random": ...}`` is appended to ``--out``
as one JSON line when it completes and printed. Cells already in ``--out``
are skipped, so the grid resumes where it stopped. The random-init arm
depends on neither the corpus seed nor the variant, so it runs once per
backbone: on the first ``exact`` cell of that backbone that lacks one. A
cell that fails prints ``{"cell": ..., "error": <the traceback's tail>}``
and writes nothing, so the next run tries it again. The run ends with the
summary line: the mean pretrained lossH_final of each ``rn<backbone>_<variant>``
and the number of cells in ``--out``.

Three departures from the JAX script:
- Cells run in this process, one after another. The JAX script gave each
  cell a fresh process for its own ``BASE_PATH``, orbax state and compile
  caches. Here each cell gets a new directory of its own under
  ``--workdir`` (a temporary one when not given), which
  ``run_transfer_check`` requires to be new or empty; every pre-training
  and fine-tune run writes its checkpoints there and restores nothing; and
  every random draw of a cell comes from generators seeded by its
  arguments. The mains' logs go where ``BASE_PATH`` says, as in the JAX
  script's one-cell runs, and ``main`` sets it to ``<workdir>/runs`` unless
  it is set.
- The summary skips lines of ``--out`` that are not JSON, as the resume
  does; the JAX script's summary raises on them.
- There is no ``--one_cell`` or ``--force_skip_random``: the JAX script
  used them only to run a cell in its subprocess. One cell alone is
  ``python -m simhand_tpu_torch.transfer_check`` with the cell's
  ``--resnet_size``, ``--corpus_seed``, ``--bn_variant`` and
  ``--pretrain_steps``.

It runs on the card unless given ``--device cpu``; without a card it raises.

    python -m simhand_tpu_torch.bn_grid [--seeds 5] [--pretrain_steps 120] \\
        [--out bn_grid.jsonl] [--workdir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import traceback


def read_records(out_path: str) -> list[dict]:
    """The JSON objects of ``out_path``, one a line, without the lines that
    are not JSON (none when the file does not exist)."""
    records = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


def plan_cells(seeds: int, pretrain_steps: int, rn50_seed: int, rn50_pretrain_steps: int,
               variants) -> list[list]:
    """Every cell of the grid in its run order."""
    cells = [["18", seed, variant, pretrain_steps]
             for variant in variants for seed in range(seeds)]
    if rn50_seed >= 0:
        cells += [["50", rn50_seed, variant, rn50_pretrain_steps] for variant in variants]
    return cells


def run_cell(cell, finetune_steps: int, workdir: str, force_skip_random: bool,
             device=None) -> dict:
    """One cell's record: the miniature in ``workdir`` at the cell's
    backbone, corpus seed, variant and pre-training steps; its random arm
    only on an ``exact`` cell without ``force_skip_random``."""
    from simhand_tpu_torch.transfer_check import run_transfer_check

    backbone, seed, variant, psteps = cell
    res = run_transfer_check(workdir, pretrain_steps=int(psteps),
                             finetune_steps=finetune_steps, bn_variant=variant,
                             corpus_seed=int(seed),
                             skip_random=(variant != "exact") or force_skip_random,
                             resnet_size=str(backbone), device=device)
    return {"cell": list(cell), "pretrained": res["pretrained"], "random": res["random"]}


def summary(out_path: str) -> dict:
    """The summary line of the grid in ``out_path``."""
    rows = [r for r in read_records(out_path) if "cell" in r]
    means: dict[str, list] = {}
    for r in rows:
        backbone, _, variant, _ = r["cell"]
        means.setdefault(f"rn{backbone}_{variant}", []).append(r["pretrained"]["lossH_final"])
    return {"summary_lossH_mean": {k: sum(v) / len(v) for k, v in means.items()},
            "cells": len(rows)}


def run_grid(out_path: str, cells, finetune_steps: int, workdir: str | None = None,
             device=None, cell_runner=run_cell) -> dict:
    """Runs the ``cells`` not yet in ``out_path`` through ``cell_runner``
    (``run_cell``'s arguments), each in a new directory under ``workdir``
    (a temporary one when None); returns the summary."""
    done = {tuple(r["cell"]) for r in read_records(out_path) if "cell" in r}
    have_random = {r["cell"][0] for r in read_records(out_path)
                   if "cell" in r and r.get("random") is not None}
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    for cell in cells:
        if tuple(cell) in done:
            continue
        backbone, seed = cell[0], cell[1]
        cell_dir = tempfile.mkdtemp(prefix=f"bn_grid_{backbone}_{seed}_", dir=workdir)
        try:
            rec = cell_runner(list(cell), finetune_steps, cell_dir, backbone in have_random,
                              device)
        except Exception:
            print(json.dumps({"cell": list(cell), "error": traceback.format_exc()[-800:]}),
                  flush=True)
            continue
        if rec.get("random") is not None:
            have_random.add(rec["cell"][0])
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    out = summary(out_path)
    print(json.dumps(out))
    return out


def main(argv=None, cell_runner=run_cell):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--pretrain_steps", type=int, default=120)
    p.add_argument("--finetune_steps", type=int, default=60)
    p.add_argument("--rn50_seed", type=int, default=0,
                   help="corpus seed of the one ResNet-50 arm (-1: none)")
    p.add_argument("--rn50_pretrain_steps", type=int, default=60,
                   help="the ResNet-50 arm checks the bottleneck architecture, "
                        "not the budget curve")
    p.add_argument("--out", default="bn_grid.jsonl")
    p.add_argument("--variants", default="exact,stop_grad",
                   help="comma-separated BatchNorm variants, in run order")
    p.add_argument("--workdir", default=None,
                   help="the directory under which each cell gets a new one "
                        "(default: temporary directories)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    from simhand_tpu_torch.device import resolve_device

    dev = str(resolve_device(args.device))
    import logging

    logging.basicConfig(level=logging.WARNING)
    if args.workdir:
        os.environ.setdefault("BASE_PATH", os.path.join(args.workdir, "runs"))
    variants = tuple(v.strip() for v in args.variants.split(",") if v.strip())
    cells = plan_cells(args.seeds, args.pretrain_steps, args.rn50_seed,
                       args.rn50_pretrain_steps, variants)
    return run_grid(args.out, cells, args.finetune_steps, args.workdir, dev, cell_runner)


if __name__ == "__main__":
    main()
