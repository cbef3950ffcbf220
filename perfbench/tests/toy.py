"""A toy cell for the CPU tests: the rn50_pretrain cell's files at a size a
test run holds (64 crops of 64^2, 8 pairs a step at 32^2, float32, the dense
loss route), in a copy of the benchmark under a temporary root."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the toy cell's limits, set from its CPU readings over 4 seeds (float32
#: program against the float32 reference): loss_gap 4.6e-3-3.9e-2, grad_gap
#: 3.1e-3-7.4e-3, change_median_gap 3.4e-3-5.3e-3, stats_median_gap
#: 2.0e-3-3.3e-3; the float8 control's grad_gap 0.35; half of each batch
#: 0.33 on loss_gap; a state left unchanged 1 on change_median_gap
TOY_LIMITS = {"loss_gap": 0.1, "grad_gap": 0.05, "change_median_gap": 0.1,
              "stats_median_gap": 0.02}


def toy_root(tmp: str, cell: str = "rn50_pretrain") -> str:
    """A root holding BENCHMARK.json and a copy of perfbench/ with the cell
    ``toy``, made from ``cell``'s configuration and traffic."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "workloads", f"{cell}.json")) as f:
        workload = json.load(f)
    with open(os.path.join(pb, "configs", f"{workload['config']}.json")) as f:
        cfg = json.load(f)
    cfg.update(batch_size=8, use_pallas=False, precision="32")
    cfg["augmentation_params"]["resize_shape"] = [32, 32]
    with open(os.path.join(pb, "traffic", f"{workload['traffic']}.json")) as f:
        traffic = json.load(f)
    traffic.update(corpus_size=64, crop_side=64, shard_size=24, traced_steps=2)
    for kind, body in (("configs", cfg), ("traffic", traffic),
                       ("workloads", {"config": "toy", "traffic": "toy", "chips": 1,
                                      "limits": TOY_LIMITS})):
        with open(os.path.join(pb, kind, "toy.json"), "w") as f:
            json.dump(body, f)
    return root


def run_toy(root: str, seed: int = 11, seconds: float = 1.0) -> dict:
    """One run of the toy cell on the CPU, past the harness's look for a card."""
    import time

    import torch

    from perfbench import run
    from perfbench.spec import load_spec

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return run.run_cell(load_spec(root, "toy"), seed, seconds, False, "cpu",
                        time.perf_counter())
