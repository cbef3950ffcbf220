"""Runs one cell of the benchmark once and prints its result as the last line
of standard output:

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's driver sets up the program under test (the corpus, the weights
from ``--seed``, its checked steps, its warm-up), then the window steps it
for ``--seconds`` and ends in a synchronize. With ``--trace 1`` the window is
followed by a profiled session of the traffic's ``traced_steps``; the line
then holds the per-layer metrics, else the end-to-end ones. Last, the
program's state is freed and its checked steps are compared with the plain
reference; each number compared is printed beside its limit, on standard
error and under the line's last key, ``checks``.

It exits with 2 and prints no result where the cell's cards are not there,
and with 3 where JAX or the JAX package was loaded in this process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "simhand_tpu")
TOP = 10


def cache_dirs(root: str) -> str:
    """Every build and kernel cache inside the checkout, at fixed paths;
    returns the harness's own work directory (the corpus)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
    return os.path.join(build, "perfbench")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``simhand_tpu_torch`` is not ``simhand_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: object
    setup_s: float
    steps: int
    samples: int
    window_s: float
    feed_wait_s: float
    window_peak_bytes: int | None
    trace: object | None


def read_metrics(spec, entries: list[dict], ctx: Context) -> dict:
    from perfbench.spec import load_module

    out = {}
    for entry in entries:
        module = load_module(spec.root, "metrics", entry["name"])
        if module.UNIT != entry["unit"]:
            raise ValueError(f"{entry['name']}: the reader's unit {module.UNIT!r} is not "
                             f"BENCHMARK.json's {entry['unit']!r}")
        value = module.read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(spec, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``spec``'s cell on ``device``: the result's line as a dict."""
    import torch

    from perfbench.spec import load_module
    from perfbench.trace import profile_steps

    work_dir = cache_dirs(spec.root)
    device = torch.device(device)
    on_card = device.type == "cuda"
    driver = load_module(spec.root, "drivers", spec.config["driver"])
    cell = driver.Cell(spec, seed, device, work_dir)
    cell.setup()
    setup_s = time.perf_counter() - t0
    print(f"perfbench: set-up {setup_s:.2f} s", file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    start = time.perf_counter()
    steps = 0
    while time.perf_counter() - start < seconds:
        cell.step()
        steps += 1
    cell.sync()
    window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    attempted, failed = cell.window_failures()

    traced = None
    if trace:
        traced_steps = int(spec.traffic["traced_steps"])

        def run():
            for _ in range(traced_steps):
                cell.traced_step()
            cell.sync()

        traced = profile_steps(run, traced_steps, cell.launch_counts)
    ctx = Context(cell, setup_s, steps, steps * cell.samples_per_step, window_s,
                  cell.feed_wait_s, window_peak, traced)
    metrics = read_metrics(spec, spec.per_layer if trace else spec.end_to_end, ctx)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": spec.chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak)) if on_card else 0}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        ops = sorted(traced.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        result["breakdown"] = {"device_ops": [[k[:160], v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in traced.idle_gaps[:TOP]]}

    print(f"perfbench: window {steps} steps in {window_s:.3f} s, "
          f"{cell.feed_wait_s / max(steps, 1) * 1e3:.2f} ms a step waiting on the feed",
          file=sys.stderr)
    cell.close_program()
    t = time.perf_counter()
    checks = cell.check(spec.limits)
    print(f"perfbench: reference {time.perf_counter() - t:.2f} s", file=sys.stderr)
    result["correct"] = failed == 0 and all(
        math.isfinite(v) and v <= limit for v, limit in checks.values())
    # a reading that is no number (rows left out) is printed as its name
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": limit}
                        for k, (v, limit) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.spec import load_spec

    spec = load_spec(ROOT, args.workload)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"perfbench: {args.workload} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: this process loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
