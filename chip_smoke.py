#!/usr/bin/env python3
"""Drives the PyTorch port (``simhand_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the CUDA kernels from ``simhand_tpu_torch/csrc`` into ``build/``
   and prints the card's name and power limit;
2. holds each of the four NT-Xent kernels against its plain PyTorch version
   in float32 (TF32 off) at three shapes: the training step's 512 x 512, a
   512-row shard against 16384 columns, and 16384 x 16384 (8192 pairs, the
   paper's global batch on one card); denominators within rtol 1e-5,
   gradients within 1e-5 * max|G|; times each with CUDA events over
   back-to-back calls (host enqueue included) and with torch.profiler
   (the device time of its kernels alone);
3. runs the simhand_w pre-training step as ``bench.py`` builds it
   (ResNet-50, 128x128, bf16, B = 256 pairs, use_pallas=True, LARS) on a
   synthetic batch made on the card from ``--seed``: the step-0 loss and
   the gradient w.r.t. the projections must match the dense route, the
   losses must be finite, the parameters must change at step 1, kernels
   #2 and #4 must launch on every step; then img/s of the kernel route and
   of the dense route, timed in turns, one eval step, and a torch.profiler
   breakdown of three kernel-route steps with the share of their wall time
   in which the card ran no kernel (profiler on);
4. runs two steps of the plain family (simhand-base), which must launch
   kernels #1 and #3 on every step.

Any failure ends the run with a non-zero exit code. The last line of the
output is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit as ``nvidia-smi`` gives them, and the JSON
record of the kernels comes before that.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

# published peaks of one H100 SXM (dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SOURCE = "simhand_tpu_torch/csrc/ntxent.cu"
REPLACES = {
    "ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:76",
    "weighted_ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:154",
    "ntxent_grad": "simhand_tpu/losses/pallas_ntxent.py:236",
    "weighted_grad_rows": "simhand_tpu/losses/pallas_ntxent.py:596",
}
SHAPES = (("512x512", 512, 512, 0), ("512x16384", 512, 16384, 4096),
          ("16384x16384", 16384, 16384, 0))
MAIN_SHAPE = "512x512"
AUGMENTATION = ("crop", "rotate", "resize")
# the step bench.py builds, at the smallest batch that takes the kernel route
RESNET, SIDE, PAIRS = "50", 128, 256
STEPS, TIMED_STEPS, PLAIN_STEPS, PROFILED_STEPS = 5, 10, 2, 3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls: the torch.profiler time of
    the kernels it launched, without the host's enqueue time or the gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    require(total_us > 0, "the profiler saw no device time")
    return total_us / iters / 1e3


def bound(name: str, m: int, n: int) -> tuple[float, str]:
    """Least time for the work: bytes (each input read once, each output
    written once) over the memory rate, or float32 operations over the
    float32 rate, whichever is larger. Per (row, column) pair: 2*128 for
    the dot product; exp, divide, mask and sum 3; the weighted kernels 21 *
    7 for the joint distances (sqrt counted as one operation) and 4 for the
    weight; the gradients 2*128 more for the second product and 2 for the
    (1/neg_m + 1/neg_j) factor."""
    d, weighted, grad = 128, "weighted" in name, "grad" in name
    per_pair = 2 * d + 3 + (21 * 7 + 4 if weighted else 0) + (2 * d + 2 if grad else 0)
    ops = float(m) * n * per_pair
    nbytes = 4 * ((m + n) * d + m)                          # z_rows, z_cols, row_ids
    nbytes += 4 * ((m + n) * 42 + 2) if weighted else 0     # joints, [d_max, d_min]
    nbytes += 4 * (m + n) if grad else 0                    # 1/neg rows and columns
    nbytes += 4 * m * (d if grad else 1)                    # output
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def kernel_phase(seed: int) -> dict:
    """Each kernel against its plain version at the three shapes."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.losses.weights import pairwise_minmax

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in REPLACES}
    for label, m, n, offset in SHAPES:
        z_cols = torch.randn(n, 128, device="cuda", generator=gen)
        z_cols = z_cols / z_cols.norm(dim=1, keepdim=True)
        j_cols = torch.rand(n, 21, 2, device="cuda", generator=gen) * 128.0
        z_rows = z_cols[offset:offset + m].contiguous()
        j_rows = j_cols[offset:offset + m].contiguous()
        row_ids = torch.arange(offset, offset + m, dtype=torch.int32, device="cuda")
        col_ids = torch.arange(n, dtype=torch.int32, device="cuda")
        d_min, d_max = pairwise_minmax(j_cols, "mpjpe")
        inv_cols = 1.0 / K.ntxent_denominator_plain(z_cols, z_cols, col_ids, 0.5)
        inv_rows = inv_cols[offset:offset + m].contiguous()
        args = {
            "ntxent_denominator": (z_rows, z_cols, row_ids, 0.5),
            "weighted_ntxent_denominator": (z_rows, z_cols, j_rows, j_cols, row_ids,
                                            d_max, d_min, 0.5),
            "ntxent_grad": (z_rows, z_cols, inv_rows, inv_cols, row_ids, 0.5),
            "weighted_grad_rows": (z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols,
                                   row_ids, d_max, d_min, 0.5),
        }
        for name, a in args.items():
            kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
            got, want = kernel(*a), plain(*a)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if "grad" in name:
                limit = 1e-5 * float(want.abs().max())
                require(err <= limit, f"{name} {label}: max abs err {err} > {limit}")
            else:
                rel = float(((got - want).abs() / want.abs()).max())
                require(rel <= 1e-5, f"{name} {label}: max rel err {rel} > 1e-5")
            iters = 50 if m * n <= 512 * 16384 else 5
            ms = cuda_ms(lambda: kernel(*a), iters)
            dev_ms = device_ms(lambda: kernel(*a), iters)
            plain_ms = cuda_ms(lambda: plain(*a), max(iters // 5, 2))
            bound_ms, bound_by = bound(name, m, n)
            report[name][label] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                                   "bound_by": bound_by}
            print(f"kernel {name} {label}: max_abs_err={err:.3e} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})")
        del args, z_cols, j_cols, z_rows, j_rows, inv_cols, inv_rows
        torch.cuda.empty_cache()
    return report


def synthetic_batch(seed: int) -> dict:
    """The batch keys of bench.py, made on the card from ``seed``."""
    import torch

    b, side = PAIRS, SIDE
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, device="cuda", generator=gen)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    return {
        "transformed_image1": normal(b, side, side, 3),
        "transformed_image2": normal(b, side, side, 3),
        "jitter_x_1": uniform(-10, 0, b), "jitter_x_2": uniform(-10, 0, b),
        "jitter_y_1": uniform(-10, 0, b), "jitter_y_2": uniform(-10, 0, b),
        "angle_1": uniform(-45, 45, b), "angle_2": uniform(-45, 45, b),
        "joints1_aug": uniform(0, side, b, 21, 3), "joints2_aug": uniform(0, side, b, 21, 3),
        "joints1_ori": uniform(0, 1, b, 21, 3), "joints2_ori": uniform(0, 1, b, 21, 3),
    }


def compare_routes(state, batch, cfg):
    """The loss and dL/dprojections of both routes from the same
    projections of a copy of the state. Returns that copy, on which the
    caller runs the dense route's step 0."""
    import torch

    from simhand_tpu_torch.models import contrastive_loss_from_projections

    ref = copy.deepcopy(state)
    ref.model.train()
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    with torch.no_grad():
        proj = ref.model(images)[1]
    grads = {}
    for route, c in (("kernel", cfg), ("dense", dataclasses.replace(cfg, use_pallas=False))):
        p = proj.clone().requires_grad_()
        loss, _ = contrastive_loss_from_projections(p, batch, c)
        grads[route] = (float(loss.detach()), torch.autograd.grad(loss, p)[0])
    (lk, gk), (ld, gd) = grads["kernel"], grads["dense"]
    g_err = float((gk - gd).abs().max())
    g_max = float(gd.abs().max())
    print(f"step 0 routes: loss kernel={lk:.7f} dense={ld:.7f}; "
          f"dL/dproj max abs diff {g_err:.3e} (max {g_max:.3e})")
    require(abs(lk - ld) <= 1e-4 * abs(ld), "kernel and dense losses differ")
    require(g_err <= 1e-3 * g_max, "kernel and dense projection gradients differ")
    return ref


def timed(step, state, batch, n: int):
    """Runs n steps; returns the state, the last loss and s/step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, batch)
    last = float(metrics["contrastive_loss"])             # waits for the card
    return state, last, (time.perf_counter() - t0) / n


def profile_steps(step, state, batch, n: int = PROFILED_STEPS) -> dict:
    """Device time by kernel over n steps (torch.profiler), and the share of
    the same steps' wall time in which the card ran no kernel. The profiler
    slows the host, which lengthens the idle time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e6
    print(f"profile: {n} steps, wall {wall * 1e3:.3f} ms/step, kernels {busy * 1e3:.3f} "
          f"ms/step, device idle {100 * (1 - busy / wall):.1f}% (profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / n / 1e3
        print(f"profile: {ms:8.3f} ms/step {100 * ms / (busy * 1e3):5.1f}%  "
              f"x{e.count // n}  {e.key[:100]}")
    # the NT-Xent tile kernels and their split-sum pass (csrc/ntxent.cu)
    ntxent = [e for e in kernels if "ntxent_tile_kernel" in e.key or "sum_splits" in e.key]
    ntxent_ms = sum(e.self_device_time_total for e in ntxent) / n / 1e3
    print(f"profile: NT-Xent kernels {ntxent_ms:.4f} ms/step "
          f"({sum(e.count for e in ntxent) // n} launches/step)")
    return {"profile_wall_ms": wall * 1e3, "profile_kernel_ms": busy * 1e3,
            "profile_idle_share": 1 - busy / wall, "profile_ntxent_ms": ntxent_ms}


def main_path(seed: int):
    """The simhand_w step at B = 256 pairs, as bench.py builds it."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
    from simhand_tpu_torch.train import (
        OptimizerConfig,
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    model = ContrastiveModel(RESNET, dtype=torch.bfloat16)
    opt_cfg = OptimizerConfig(train_iters_per_epoch=1000, epochs=100, warmup_epochs=10)
    state = create_train_state(model, opt_cfg, seed, input_shape=(2, SIDE, SIDE, 3),
                               device="cuda")
    cfg = ContrastiveConfig(experiment_type="simhand_w", augmentation=AUGMENTATION,
                            image_side=float(SIDE), use_pallas=True)
    batch = synthetic_batch(seed)
    ref = compare_routes(state, batch, cfg)
    dense_step = make_train_step(ref.model, dataclasses.replace(cfg, use_pallas=False))
    ref, dense_loss, _ = timed(dense_step, ref, batch, 1)

    step = make_train_step(model, cfg)
    K.reset_launches()
    losses = []
    for i in range(STEPS):
        before = [p.detach().clone() for p in state.params] if i == 1 else None
        state, metrics = step(state, batch)
        losses.append(float(metrics["contrastive_loss"]))
        if before is not None:
            changed = any(not torch.equal(p, q) for p, q in zip(before, state.params))
            require(changed, "no parameter changed at step 1")
            del before
    # the two routes in turns: kernel, dense, dense, kernel
    times = {"kernel": [], "dense": []}
    for route in ("kernel", "dense", "dense", "kernel"):
        if route == "kernel":
            state, last, dt = timed(step, state, batch, TIMED_STEPS)
        else:
            ref, _, dt = timed(dense_step, ref, batch, TIMED_STEPS)
        times[route].append(dt)
    eval_loss = float(make_eval_step(model, cfg)(state, batch)["contrastive_loss"])
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}

    print(f"main path losses: {losses} then {last} after {2 * TIMED_STEPS} timed steps; "
          f"eval {eval_loss}")
    require(all(math.isfinite(v) for v in losses + [last, eval_loss]), "non-finite loss")
    require(abs(losses[0] - dense_loss) <= 1e-4 * abs(dense_loss),
            f"step-0 loss {losses[0]} differs from the dense route's {dense_loss}")
    n_train = STEPS + 2 * TIMED_STEPS
    require(launches["weighted_ntxent_denominator"] == n_train + 1,
            f"weighted denominator launches {launches}")
    require(launches["weighted_grad_rows"] == n_train, f"weighted grad launches {launches}")
    print(f"main path launches {launches}")
    del ref

    step_s, dense_s = (sum(v) / len(v) for v in (times["kernel"], times["dense"]))
    perf = {"pairs_per_step": PAIRS, "step_ms": step_s * 1e3, "img_per_s": PAIRS / step_s,
            "dense_step_ms": dense_s * 1e3, "dense_img_per_s": PAIRS / dense_s,
            "step_ms_blocks": {k: [t * 1e3 for t in v] for k, v in times.items()}}
    print(f"main path: kernel route {step_s * 1e3:.2f} ms/step, "
          f"{PAIRS / step_s:.1f} img/s; dense route {dense_s * 1e3:.2f} ms/step, "
          f"{PAIRS / dense_s:.1f} img/s (img = one pair, as bench.py counts; "
          f"blocks {perf['step_ms_blocks']})")
    perf.update(profile_steps(step, state, batch))
    return state, batch, launches, perf


def plain_family(state, batch) -> dict:
    """simhand-base steps through kernels #1 and #3."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import ContrastiveConfig
    from simhand_tpu_torch.train import make_train_step

    cfg = ContrastiveConfig(experiment_type="simhand-base", augmentation=AUGMENTATION,
                            image_side=float(SIDE), use_pallas=True)
    step = make_train_step(state.model, cfg)
    K.reset_launches()
    losses = []
    for _ in range(PLAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["contrastive_loss"]))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    print(f"plain family (simhand-base) losses {losses}; launches {launches}")
    require(all(math.isfinite(v) for v in losses), "non-finite plain-family loss")
    require(launches["ntxent_denominator"] == PLAIN_STEPS
            and launches["ntxent_grad"] == PLAIN_STEPS,
            f"plain kernels did not launch on every step: {launches}")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from simhand_tpu_torch import native
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = native.build("ntxent")
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text().strip())
    card = card_line()
    print(card)

    report = kernel_phase(args.seed)
    state, batch, main_launches, perf = main_path(args.seed)
    plain_launches = plain_family(state, batch)

    kernels = []
    for name, shapes in report.items():
        path_launches = main_launches if name.startswith("weighted") else plain_launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": path_launches[name], **shapes[MAIN_SHAPE], "library_ms": None,
            "at": shapes,
        })
    for k in kernels:
        print(f"kernel {k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
              f"ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} at {MAIN_SHAPE}")
    print(json.dumps({"step": perf, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
