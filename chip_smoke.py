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
4. holds each of the four fused BN+ReLU backward kernels (#5-#8, csrc/
   bn_epilogue.cu) against its plain PyTorch version in bf16 and float32 at
   the ResNet-50 step's stem (2,097,152 x 64), layer1-bn3 (524,288 x 256)
   and layer4-bn3 (8,192 x 2,048) sites and a ragged 1,000 x 96: sums
   within rel 1e-5 of their largest, no mask differences, dx and dres
   equal bit for bit; times each (CUDA
   events, torch.profiler, the plain version, the byte bound) and, at the
   stem and layer1 sites, the exact route's backward it replaces;
5. runs the same step through the fused BN+ReLU encoder
   (bn_fused="epilogue"): its step-0 loss must equal bn_fused=
   "epilogue_xla"'s bit for bit and the exact route's within rel 1e-2, its
   gradients must agree with epilogue_xla's; five steps with finite losses
   and parameters that change, kernels #5/#6 launched 33 times and #7/#8
   16 times per step, #2/#4 once; the exact, epilogue and epilogue_xla
   routes timed in turns, one eval step, a torch.profiler breakdown;
6. runs two steps of the plain family (simhand-base), which must launch
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
from concurrent.futures import ThreadPoolExecutor

# published peaks of one H100 SXM (dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SOURCES = {"ntxent": "simhand_tpu_torch/csrc/ntxent.cu",
           "bn_epilogue": "simhand_tpu_torch/csrc/bn_epilogue.cu"}
REPLACES = {
    "ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:76",
    "weighted_ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:154",
    "ntxent_grad": "simhand_tpu/losses/pallas_ntxent.py:236",
    "weighted_grad_rows": "simhand_tpu/losses/pallas_ntxent.py:596",
}
BN_REPLACES = {
    "masked_dual_reduce": "simhand_tpu/models/bn_epilogue.py:127",
    "masked_dx": "simhand_tpu/models/bn_epilogue.py:162",
    "masked_dual_reduce_res": "simhand_tpu/models/bn_epilogue.py:325",
    "masked_dx_res": "simhand_tpu/models/bn_epilogue.py:342",
}
# NCHW sites of the ResNet-50 step at 128x128 and 512 images, and a ragged one
BN_SHAPES = (("stem", (512, 64, 64, 64)), ("layer1_bn3", (512, 256, 32, 32)),
             ("layer4_bn3", (512, 2048, 4, 4)), ("ragged", (8, 96, 5, 25)))
BN_MAIN_SHAPE = {"masked_dual_reduce": "stem", "masked_dx": "stem",
                 "masked_dual_reduce_res": "layer1_bn3", "masked_dx_res": "layer1_bn3"}
# launches per train step: the stem and bn1/bn2 of 16 bottlenecks; 16 bn3
BN_PER_STEP = {"masked_dual_reduce": 33, "masked_dx": 33,
               "masked_dual_reduce_res": 16, "masked_dx_res": 16}
SHAPES = (("512x512", 512, 512, 0), ("512x16384", 512, 16384, 4096),
          ("16384x16384", 16384, 16384, 0))
MAIN_SHAPE = "512x512"
AUGMENTATION = ("crop", "rotate", "resize")
# the step bench.py builds, at the smallest batch that takes the kernel route
RESNET, SIDE, PAIRS = "50", 128, 256
STEPS, TIMED_STEPS, PLAIN_STEPS, PROFILED_STEPS = 5, 10, 2, 3
# step 0 of bn_fused="epilogue" against "epilogue_xla": each parameter
# gradient relative to its norm, and all of them together
# (measured on an H100: worst 9.0e-2, the stem's bn1.bias, a sum that
# nearly cancels; all 1.7e-2). The kernels add the per-channel sums in
# another order than torch.sum, so k1 and k2 differ in their last bits, a
# bf16 dx element may round the other way, and 49 train-mode BatchNorm
# backwards carry that to the stem; epilogue_path prints the same
# comparison of the epilogue step with itself beside it.
GRAD_TENSOR_RTOL, GRAD_ALL_RTOL = 0.25, 0.05
# step 0 of bn_fused="epilogue" against the exact route (measured 5.4e-5):
# the epilogue rounds the bf16 affine twice (x*A, then +B) where cuDNN's
# BatchNorm rounds once
LOSS_EXACT_RTOL = 5e-4


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
    out = {"profile_wall_ms": wall * 1e3, "profile_kernel_ms": busy * 1e3,
           "profile_idle_share": 1 - busy / wall}
    # the port's kernels and their second passes, by source
    for group, names in (("ntxent", ("ntxent_tile_kernel", "sum_splits")),
                         ("bn_epilogue", ("bn_masked_", "bn_sum_partials"))):
        mine = [e for e in kernels if any(k in e.key for k in names)]
        ms = sum(e.self_device_time_total for e in mine) / n / 1e3
        print(f"profile: {group} kernels {ms:.4f} ms/step "
              f"({sum(e.count for e in mine) // n} launches/step)")
        out[f"profile_{group}_ms"] = ms
    return out


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
    perf = {"step0_loss": losses[0], "pairs_per_step": PAIRS, "step_ms": step_s * 1e3,
            "img_per_s": PAIRS / step_s,
            "dense_step_ms": dense_s * 1e3, "dense_img_per_s": PAIRS / dense_s,
            "step_ms_blocks": {k: [t * 1e3 for t in v] for k, v in times.items()}}
    print(f"main path: kernel route {step_s * 1e3:.2f} ms/step, "
          f"{PAIRS / step_s:.1f} img/s; dense route {dense_s * 1e3:.2f} ms/step, "
          f"{PAIRS / dense_s:.1f} img/s (img = one pair, as bench.py counts; "
          f"blocks {perf['step_ms_blocks']})")
    perf.update(profile_steps(step, state, batch))
    return state, batch, launches, perf


def bn_bound(name: str, m: int, c: int, esize: int) -> tuple[float, str]:
    """Least time of a BN kernel: bytes (each (M, C) plane read or written
    once, the float32 per-channel vectors once) over the memory rate, or its
    float32 operations per element over the float32 rate, the larger."""
    res, dx = name.endswith("_res"), "dx" in name
    planes = 2 + res + (1 + res if dx else 0)            # g, x, r; dx, dres
    vectors = 7 if dx else 4 + 2                           # constants; the sums
    ops = float(m) * c * ((11 if dx else 8) + res)
    t_bytes = (planes * m * c * esize + 4 * vectors * c) / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def exact_backward_ms(x, r, g, iters: int) -> float:
    """The exact route's backward at a site: ReLU backward and the BatchNorm
    backward of F.batch_norm through autograd (the port's BatchNorm2d)."""
    import torch

    from simhand_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).cuda()
    xx = x.detach().requires_grad_()
    inputs = [xx, bn.weight, bn.bias]
    y = bn(xx)
    if r is not None:
        rr = r.detach().requires_grad_()
        inputs.append(rr)
        y = y + rr
    y = torch.relu(y)
    return cuda_ms(lambda: torch.autograd.grad(y, inputs, g, retain_graph=True), iters)


def bn_kernel_phase(seed: int) -> dict:
    """Kernels #5-#8 against their plain versions, bf16 and float32, at the
    sites of BN_SHAPES."""
    import torch

    from simhand_tpu_torch.models import bn_epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in BN_REPLACES}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for label, shape in BN_SHAPES:
            def plane():
                t = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                return t.contiguous(memory_format=torch.channels_last)

            x, r, g = plane(), plane(), plane()
            c = shape[1]
            m = x.numel() // c
            scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
            bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
            mu, _, inv = E.batch_stats(x, 1e-5)
            cs = list(E._affine_consts(mu, inv, scale, bias))
            P = scale * inv
            g2d, x2d, r2d = E.as_rows(g), E.as_rows(x), E.as_rows(r)
            k = [v / m for v in E.masked_dual_reduce_plain(g2d, x2d, *cs)]
            kr = [v / m for v in E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)]
            cases = {
                "masked_dual_reduce": (lambda: E.masked_dual_reduce(g, x, *cs),
                                       lambda: E.masked_dual_reduce_plain(g2d, x2d, *cs)),
                "masked_dx": (lambda: E.masked_dx(g, x, *cs, P, *k),
                              lambda: E.masked_dx_plain(g2d, x2d, *cs, P, *k)),
                "masked_dual_reduce_res": (
                    lambda: E.masked_dual_reduce_res(g, x, r, *cs),
                    lambda: E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)),
                "masked_dx_res": (
                    lambda: E.masked_dx_res(g, x, r, *cs, P, *kr),
                    lambda: E.masked_dx_res_plain(g2d, x2d, r2d, *cs, P, *kr)),
            }
            big = m * c >= 10**8
            for name, (kernel, plain) in cases.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                row = {}
                if "dx" not in name:
                    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    require(max(rels) <= 1e-5, f"{name} {label} {tag}: sums rel err {rels}")
                else:
                    got = (got,) if not isinstance(got, tuple) else got
                    want = (want,) if not isinstance(want, tuple) else want
                    got = [E.as_rows(t) for t in got]
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want))
                    row["not_bit_equal"] = sum(int((a != b).sum()) for a, b in zip(got, want))
                    if name == "masked_dx_res":
                        row["mask_diffs"] = int(((got[1] != 0) != (want[1] != 0)).sum())
                        require(row["mask_diffs"] == 0, f"{name} {label} {tag}: mask differs")
                    # the same float32 operations, each rounded, in the same
                    # order: bit for bit in both dtypes (a mask difference
                    # would show here too)
                    require(row["not_bit_equal"] == 0,
                            f"{name} {label} {tag}: {row['not_bit_equal']} elements differ, "
                            f"max abs err {err}")
                row["max_abs_err"] = err
                row["ms"] = cuda_ms(kernel, 20 if big else 50)
                if dtype == torch.bfloat16:
                    row["device_ms"] = device_ms(kernel, 10)
                row["plain_ms"] = cuda_ms(plain, 5)
                row["bound_ms"], row["bound_by"] = bn_bound(name, m, c, x.element_size())
                report[name][f"{label}_{tag}"] = row
                print(f"bn kernel {name} {label} {tag} ({m}x{c}): " + " ".join(
                    f"{k_}={v:.4g}" if isinstance(v, float) else f"{k_}={v}"
                    for k_, v in row.items()))
            if dtype == torch.bfloat16 and label in ("stem", "layer1_bn3"):
                res = label == "layer1_bn3"
                exact = exact_backward_ms(x, r if res else None, g, 20)
                pair = ("masked_dual_reduce_res", "masked_dx_res") if res else (
                    "masked_dual_reduce", "masked_dx")
                for name in pair:
                    report[name][f"{label}_{tag}"]["exact_pair_ms"] = exact
                print(f"bn exact route backward {label} bf16: {exact:.4f} ms against the pair "
                      f"{sum(report[n][f'{label}_{tag}']['ms'] for n in pair):.4f} ms")
            del cases, x, r, g, g2d, x2d, r2d
            torch.cuda.empty_cache()
    return report


def step0(state, batch, cfg):
    """Train-mode loss and parameter gradients of one forward and backward."""
    import torch

    from simhand_tpu_torch.models import contrastive_loss_from_projections

    model = state.model.train()
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    _, proj = model(images)
    loss, _ = contrastive_loss_from_projections(proj, batch, cfg)
    return float(loss.detach()), torch.autograd.grad(loss, state.params)


def bn_site_bound(model) -> tuple[list, object]:
    """Forward hooks on the BNRelu sites that record each site's (M, C,
    element size, residual); returns the list and the hooks' handles."""
    from simhand_tpu_torch.models.bn_epilogue import BNRelu

    sites, handles = [], []

    def hook(module, args, _out):
        x = args[0]
        if module.training:
            sites.append((x.numel() // x.shape[1], x.shape[1], x.element_size(),
                          len(args) > 1 and args[1] is not None))

    for mod in model.modules():
        if isinstance(mod, BNRelu):
            handles.append(mod.register_forward_hook(hook))
    return sites, handles


def epilogue_path(seed: int, exact_state, batch, exact_loss0: float) -> tuple[dict, dict]:
    """The simhand_w step through the fused BN+ReLU encoder."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.train import (
        OptimizerConfig,
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    opt_cfg = OptimizerConfig(train_iters_per_epoch=1000, epochs=100, warmup_epochs=10)
    cfg = ContrastiveConfig(experiment_type="simhand_w", augmentation=AUGMENTATION,
                            image_side=float(SIDE), use_pallas=True)
    states = {}
    for bn_fused in ("epilogue", "epilogue_xla"):
        model = ContrastiveModel(RESNET, dtype=torch.bfloat16, bn_fused=bn_fused)
        states[bn_fused] = create_train_state(model, opt_cfg, seed,
                                              input_shape=(2, SIDE, SIDE, 3), device="cuda")
    (le, ge), (lx, gx), (_, ge2) = (step0(states[k], batch, cfg)
                                    for k in ("epilogue", "epilogue_xla", "epilogue"))
    names = [n for n, _ in states["epilogue"].model.named_parameters()]

    def grad_diff(got, want):
        errs = [float((a - b).double().norm() / b.double().norm()) for a, b in zip(got, want)]
        total = (sum(float((a - b).double().norm()) ** 2 for a, b in zip(got, want))
                 / sum(float(b.double().norm()) ** 2 for b in want)) ** 0.5
        worst = max(range(len(errs)), key=errs.__getitem__)
        return errs[worst], names[worst], total

    worst, worst_name, total = grad_diff(ge, gx)
    self_worst, self_name, self_total = grad_diff(ge2, ge)
    print(f"epilogue step 0: loss epilogue={le!r} epilogue_xla={lx!r} exact={exact_loss0!r}; "
          f"gradients vs epilogue_xla: worst {worst_name} {worst:.3e} of its norm, all "
          f"{total:.3e}; the epilogue against itself: worst {self_name} {self_worst:.3e}, "
          f"all {self_total:.3e}")
    require(le == lx, f"epilogue step-0 loss {le!r} != epilogue_xla's {lx!r}")
    require(abs(le - exact_loss0) <= LOSS_EXACT_RTOL * abs(exact_loss0),
            f"epilogue step-0 loss {le} differs from the exact route's {exact_loss0}")
    require(worst <= GRAD_TENSOR_RTOL and total <= GRAD_ALL_RTOL,
            "epilogue gradients differ from epilogue_xla's")
    del ge, gx, ge2

    state, xla_state = states["epilogue"], states["epilogue_xla"]
    step = make_train_step(state.model, cfg)
    xla_step = make_train_step(xla_state.model, cfg)
    exact_step = make_train_step(exact_state.model, cfg)
    sites, handles = bn_site_bound(state.model)
    E.reset_launches()
    K.reset_launches()
    losses = []
    for i in range(STEPS):
        before = [p.detach().clone() for p in state.params] if i == 1 else None
        state, metrics = step(state, batch)
        losses.append(float(metrics["contrastive_loss"]))
        if before is not None:
            require(any(not torch.equal(p, q) for p, q in zip(before, state.params)),
                    "no parameter of the epilogue model changed at step 1")
            del before
        if i == 0:
            for h in handles:
                h.remove()
    ntx = {fn.__name__: fn.launches for fn in K.KERNELS}
    bn = {fn.__name__: fn.launches for fn in E.KERNELS}
    print(f"epilogue path losses {losses}; launches after {STEPS} steps {bn}, NT-Xent {ntx}")
    require(all(math.isfinite(v) for v in losses), "non-finite epilogue loss")
    require(all(bn[n] == BN_PER_STEP[n] * STEPS for n in bn), f"BN kernel launches {bn}")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every epilogue step: {ntx}")
    step_bound = sum(bn_bound(n, m, c, es)[0] for m, c, es, res in sites
                     for n in (("masked_dual_reduce_res", "masked_dx_res") if res else
                               ("masked_dual_reduce", "masked_dx")))
    print(f"epilogue sites per step: {len(sites)} ({sum(s[3] for s in sites)} with a "
          f"residual); byte bound of #5-#8 {step_bound:.4f} ms/step")

    times = {"exact": [], "epilogue": [], "epilogue_xla": []}
    for route in ("exact", "epilogue", "epilogue_xla", "epilogue_xla", "epilogue", "exact"):
        if route == "exact":
            exact_state, _, dt = timed(exact_step, exact_state, batch, TIMED_STEPS)
        elif route == "epilogue":
            state, last, dt = timed(step, state, batch, TIMED_STEPS)
        else:
            xla_state, _, dt = timed(xla_step, xla_state, batch, TIMED_STEPS)
        times[route].append(dt)
    eval_loss = float(make_eval_step(state.model, cfg)(state, batch)["contrastive_loss"])
    require(math.isfinite(last) and math.isfinite(eval_loss), "non-finite epilogue loss")
    launches = {fn.__name__: fn.launches for fn in E.KERNELS}
    n_train = STEPS + 2 * TIMED_STEPS
    require(all(launches[n] == BN_PER_STEP[n] * n_train for n in launches),
            f"BN kernel launches over the epilogue path {launches}")
    mean_ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
    print("epilogue path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; eval {eval_loss}; blocks {times}")
    perf = {"step0_loss": le, "step0_grad_worst_rel": worst, "step0_grad_all_rel": total,
            "step0_self_worst_rel": self_worst, "step0_self_all_rel": self_total,
            "step_ms": mean_ms, "bn_bound_ms_per_step": step_bound,
            "step_ms_blocks": {k: [t * 1e3 for t in v] for k, v in times.items()}}
    perf.update(profile_steps(step, state, batch))
    del states, state, xla_state
    return launches, perf


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
    # one nvcc for each source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(native.build, SOURCES))
    print(f"built {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    card = card_line()
    print(card)

    report = kernel_phase(args.seed)
    bn_report = bn_kernel_phase(args.seed)
    state, batch, main_launches, perf = main_path(args.seed)
    bn_launches, bn_perf = epilogue_path(args.seed, state, batch, perf["step0_loss"])
    plain_launches = plain_family(state, batch)

    kernels = []
    for name, shapes in report.items():
        path_launches = main_launches if name.startswith("weighted") else plain_launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["ntxent"],
            "replaces": REPLACES[name], "launches": path_launches[name],
            **shapes[MAIN_SHAPE], "library_ms": None, "at": shapes,
        })
    for name, shapes in bn_report.items():
        main_row = shapes[f"{BN_MAIN_SHAPE[name]}_bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["bn_epilogue"],
            "replaces": BN_REPLACES[name], "launches": bn_launches[name],
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
            "library_ms": None, "exact_pair_ms": main_row["exact_pair_ms"],
            "at": shapes,
        })
    for k in kernels:
        print(f"kernel {k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
              f"ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f}")
    print(json.dumps({"step": perf, "epilogue_step": bn_perf, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
