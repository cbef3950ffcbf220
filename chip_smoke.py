#!/usr/bin/env python3
"""Drives the PyTorch port (``simhand_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the CUDA kernels (and the host gather of the crop cache) from
   ``simhand_tpu_torch/csrc`` into ``build/``
   and prints the card's name and power limit;
2. holds each of the four NT-Xent kernels against its plain PyTorch version
   in float32 (TF32 off) at three shapes: the training step's 512 x 512, a
   512-row shard against 16384 columns, and 16384 x 16384 (8192 pairs, the
   paper's global batch on one card); denominators within rtol 1e-5,
   gradients within 1e-5 * max|G|; each (three-pass TF32 products on the
   tensor cores, column splits summed in a fixed order) also a second
   launch equal bit for bit; times each with CUDA events over back-to-back
   calls (host enqueue included) and with torch.profiler (the device time
   of its kernels alone), beside its bound and the unit that sets it
   (bytes, the tensor cores' TF32 rate or the CUDA cores' float32 rate);
3. runs the simhand_w pre-training step as ``bench.py`` builds it
   (ResNet-50, 128x128, bf16, B = 256 pairs, use_pallas=True, LARS) on a
   synthetic batch made on the card from ``--seed``: the step-0 loss and
   the gradient w.r.t. the projections must match the dense route, the
   losses must be finite, the parameters must change at step 1, kernels
   #2 and #4 must launch on every step; then img/s of the kernel route and
   of the dense route, timed in turns, one eval step, and a torch.profiler
   breakdown of three kernel-route steps with the share of their wall time
   in which the card ran no kernel (profiler on), each NT-Xent kernel's ms
   and launches a step with its sum pass, and the launches of #2, #4 and
   their sum passes required; then the production input path: a corpus of
   2,048 synthetic 224x224 crops from ``--seed`` (no cv2) written to a
   packed crop cache under ``build/``, raw batches of 256 pairs gathered
   natively by two iterator threads and prefetched through pinned buffers,
   and the same step augmenting both views on the card (crop, rotate,
   resize): finite losses, a parameter change at step 1, #2 and #4 on every
   step, an augmented eval step that gives the same loss twice; the
   composed step, the augmented step on one raw batch held on the card and
   the pre-augmented step timed in turns, the host's assembly rate, the
   pinned link, the feed alone and a profile of the composed step; the
   augmentation alone (events, device ms, top kernels) for the main path's
   flags and for every flag, each also applied on the card and on the CPU
   to one draw (the crop box exactly, the images within 0.05 on the 0-255
   scale on all but 1e-4 of their elements, the joints within 1e-3 px);
4. holds each of the four fused BN+ReLU backward kernels (#5-#8, csrc/
   bn_epilogue.cu) against its plain PyTorch version in bf16 and float32 at
   the ResNet-50 step's stem (2,097,152 x 64), layer1-bn3 (524,288 x 256)
   and layer4-bn3 (8,192 x 2,048) sites and a ragged 1,000 x 96 (#7 on g,
   x and r, #8 on the plain version's dres; #5 also with a gradient that
   is not channels-last): sums within rel 1e-5 of their largest, no mask
   differences in #7's dres, dx and dres equal bit for bit, a second
   launch of each equal bit for bit, the bulk-copy ring taken by #5-#8 at
   the three ResNet sites and the per-element walk at the ragged one (the
   CUDA source's own test, bn_ring_fits); times each (CUDA
   events, torch.profiler, the plain version, its own byte bound) and, at
   the stem (#5+#6) and at layer1-bn3 and layer4-bn3 (#7+#8), the pair's
   bound and the exact route's backward it replaces, by events and by
   torch.profiler;
5. runs the same step through the fused BN+ReLU encoder
   (bn_fused="epilogue"): its step-0 loss must equal bn_fused=
   "epilogue_xla"'s bit for bit and the exact route's within rel 5e-4, its
   gradients must agree with epilogue_xla's; five steps with finite losses
   and parameters that change, kernels #5/#6 launched 33 times and #7/#8
   16 times per step, #2/#4 once, every launch of #5-#8 in step 0 on the
   ring; the exact, epilogue and epilogue_xla routes timed in turns, one
   eval step, a torch.profiler breakdown with each of #5-#8's device ms and
   launches per step (sum passes included; #6 and #8 told apart by their
   template argument) beside its bound over the step's own sites, and #5
   and #6 timed alone at each distinct site;
6. holds the plain family's (simhand-base) step-0 loss and dL/dprojections
   against its dense route on the same projections (rel 1e-4; 1e-3 of the
   largest), runs two steps, which must launch kernels #1 and #3 on every
   step, and profiles three: #1's and #3's ms and launches a step, each
   with its sum pass, the launches required;
7. holds kernel #9 (the two reduces of the plain BatchNorm backward,
   csrc/bn_epilogue.cu) against its plain version in bf16 and float32 at the
   sites of phase 4, also with a gradient that is not channels-last (the
   wrapper copies it): sums within rel 1e-5 of their largest, a second
   launch equal bit for bit, the ring taken at the three ResNet sites and
   the walk at the ragged one; times it (CUDA events, torch.profiler, the
   plain version, the byte bound) beside torch.batch_norm_backward_reduce,
   one PyTorch call of the same function, by CUDA events and by
   torch.profiler: in bf16 #9's device time must be below the library's at
   the stem and layer1-bn3;
8. holds kernels #10 and #11 (the 1x1 convolution with BatchNorm
   statistics, csrc/conv1x1.cu) against their plain versions (cuBLAS in
   float32, TF32 off) at the six kinds of fused site of the ResNet-50 step,
   a ragged 1,000 x 96 -> 40 and 65,535 x 128 + 1 rows, 8 -> 8: every y
   element within one bf16 ulp (plus 2^-16 * sum |x||w| for the float32
   sums' order), s1/s2 within rel 1e-5 of the float64 sums of the kernel's
   own y and within rel 1e-3 of the plain version's, a second launch equal
   bit for bit; times each (CUDA events; torch.profiler, the main kernel
   and the column-sum pass apart; the plain version; the bound and its
   share) beside cuBLAS's x @ w.T of the same shape (events and profiler)
   and their ratio;
9. runs the step with bn_fused="pallas": its step-0 loss must equal
   bn_fused=True's bit for bit and the exact route's within rel 5e-3 (the
   reference's affine rounds A and B to bf16 at every site), its
   gradients must agree with bn_fused=True's; five steps with finite losses
   and parameters that change, kernel #9 launched 53 times per step, each
   launch of step 0 on the ring, #2/#4 once; the exact, pallas and
   bn_fused=True routes timed in turns, one eval step, a torch.profiler
   breakdown with #9's device ms and launches per step (sum passes
   included) beside its bound over the step's sites, and #9 timed alone at
   each distinct site;
10. runs the step with conv1x1_fuse_min_cin=512: its step-0 loss within rel
   5e-4 of the exact route's (its gradients against the exact route's are
   printed: a different bf16 forward, so not held to phase 5's limits); the
   fused site's output and gradients against cuDNN's conv and BatchNorm at
   three of the step's sites, each within 1e-2 of its norm; five steps as
   above with kernel #10 launched 15 times per step, #11 never, #2/#4 once;
   timed in turns with the exact route, a torch.profiler breakdown;
11. holds the convolution kernel (csrc/conv_bias.cu: a bf16 implicit GEMM
   whose float32 sum takes the bias, the residual and ReLU before one
   rounding) against its plain version at each distinct convolution of the
   serving forward (ResNet-50, 128x128, B = 256: the 7x7/2 stem, 1x1 at
   layer1, layer3 and layer4, 3x3 at layer1 and layer4, layer2_0's 3x3/2 and
   its 1x1/2 downsample, layer4's conv3 with the residual) and a ragged
   shape: every y element within one bf16 ulp plus 2^-16 * sum |x||w|, a
   second launch equal bit for bit; times it (CUDA events, torch.profiler,
   the plain version, the bound) beside bf16 cuDNN F.conv2d with the bias;
12. holds kernel #12 (one whole frozen identity bottleneck block, three
   launches of that kernel) against its plain version in bf16 at ResNet-50's
   layer4 at 128x128 and 224x224, layer3 and layer1 at 128x128 and layer2 at
   224x224 (256 images each) and the JAX test's ragged (2, 3) x 4: y within
   rtol = atol = 2e-2 and at most BLOCK_ULP_SHARE of it more than one bf16
   ulp away; times it (CUDA events, torch.profiler, the plain version, the
   bound) beside the same block through cuDNN (CUDA events and
   torch.profiler);
13. runs the frozen bf16 serving forward (ResNet-50, 128x128, B = 256, BN
   folded, random weights and BatchNorm statistics from ``--seed``), every
   convolution on the kernel of phase 11 (53 launches per forward) and
   layer4_1/2 through kernel #12 (2 per forward), with no mixed bf16 +
   float32 add in its profile: embeddings against the bf16 cuDNN walk (the
   yardstick, built here), the float32 folded walk and the model's own bf16
   eval forward; img/s of the three timed in turns, a torch.profiler
   breakdown of the kernel walk and of the cuDNN walk;
14. serves that forward through the micro-batcher on 127.0.0.1 (batch 128):
   eight concurrent requests of mixed sizes, each row equal to the direct
   forward on the same padded batch, /healthz, then requests/s of a burst
   of 256 whose every answer is checked the same way;
15. holds the float32 kernels #10 and #11 (csrc/conv1x1.cu, CUDA-core
   float32, TF32 off) against their plain versions at the six kinds of
   fused site: y within 1e-5 of its largest element, s1/s2 within rel 1e-5
   of the float64 sums of the kernel's own y, a second launch equal bit for
   bit; times each beside cuBLAS's float32 x @ w.T; then two float32 steps
   with conv1x1_fuse_min_cin=512: step-0 loss within rel 1e-5 of the float32
   exact step's, #10 launched 15 times per step.

Any failure ends the run with a non-zero exit code. The last line of the
output is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit as ``nvidia-smi`` gives them, and the JSON
record of the kernels comes before that.
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12

SOURCES = {"ntxent": "simhand_tpu_torch/csrc/ntxent.cu",
           "bn_epilogue": "simhand_tpu_torch/csrc/bn_epilogue.cu",
           "conv1x1": "simhand_tpu_torch/csrc/conv1x1.cu",
           "conv_bias": "simhand_tpu_torch/csrc/conv_bias.cu",
           # host code: the crop cache's gather, built with g++
           "batch_gather": "simhand_tpu_torch/csrc/batch_gather.cpp"}
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
# kernel #9 (in bn_epilogue.cu): main shape the stem; 1 stem + 16 x 3 + 4
# downsample sites per step
FUSED_BN_REPLACES = {"bn_backward_reduces": "simhand_tpu/models/fused_bn.py:182"}
FUSED_BN_PER_STEP = 53
# kernels #10/#11: the fused conv1x1+BN sites of the step at
# conv1x1_fuse_min_cin=512 as (label, M, Cin, Cout, sites per step), a
# ragged shape and one with more rows than 65,535 tiles of 128; main shape
# the most frequent site
CONV_REPLACES = {"conv1x1_stats": "simhand_tpu/ops/conv1x1.py:128",
                 "conv1x1_bn_relu_stats": "simhand_tpu/ops/conv1x1.py:133"}
CONV_SHAPES = (("layer2_conv1", 131072, 512, 128, 3), ("layer3_0_conv1", 131072, 512, 256, 1),
               ("layer3_conv1", 32768, 1024, 256, 5), ("layer4_0_conv1", 32768, 1024, 512, 1),
               ("layer4_conv1", 8192, 2048, 512, 2), ("layer4_conv3", 8192, 512, 2048, 3),
               ("ragged", 1000, 96, 40, 0), ("large_m", 65535 * 128 + 1, 8, 8, 0))
CONV_MAIN_SHAPE = "layer3_conv1"
CONV_FUSE_MIN_CIN, CONV_PER_STEP = 512, 15
# the convolution kernel at each distinct convolution of the serving forward
# (ResNet-50, 128x128, B = 256) as (label, N, H, W, Cin, Cout, kernel,
# stride, padding, relu, residual), and a ragged one; main shape the 3x3 of
# #12 (layer4)
CONV_BIAS_REPLACES = {"conv_bias_act": "simhand_tpu/ops/bottleneck_block.py:92"}
CONV_BIAS_SHAPES = (
    ("stem", 256, 128, 128, 3, 64, 7, 2, ((3, 3), (3, 3)), True, False),
    ("layer1_1x1", 256, 32, 32, 256, 64, 1, 1, "SAME", True, False),
    ("layer1_3x3", 256, 32, 32, 64, 64, 3, 1, "SAME", True, False),
    ("layer2_0_3x3s2", 256, 32, 32, 128, 128, 3, 2, "SAME", True, False),
    ("layer2_0_down", 256, 32, 32, 256, 512, 1, 2, "SAME", False, False),
    ("layer3_1x1", 256, 8, 8, 1024, 256, 1, 1, "SAME", True, False),
    ("layer4_1x1", 256, 4, 4, 2048, 512, 1, 1, "SAME", True, False),
    ("layer4_3x3", 256, 4, 4, 512, 512, 3, 1, "SAME", True, False),
    ("layer4_conv3_res", 256, 4, 4, 512, 2048, 1, 1, "SAME", True, True),
    ("ragged", 3, 9, 11, 40, 72, 3, 2, "SAME", True, True))
CONV_BIAS_MAIN_SHAPE = "layer4_3x3"
# launches per serving forward: the stem, 16 blocks x 3 and 4 downsamples
CONV_BIAS_PER_FORWARD = 53
# kernel #12: identity blocks of ResNet-50 as (label, images, (H, W), C, Cm);
# main shape layer4 of the serving forward at 128x128, B = 256
BLOCK_REPLACES = {"bottleneck_block": "simhand_tpu/ops/bottleneck_block.py:92"}
BLOCK_SHAPES = (("layer4_128", 256, (4, 4), 2048, 512), ("layer4_224", 256, (7, 7), 2048, 512),
                ("layer3_128", 256, (8, 8), 1024, 256), ("layer1_128", 256, (32, 32), 256, 64),
                ("layer2_224", 256, (28, 28), 512, 128), ("ragged_2x3", 4, (2, 3), 256, 128))
BLOCK_MAIN_SHAPE = "layer4_128"
# y against the plain version: the JAX test's rtol = atol = 2e-2, and the
# share of elements more than one bf16 ulp away (float32 sums in another
# order round an element of h1 or h2 to its other neighbour, which moves y;
# measured 0.44-0.51% at layer4 on an H100 by a one-launch design): four
# times that
BLOCK_RTOL, BLOCK_ULP_SHARE = 2e-2, 2e-2
# the serving forward: ResNet-50 at SIDE, SERVE_IMAGES images, the blocks of
# scripts/bench_block.py:64-65 through #12; the server's batch
SERVE_BLOCKS, SERVE_IMAGES, SERVE_TIMED, SERVER_BATCH = ("layer4_1", "layer4_2"), 256, 10, 128
# embeddings of the kernel walk against the cuDNN walk, relative to the
# largest: the two differ by the cuDNN walk's second rounding at every
# convolution, by conv3's rounding before the shortcut's add at two blocks
# and by the sums' order (CPU, ResNet-50 at 64x64: 3.0e-3)
SERVE_WALK_RTOL = 1e-2
# float32 #10/#11 (F2): the step's fused sites, y against cuBLAS's float32
# product (TF32 off) relative to its largest element, the step-0 loss
# against the float32 exact step's, and the float32 steps run
F32_Y_RTOL, F32_LOSS_RTOL, F32_STEPS = 1e-5, 1e-5, 2
SHAPES = (("512x512", 512, 512, 0), ("512x16384", 512, 16384, 4096),
          ("16384x16384", 16384, 16384, 0))
MAIN_SHAPE = "512x512"
# each NT-Xent kernel's profile group, (name, substrings of its kernels'
# names): its main kernel and its own instance of the splits' sum pass
NTXENT_PROFILE_GROUPS = {
    "ntxent_denominator": ("ntxent_denominator", ("plain_denom_kernel", "sum_splits_kernel<1>")),
    "weighted_ntxent_denominator": ("ntxent_weighted_denominator",
                                    ("weighted_denom_kernel", "sum_splits_kernel<2>")),
    "ntxent_grad": ("ntxent_grad", ("plain_grad_kernel", "sum_splits_kernel<3>")),
    "weighted_grad_rows": ("ntxent_weighted_grad", ("weighted_grad_kernel",
                                                    "sum_splits_kernel<4>")),
}
AUGMENTATION = ("crop", "rotate", "resize")
# the step bench.py builds, at the smallest batch that takes the kernel route
RESNET, SIDE, PAIRS = "50", 128, 256
STEPS, TIMED_STEPS, PLAIN_STEPS, PROFILED_STEPS = 5, 10, 2, 3
# the cache-fed phase: a synthetic corpus of CACHE_IMAGES 224x224 crops from
# --seed in shards of CACHE_SHARD, augmented on the card with the main
# path's flags (crop, rotate, resize) into SIDE x SIDE views
CACHE_IMAGES, CACHE_SHARD, CROP = 2048, 512, 224
CACHE_STEPS, AUGMENT_ITERS, LINK_COPIES = 3, 10, 10
# the augmentation on the card against the CPU with the same draws, on the
# 0-255 scale (tests/test_torch_augment.py's WARP_TOL and CHAIN_SHARE): all
# but CHAIN_SHARE of the image elements within WARP_TOL, the crop box
# exactly, the joints within JOINT_TOL px
WARP_TOL, CHAIN_SHARE, JOINT_TOL = 0.05, 1e-4, 1e-3
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
# step 0 of bn_fused="pallas" against the exact route (measured 1.67e-3 on
# an H100): the reference's FusedBatchNorm rounds each channel's A and B to
# bf16 (fused_bn.py:46), a per-channel scale error of up to 2^-9 at all 53
# sites. On the CPU (scripts/torch_bf16_departure.py: ResNet-50, 96 pairs
# at 64x64, bf16) the port departs 2.3e-3 from exact with that affine and
# 2.0e-4 with one float32 rounding; exact bf16 departs 8.3e-4 from exact
# float32. The epilogue rounds the same
# way at 49 sites (5.4e-5 on the card: the departure of a single loss
# varies by far more than its cause between variants).
LOSS_TWO_ROUNDING_RTOL = 5e-3


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


def profiled_kernels(run, least: int = 1, tries: int = 3) -> list:
    """The CUDA kernel rows of torch.profiler's key_averages() over run().
    A session's device records can come back empty (seen on an H100 with
    torch 2.11, many sessions into the process), so a session that
    recorded fewer than ``least`` kernel launches is run again, up to
    ``tries`` sessions, each retry said on stderr; then the script fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels) >= least and sum(
                e.self_device_time_total for e in kernels) > 0:
            return kernels
        print(f"chip_smoke: profiler session {attempt} of {tries} recorded "
              f"{sum(e.count for e in kernels)} kernel launches", file=sys.stderr)
        time.sleep(1.0)
    raise SmokeFailure("the profiler saw no device time")


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Mean device time of fn() over iters calls, by kernel name: the
    torch.profiler time of the kernels it launched, without the host's
    enqueue time or the gaps."""
    def run():
        for _ in range(iters):
            fn()

    fn()
    return {e.key: e.self_device_time_total / iters / 1e3
            for e in profiled_kernels(run, least=iters)}


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, all its kernels together."""
    return sum(device_ms_by_kernel(fn, iters).values())


def bound(name: str, m: int, n: int) -> tuple[float, str, str]:
    """Least time for float32-accurate work: the largest of the bytes (each
    input read once, each output written once) over the memory rate, the
    products on the tensor cores, three TF32 passes at 495 TFLOP/s (2 * 128
    flops a pair for a denominator, 4 * 128 for a gradient), and the rest
    on the CUDA cores at 67 TFLOP/s, per pair: exp, divide, mask and sum 3;
    the weighted kernels 21 * 7 for the joint distances (sqrt counted as
    one operation) and 4 for the weight; the gradients 2 for the (1/neg_m +
    1/neg_j) factor. Returns the ms, "bytes" or "operations", and the unit
    that bounds it: "bytes", "tensor" or "cuda cores"."""
    d, weighted, grad = 128, "weighted" in name, "grad" in name
    pairs = float(m) * n
    t_tensor = 3 * pairs * 2 * d * (2 if grad else 1) / TF32_TENSOR_OPS_PER_S
    t_cuda = pairs * (3 + (21 * 7 + 4 if weighted else 0) + (2 if grad else 0)) / FP32_OPS_PER_S
    nbytes = 4 * ((m + n) * d + m)                          # z_rows, z_cols, row_ids
    nbytes += 4 * ((m + n) * 42 + 2) if weighted else 0     # joints, [d_max, d_min]
    nbytes += 4 * (m + n) if grad else 0                    # 1/neg rows and columns
    nbytes += 4 * m * (d if grad else 1)                    # output
    t_bytes = nbytes / HBM_BYTES_PER_S
    t, unit = max((t_bytes, "bytes"), (t_tensor, "tensor"), (t_cuda, "cuda cores"))
    return t * 1e3, ("bytes" if unit == "bytes" else "operations"), unit


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
            bound_ms, bound_by, unit = bound(name, m, n)
            row = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bound_unit": unit,
                   "bound_share": bound_ms / dev_ms}
            # the column splits' sum has a fixed order
            again = kernel(*a)
            torch.cuda.synchronize()
            row["second_launch_bit_equal"] = bool(torch.equal(got, again))
            require(row["second_launch_bit_equal"],
                    f"{name} {label}: a second launch gave other bits")
            del again
            report[name][label] = row
            print(f"kernel {name} {label}: max_abs_err={err:.3e} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.5f} ({unit}; {100 * bound_ms / dev_ms:.1f}% of it)")
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


def compare_routes(state, batch, cfg, what: str = "step 0"):
    """The loss and dL/dprojections of both routes from the same
    projections of a copy of the state: within rel 1e-4 and 1e-3 of the
    gradient's largest. Returns that copy, on which the caller runs the
    dense route's step 0."""
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
    print(f"{what} routes: loss kernel={lk:.7f} dense={ld:.7f}; "
          f"dL/dproj max abs diff {g_err:.3e} (max {g_max:.3e})")
    require(abs(lk - ld) <= 1e-4 * abs(ld), f"{what}: kernel and dense losses differ")
    require(g_err <= 1e-3 * g_max, f"{what}: kernel and dense projection gradients differ")
    return ref


def take(batch):
    """The batch itself, or the next batch of a feed (a callable)."""
    return batch() if callable(batch) else batch


def timed(step, state, batch, n: int):
    """Runs n steps on ``batch`` (or on the batches of a feed, taken inside
    the timed loop); returns the state, the last loss and s/step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, take(batch))
    last = float(metrics["contrastive_loss"])             # waits for the card
    return state, last, (time.perf_counter() - t0) / n


def profile_steps(step, state, batch, n: int = PROFILED_STEPS) -> dict:
    """Device time by kernel over n steps (torch.profiler), and the share of
    the same steps' wall time in which the card ran no kernel. The profiler
    slows the host, which lengthens the idle time."""
    import torch

    def run():
        nonlocal state, wall
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, take(batch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n

    wall = 0.0
    kernels = profiled_kernels(run, least=n)
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e6
    print(f"profile: {n} steps, wall {wall * 1e3:.3f} ms/step, kernels {busy * 1e3:.3f} "
          f"ms/step, device idle {100 * (1 - busy / wall):.1f}% (profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / n / 1e3
        print(f"profile: {ms:8.3f} ms/step {100 * ms / (busy * 1e3):5.1f}%  "
              f"x{e.count // n}  {e.key[:100]}")
    # a PyTorch add computed in float32 (a bf16 tensor plus a float32 one);
    # the bf16 add's kernel is CUDAFunctor_add<c10::BFloat16>
    mixed = [e for e in kernels if "CUDAFunctor_add" in e.key and "BFloat16" not in e.key]
    out = {"profile_wall_ms": wall * 1e3, "profile_kernel_ms": busy * 1e3,
           "profile_idle_share": 1 - busy / wall,
           "profile_float_add_launches": sum(e.count for e in mixed) // n,
           "profile_float_add_ms": sum(e.self_device_time_total for e in mixed) / n / 1e3}
    # the port's kernels and their second passes, by source; the BN groups
    # match disjoint sets of kernels
    for group, names in (("ntxent", ("plain_denom_kernel", "weighted_denom_kernel",
                                     "plain_grad_kernel", "weighted_grad_kernel", "sum_splits")),
                         *NTXENT_PROFILE_GROUPS.values(),
                         ("bn_epilogue", ("bn_ring_reduce", "bn_ring_dx", "bn_res_",
                                          "bn_sum_ctas")),
                         *BN_PROFILE_GROUPS.values(),
                         *((f"bn_sum_{k}", (f"bn_sum_ctas_kernel<{k}>",))
                           for k in BN_SUM_PASS.values()),
                         ("conv1x1", ("conv1x1_",)),
                         ("conv1x1_sum", ("conv1x1_sum_partials",)),
                         ("conv_bias", ("conv_bias_kernel",))):
        mine = [e for e in kernels if any(k in e.key for k in names)]
        ms = sum(e.self_device_time_total for e in mine) / n / 1e3
        launches = sum(e.count for e in mine) // n
        print(f"profile: {group} kernels {ms:.4f} ms/step ({launches} launches/step)")
        out[f"profile_{group}_ms"], out[f"profile_{group}_launches"] = ms, launches
    return out


def step_config(**kw):
    """The configuration of the step bench.py builds (simhand_w, kernel route)."""
    from simhand_tpu_torch.models import ContrastiveConfig

    return ContrastiveConfig(**{**dict(experiment_type="simhand_w", augmentation=AUGMENTATION,
                                       image_side=float(SIDE), use_pallas=True), **kw})


def new_state(seed: int, dtype=None, **model_kw):
    """A ResNet-50 ContrastiveModel computing in dtype (bf16 by default; with
    the encoder options model_kw) and its train state, initialised from
    seed on the card."""
    import torch

    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.train import OptimizerConfig, create_train_state

    model = ContrastiveModel(RESNET, dtype=dtype or torch.bfloat16, **model_kw)
    opt_cfg = OptimizerConfig(train_iters_per_epoch=1000, epochs=100, warmup_epochs=10)
    return create_train_state(model, opt_cfg, seed, input_shape=(2, SIDE, SIDE, 3),
                              device="cuda")


def run_steps(step, state, batch, what: str, handles=(), steps: int = STEPS):
    """``steps`` train steps: finite losses, a parameter change at step 1;
    the hooks of ``handles`` are removed after step 0."""
    import torch

    losses = []
    for i in range(steps):
        before = [p.detach().clone() for p in state.params] if i == 1 else None
        state, metrics = step(state, take(batch))
        losses.append(float(metrics["contrastive_loss"]))
        if before is not None:
            require(any(not torch.equal(p, q) for p, q in zip(before, state.params)),
                    f"no parameter of the {what} model changed at step 1")
            del before
        if i == 0:
            for h in handles:
                h.remove()
    require(all(math.isfinite(v) for v in losses), f"non-finite {what} loss {losses}")
    return state, losses


def in_turns(steps: dict, states: dict, batch, order) -> tuple[dict, dict]:
    """Times TIMED_STEPS steps of each route in the given order; returns the
    mean ms/step of each and the blocks, and leaves the stepped states in
    ``states``."""
    times = {k: [] for k in steps}
    for route in order:
        states[route], last, dt = timed(steps[route], states[route], batch, TIMED_STEPS)
        require(math.isfinite(last), f"non-finite {route} loss")
        times[route].append(dt * 1e3)
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def main_path(seed: int):
    """The simhand_w step at B = 256 pairs, as bench.py builds it."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    state, cfg = new_state(seed), step_config()
    batch = synthetic_batch(seed)
    ref = compare_routes(state, batch, cfg)
    steps = {"kernel": make_train_step(state.model, cfg),
             "dense": make_train_step(ref.model, dataclasses.replace(cfg, use_pallas=False))}
    ref, dense_loss, _ = timed(steps["dense"], ref, batch, 1)

    K.reset_launches()
    state, losses = run_steps(steps["kernel"], state, batch, "kernel-route")
    states = {"kernel": state, "dense": ref}
    mean_ms, blocks = in_turns(steps, states, batch, ("kernel", "dense", "dense", "kernel"))
    eval_loss = float(make_eval_step(state.model, cfg)(state, batch)["contrastive_loss"])
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}

    print(f"main path losses: {losses}, then {2 * TIMED_STEPS} timed steps; eval {eval_loss}")
    require(math.isfinite(eval_loss), "non-finite eval loss")
    require(abs(losses[0] - dense_loss) <= 1e-4 * abs(dense_loss),
            f"step-0 loss {losses[0]} differs from the dense route's {dense_loss}")
    n_train = STEPS + 2 * TIMED_STEPS
    require(launches["weighted_ntxent_denominator"] == n_train + 1,
            f"weighted denominator launches {launches}")
    require(launches["weighted_grad_rows"] == n_train, f"weighted grad launches {launches}")
    print(f"main path launches {launches}")
    del ref, states

    step_ms, dense_ms = mean_ms["kernel"], mean_ms["dense"]
    perf = {"step0_loss": losses[0], "pairs_per_step": PAIRS, "step_ms": step_ms,
            "img_per_s": PAIRS / step_ms * 1e3,
            "dense_step_ms": dense_ms, "dense_img_per_s": PAIRS / dense_ms * 1e3,
            "step_ms_blocks": blocks}
    print(f"main path: kernel route {step_ms:.2f} ms/step, {PAIRS / step_ms * 1e3:.1f} img/s; "
          f"dense route {dense_ms:.2f} ms/step, {PAIRS / dense_ms * 1e3:.1f} img/s (img = one "
          f"pair, as bench.py counts; blocks {blocks})")
    perf.update(profile_steps(steps["kernel"], state, batch))
    # the loss's kernels a step: #2 and #4 over the 2 * PAIRS rows, each with
    # its splits' sum pass when their planner splits the columns
    want = 2 * ntxent_launches_a_step("weighted_grad_rows")
    require(perf["profile_ntxent_launches"] == want,
            f"the profile counts {perf['profile_ntxent_launches']} NT-Xent launches a "
            f"step, not {want} (#2, #4 and their sum passes)")
    return state, batch, launches, perf


def augment_flag_sets():
    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags

    every = {f.name: True for f in dataclasses.fields(AugmentFlags)}
    return {"main": AugmentFlags(**{k: True for k in AUGMENTATION}),
            "all": AugmentFlags(**every)}


def augment_on_card_vs_cpu(raw: dict, flags, params, seed: int) -> dict:
    """One draw on the card, applied on the card and (copied) on the CPU:
    the crop box and angle exactly, the joints within JOINT_TOL px, the
    images within WARP_TOL on the 0-255 scale on all but CHAIN_SHARE of
    their elements. Returns the share past WARP_TOL and the largest
    differences."""
    import torch

    from simhand_tpu_torch.data import augment as A

    draws = A.sample_views(A.seeded_generator("cuda", seed), raw, flags, A.AugmentParams(),
                           SIDE)
    out = {"share_past_tol": 0.0, "max_image_diff": 0.0, "max_joint_diff": 0.0}
    norm = 255.0 * min(A.IMAGENET_STD)
    for v, d in zip((1, 2), draws):
        cpu_d = A.AugmentDraws(*(None if t is None else t.cpu() for t in d))
        img, joints = raw[f"image{v}"], raw[f"joints{v}"]
        got = A.apply_augment(img, joints, d, flags, params, SIDE)
        want = A.apply_augment(img.cpu(), joints.cpu(), cpu_d, flags, params, SIDE)
        box = A.warp_box(joints.float(), d, flags, params, img.shape[1:3], SIDE)
        cpu_box = A.warp_box(joints.cpu().float(), cpu_d, flags, params, img.shape[1:3], SIDE)
        for name in ("angle", "origin", "side", "jitter"):
            require(torch.equal(getattr(box, name).cpu(), getattr(cpu_box, name)),
                    f"augmentation view {v}: the card's {name} differs from the CPU's")
        diff = (got.images.cpu() - want.images).abs() * norm
        jdiff = float((got.joints.cpu() - want.joints).abs().max())
        out["share_past_tol"] = max(out["share_past_tol"], float((diff > WARP_TOL).double().mean()))
        out["max_image_diff"] = max(out["max_image_diff"], float(diff.max()))
        out["max_joint_diff"] = max(out["max_joint_diff"], jdiff)
    require(out["share_past_tol"] <= CHAIN_SHARE and out["max_joint_diff"] <= JOINT_TOL,
            f"augmentation on the card against the CPU: {out}")
    return out


def link_gbps(nbytes: int) -> float:
    """Host-to-card GB/s of one pinned buffer of nbytes, by CUDA events over
    LINK_COPIES non_blocking copies after a warm-up."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), LINK_COPIES)
    return nbytes / ms / 1e6


def cache_fed_path(seed: int, state, pre_batch) -> dict:
    """The production input path: a synthetic corpus in a packed crop cache
    (built here, without cv2), raw pair batches by the native gather,
    prefetched onto the card, and the simhand_w step augmenting both views
    there. Checks as main_path's (finite losses, a parameter change at step
    1, #2 and #4 on every step) and a repeatable eval step; then the
    composed step timed in turns with main_path's pre-augmented step on the
    same model, the host's assembly rate, the link, the profiled step, and
    the augmentation alone and on the card against the CPU."""
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.data import augment as A
    from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
    from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
    from simhand_tpu_torch.data.prefetch import device_prefetch
    from simhand_tpu_torch.data.sources import SyntheticHandSource
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    perf = {}
    t0 = time.perf_counter()
    corpus = SyntheticHandSource(CACHE_IMAGES, side=CROP, seed=seed)
    perf["corpus_s"] = time.perf_counter() - t0
    cache_dir = native.BUILD_DIR / f"cache_fed_{seed}"
    t0 = time.perf_counter()
    build_crop_cache(corpus, str(cache_dir), shard_size=CACHE_SHARD)
    perf["cache_write_s"] = time.perf_counter() - t0
    del corpus
    flags, params = augment_flag_sets()["main"], A.AugmentParams()
    dataset = PretrainDataset(CachedHand100MSource(str(cache_dir)), "simhand_w", flags, params)
    per_epoch = len(dataset) // PAIRS

    t0 = time.perf_counter()
    n = sum(len(b["image1"]) for b in batch_iterator(dataset, PAIRS, seed=seed, raw=True))
    perf["host_pairs_per_s"] = n / (time.perf_counter() - t0)
    raw_bytes = 2 * PAIRS * CROP * CROP * 3
    perf["link_pinned_gbps"] = link_gbps(raw_bytes)
    print(f"cache-fed: {CACHE_IMAGES} crops at {CROP}x{CROP} (corpus {perf['corpus_s']:.1f} s, "
          f"cache {perf['cache_write_s']:.1f} s, {CACHE_IMAGES // CACHE_SHARD} shards); host "
          f"assembly {perf['host_pairs_per_s']:.1f} pairs/s (gather, no device work); link "
          f"{perf['link_pinned_gbps']:.2f} GB/s pinned ({raw_bytes / 1e6:.1f} MB a batch)")

    def epochs():
        epoch = 0
        while True:
            yield from batch_iterator(dataset, PAIRS, seed=seed, epoch=epoch, raw=True)
            epoch += 1

    source = epochs()
    feed = device_prefetch(source)
    cfg = step_config()
    augment = (flags, params, SIDE)
    composed = make_train_step(state.model, cfg, augment=augment)
    # the composed step, the same step on one raw batch held on the card (no
    # feed), and main_path's step on its pre-augmented batch
    steps = {"composed": composed, "augmented": composed,
             "pre_augmented": make_train_step(state.model, cfg)}
    batches = {"composed": lambda: next(feed), "pre_augmented": pre_batch}
    try:
        K.reset_launches()
        state, losses = run_steps(steps["composed"], state, batches["composed"], "cache-fed",
                                  steps=CACHE_STEPS)
        raw = batches["augmented"] = next(feed)
        evaluate = make_eval_step(state.model, cfg, augment=augment)
        evals = [float(evaluate(state, raw)["contrastive_loss"]) for _ in range(2)]
        times = {k: [] for k in steps}
        order = ("composed", "augmented", "pre_augmented", "pre_augmented", "augmented",
                 "composed")
        for route in order:
            state, last, dt = timed(steps[route], state, batches[route], TIMED_STEPS)
            require(math.isfinite(last), f"non-finite {route} loss")
            times[route].append(dt * 1e3)
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
        n_train = CACHE_STEPS + len(order) * TIMED_STEPS
        print(f"cache-fed losses {losses}; eval {evals}; launches {launches}")
        require(evals[0] == evals[1] and math.isfinite(evals[0]),
                f"the augmented eval step is not repeatable: {evals}")
        require(launches["weighted_ntxent_denominator"] == n_train + 2
                and launches["weighted_grad_rows"] == n_train,
                f"#2/#4 did not launch on every cache-fed step: {launches}")
        perf.update({"losses": losses, "eval_loss": evals[0], "launches": launches})
        for route, blocks in times.items():
            ms = sum(blocks) / len(blocks)
            perf[f"{route}_ms"], perf[f"{route}_pairs_per_s"] = ms, PAIRS / ms * 1e3
            perf[f"{route}_ms_blocks"] = blocks
        print(f"cache-fed: composed step {perf['composed_ms']:.2f} ms, "
              f"{perf['composed_pairs_per_s']:.1f} pairs/s; on one raw batch on the card "
              f"{perf['augmented_ms']:.2f} ms; pre-augmented step "
              f"{perf['pre_augmented_ms']:.2f} ms, {perf['pre_augmented_pairs_per_s']:.1f} "
              f"pairs/s (in turns: {times})")
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            next(feed)
        torch.cuda.synchronize()
        perf["feed_alone_ms"] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        print(f"cache-fed: the feed alone (gather, pinned copy, H2D; no step) "
              f"{perf['feed_alone_ms']:.2f} ms a batch")
        prof = profile_steps(steps["composed"], state, batches["composed"])
        perf.update({f"composed_{k}": v for k, v in prof.items()
                     if k in ("profile_wall_ms", "profile_kernel_ms", "profile_idle_share",
                              "profile_ntxent_launches")})
    finally:
        feed.close()
        source.close()

    for label, fl in augment_flag_sets().items():
        gen = A.seeded_generator("cuda", seed)

        def run(fl=fl, gen=gen):
            return A.prepare_views(raw, gen, fl, params, SIDE)

        perf[f"augment_{label}_ms"] = cuda_ms(run, AUGMENT_ITERS)
        by_kernel = device_ms_by_kernel(run, AUGMENT_ITERS)
        perf[f"augment_{label}_device_ms"] = sum(by_kernel.values())
        for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"augmentation ({label}): {ms:8.4f} ms  {key[:100]}")
        perf[f"augment_{label}_vs_cpu"] = augment_on_card_vs_cpu(raw, fl, params, seed)
        print(f"augmentation ({label} flags, both views of {PAIRS} pairs, {CROP}->{SIDE}): "
              f"{perf[f'augment_{label}_ms']:.3f} ms, device "
              f"{perf[f'augment_{label}_device_ms']:.3f} ms; on the card against the CPU "
              f"{perf[f'augment_{label}_vs_cpu']}")
    perf["augment_share_of_composed_kernels"] = (
        perf["augment_main_device_ms"] / perf["composed_profile_kernel_ms"])
    return perf


def ntxent_launches_a_step(name: str) -> int:
    """Launches of NT-Xent kernel ``name`` over the step's 2 * PAIRS rows:
    the kernel, and its splits' sum pass where its planner splits the
    columns."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K

    rows = 2 * PAIRS
    splits, _ = K._tensor_core_grid(rows, rows, torch.device("cuda"), K._TILE[name])
    return 1 + (splits > 1)


# per element of each BN kernel: the (M, C) planes it reads and writes, its
# float32 (C,) vectors (constants in, sums out), its float32 operations
BN_PLANES = {"masked_dual_reduce": 2, "masked_dx": 3,
             "masked_dual_reduce_res": 4, "masked_dx_res": 3}    # g x; g x dx; g x r dres; dres x dx
BN_VECTORS = {"masked_dual_reduce": 6, "masked_dx": 7,
              "masked_dual_reduce_res": 6, "masked_dx_res": 5}
BN_OPS = {"masked_dual_reduce": 8, "masked_dx": 11,
          "masked_dual_reduce_res": 9, "masked_dx_res": 6}
BN_PAIRS = {False: ("masked_dual_reduce", "masked_dx"),
            True: ("masked_dual_reduce_res", "masked_dx_res")}
# each BN kernel's profile group, (name, substrings of its kernels' names):
# #5 and #9 are bn_ring_reduce_kernel<T, MaskedTerms> and <T, CenteredTerms>,
# #6 and #8 bn_ring_dx_kernel<T, MaskedDy> and <T, StoredDy>;
# a reduce's sum pass is bn_sum_ctas_kernel<n>, one instance per reduce #n,
# which BN_SUM_PASS names; no kernel falls in two groups
BN_SUM_PASS = {"masked_dual_reduce": 5, "masked_dual_reduce_res": 7, "bn_backward_reduces": 9}
BN_PROFILE_GROUPS = {
    "masked_dual_reduce": ("bn_masked_reduce", ("MaskedTerms", "bn_sum_ctas_kernel<5>")),
    "masked_dx": ("bn_masked_dx", ("MaskedDy",)),
    "masked_dual_reduce_res": ("bn_res_reduce", ("bn_res_reduce_kernel",
                                                 "bn_sum_ctas_kernel<7>")),
    "masked_dx_res": ("bn_res_dx", ("StoredDy",)),
    "bn_backward_reduces": ("bn_dual_reduce", ("CenteredTerms", "bn_sum_ctas_kernel<9>")),
}
# the C entry points that run the bulk-copy ring: #5-#9
RING_KERNELS = ("masked_dual_reduce", "masked_dx", "masked_dual_reduce_res", "masked_dx_res",
                "dual_reduce")


class LaunchRecord:
    """Records every launch through bn_epilogue._launch (#5-#9) until
    remove(): the C entry point, C, and whether the CUDA source's own test
    (bn_ring_fits) sends it down the ring with these planes; fails where the
    Python mirror, ring_fits, answers otherwise. ``gradient_copies`` is for
    bn_site_bound's backward hooks to count in."""

    def __init__(self):
        from simhand_tpu_torch.models import bn_epilogue as E

        self.E, self.launch, self.seen, self.gradient_copies = E, E._launch, [], 0

        def launch(name, planes, consts, grid, outs):
            c, ptrs = planes[0].shape[1], [t.data_ptr() for t in (*planes, *outs)]
            fits = E.kernel_ring_fits(c, planes[0].dtype, *ptrs)
            require(fits == E.ring_fits(c, planes[0].element_size(), *ptrs),
                    f"{name} C={c}: ring_fits disagrees with the CUDA source's bn_ring_fits")
            self.seen.append((name, c, fits))
            return self.launch(name, planes, consts, grid, outs)

        E._launch = launch

    def remove(self) -> None:
        self.E._launch = self.launch

    def ring(self) -> list:
        """Whether each launch of a ring kernel took the ring, in order."""
        return [fits for name, _, fits in self.seen if name in RING_KERNELS]


def ring_taken(fn) -> bool:
    """Whether every ring-kernel launch of fn() took the ring."""
    rec = LaunchRecord()
    try:
        fn()
    finally:
        rec.remove()
    require(len(rec.ring()) > 0, "no ring kernel was launched")
    return all(rec.ring())


def sum_passes(sites) -> int:
    """Sum passes a reduce launches over sites of (M, C, element size):
    one wherever its persistent grid has more than one CTA."""
    from simhand_tpu_torch.models import bn_epilogue as E

    return sum(E._persistent_grid(m, c, es, "cuda")[1] > 1 for m, c, es in sites)


def site_times(name: str, sites, make, bound_fn, seed: int) -> dict:
    """One kernel timed alone (torch.profiler, device ms of the kernels of
    its profile group, sum pass included) at each distinct (M, C, element
    size) of a step's sites, on random (M, C) planes g and x (``make(g, x)``
    returns the call that launches it), with the L2 cache overwritten
    before each launch (a step's planes do not stay there), beside its
    bound: where its ms per step over its bound comes from."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    group = BN_PROFILE_GROUPS[name][1]
    rows, total, total_bound = [], 0.0, 0.0
    for (m, c, es), n in sorted(collections.Counter(sites).items()):
        dtype = torch.bfloat16 if es == 2 else torch.float32
        g, x = (torch.randn(m, c, device="cuda", generator=gen).to(dtype) for _ in range(2))
        call = make(g, x)

        def cold():
            flush.zero_()
            call()

        dev = sum(v for k, v in device_ms_by_kernel(cold, 10).items()
                  if any(p in k for p in group))
        b = bound_fn(m, c, es)[0]
        rows.append({"m": m, "c": c, "per_step": n, "device_ms": dev, "bound_ms": b})
        total, total_bound = total + n * dev, total_bound + n * b
        print(f"{name} site {m}x{c}: x{n} per step, device {dev:.4f} ms, bound {b:.4f} ms "
              f"({100 * b / dev:.1f}%), {n * (dev - b):.4f} ms/step over its bound")
        del g, x
    print(f"{name} alone at the step's sites (L2 flushed): {total:.4f} ms/step against its "
          f"bound {total_bound:.4f}")
    del flush
    torch.cuda.empty_cache()
    return {"sites": rows, "ms_per_step": total, "bound_ms_per_step": total_bound}


def bn_bound(name: str, m: int, c: int, esize: int) -> tuple[float, str]:
    """Least time of a BN kernel: bytes (each of its (M, C) planes read or
    written once, its float32 per-channel vectors once) over the memory
    rate, or its float32 operations over the float32 rate, the larger."""
    t_bytes = (BN_PLANES[name] * m * c * esize + 4 * BN_VECTORS[name] * c) / HBM_BYTES_PER_S
    t_ops = float(m) * c * BN_OPS[name] / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def exact_backward_ms(x, r, g, iters: int) -> tuple[float, float]:
    """The exact route's backward at a site: ReLU backward and the BatchNorm
    backward of F.batch_norm through autograd (the port's BatchNorm2d); ms
    by CUDA events over back-to-back calls (host enqueue included) and by
    torch.profiler (the device time of its kernels alone)."""
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

    def backward():
        return torch.autograd.grad(y, inputs, g, retain_graph=True)

    return cuda_ms(backward, iters), device_ms(backward, iters)


def bn_kernel_phase(seed: int) -> dict:
    """Kernels #5-#8 against their plain versions, bf16 and float32, at the
    sites of BN_SHAPES: #5/#6 on g and x, #7 on g, x and r, #8 on the plain
    version's dres; a second launch of each gives the same bits."""
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
            *sums_r, dres2d = E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)
            kr = [v / m for v in sums_r]
            dres = E.from_rows(dres2d, r)
            cases = {
                "masked_dual_reduce": (lambda: E.masked_dual_reduce(g, x, *cs),
                                       lambda: E.masked_dual_reduce_plain(g2d, x2d, *cs)),
                "masked_dx": (lambda: E.masked_dx(g, x, *cs, P, *k),
                              lambda: E.masked_dx_plain(g2d, x2d, *cs, P, *k)),
                "masked_dual_reduce_res": (
                    lambda: E.masked_dual_reduce_res(g, x, r, *cs),
                    lambda: E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)),
                "masked_dx_res": (
                    lambda: E.masked_dx_res(dres, x, *cs[2:], P, *kr),
                    lambda: E.masked_dx_res_plain(dres2d, x2d, *cs[2:], P, *kr)),
            }
            big = m * c >= 10**8
            for name, (kernel, plain) in cases.items():
                got, want, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                got, want, again = ([t] if torch.is_tensor(t) else list(t)
                                    for t in (got, want, again))
                row = {"second_launch_bit_equal": all(torch.equal(a, b)
                                                      for a, b in zip(got, again))}
                require(row["second_launch_bit_equal"],
                        f"{name} {label} {tag}: a second launch gave other bits")
                if "reduce" in name:
                    rels = [float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(got[:2], want[:2])]
                    row["sums_rel_err"] = max(rels)
                    require(max(rels) <= 1e-5, f"{name} {label} {tag}: sums rel err {rels}")
                if name == "masked_dual_reduce":
                    # a gradient that is not channels-last, which the wrapper copies
                    rels = [float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(E.masked_dual_reduce(g.contiguous(), x, *cs), want)]
                    row["sums_rel_err_nchw_g"] = max(rels)
                    require(max(rels) <= 1e-5, f"{name} {label} {tag} NCHW g: sums rel err {rels}")
                if name in RING_KERNELS:
                    row["ring"] = ring_taken(kernel)
                    require(row["ring"] == (label != "ragged"),
                            f"{name} {label} {tag}: ring taken {row['ring']}")
                # dres and dx: the same float32 operations, each rounded, in
                # the same order: bit for bit in both dtypes (a mask
                # difference would show here too)
                planes = [(E.as_rows(a), b) for a, b in zip(got, want) if a.dim() > 1]
                if planes:
                    row["not_bit_equal"] = sum(int((a != b).sum()) for a, b in planes)
                    if name == "masked_dual_reduce_res":
                        (a, b), = planes
                        row["mask_diffs"] = int(((a != 0) != (b != 0)).sum())
                        require(row["mask_diffs"] == 0, f"{name} {label} {tag}: mask differs")
                    require(row["not_bit_equal"] == 0,
                            f"{name} {label} {tag}: {row['not_bit_equal']} elements differ")
                row["max_abs_err"] = max(
                    float(((E.as_rows(a) if a.dim() > 1 else a).float() - b.float()).abs().max())
                    for a, b in zip(got, want))
                row["ms"] = cuda_ms(kernel, 20 if big else 50)
                if dtype == torch.bfloat16:
                    by_kernel = device_ms_by_kernel(kernel, 10)
                    row["device_ms"] = sum(by_kernel.values())
                    # the reduces' second pass, the fixed-order sum of partials
                    row["sum_device_ms"] = sum(v for k_, v in by_kernel.items() if "bn_sum_" in k_)
                row["plain_ms"] = cuda_ms(plain, 5)
                row["bound_ms"], row["bound_by"] = bn_bound(name, m, c, x.element_size())
                report[name][f"{label}_{tag}"] = row
                print(f"bn kernel {name} {label} {tag} ({m}x{c}): " + " ".join(
                    f"{k_}={v:.4g}" if isinstance(v, float) else f"{k_}={v}"
                    for k_, v in row.items()))
            if dtype == torch.bfloat16 and label != "ragged":
                res = label != "stem"
                pair = BN_PAIRS[res]
                exact, exact_device = exact_backward_ms(x, r if res else None, g, 20)
                rows = [report[n][f"{label}_{tag}"] for n in pair]
                pair_bound = sum(row["bound_ms"] for row in rows)
                for row in rows:
                    row.update(exact_pair_ms=exact, exact_pair_device_ms=exact_device,
                               pair_bound_ms=pair_bound)
                pair_device = sum(row["device_ms"] for row in rows)
                print(f"bn pair {pair[0]}+{pair[1]} {label} bf16: device {pair_device:.4f} ms "
                      f"(events {sum(row['ms'] for row in rows):.4f}), bound "
                      f"{pair_bound:.4f} ms ({100 * pair_bound / pair_device:.1f}%); exact "
                      f"route backward device {exact_device:.4f} ms, events {exact:.4f} ms")
            del cases, x, r, g, g2d, x2d, r2d, dres, dres2d
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


def bn_site_bound(model, cls=None) -> tuple[list, list, LaunchRecord]:
    """Forward hooks on the BNRelu sites (or those of ``cls``) that record
    each train-mode site's (M, C, element size, residual), backward hooks
    that count the gradients autograd hands them in another layout than
    channels-last (the wrapper copies those before the launch) into
    ``record.gradient_copies``, and a record of the BN kernels' launches;
    returns the list, the handles of all three (the record's last) and the
    record."""
    from simhand_tpu_torch.models.bn_epilogue import BNRelu

    cls = cls or BNRelu
    sites, handles, record = [], [], LaunchRecord()

    def hook(module, args, _out):
        x = args[0]
        if module.training:
            sites.append((x.numel() // x.shape[1], x.shape[1], x.element_size(),
                          len(args) > 1 and args[1] is not None))

    def backward_hook(module, grad_output):
        record.gradient_copies += not grad_output[0].movedim(1, -1).is_contiguous()

    for mod in model.modules():
        if isinstance(mod, cls):
            handles += [mod.register_forward_hook(hook),
                        mod.register_full_backward_pre_hook(backward_hook)]
    return sites, [*handles, record], record


def epilogue_path(seed: int, exact_state, batch, exact_loss0: float) -> tuple[dict, dict]:
    """The simhand_w step through the fused BN+ReLU encoder."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    cfg = step_config()
    states = {k: new_state(seed, bn_fused=k) for k in ("epilogue", "epilogue_xla")}
    (le, ge), (lx, gx), (_, ge2) = (step0(states[k], batch, cfg)
                                    for k in ("epilogue", "epilogue_xla", "epilogue"))
    names = [n for n, _ in states["epilogue"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, ge, gx)
    self_worst, self_name, self_total = grad_diff(names, ge2, ge)
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

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "epilogue", "epilogue_xla")}
    sites, handles, record = bn_site_bound(states["epilogue"].model)
    E.reset_launches()
    K.reset_launches()
    states["epilogue"], losses = run_steps(steps["epilogue"], states["epilogue"], batch,
                                           "epilogue", handles)
    ntx = {fn.__name__: fn.launches for fn in K.KERNELS}
    bn = {fn.__name__: fn.launches for fn in E.KERNELS}
    ring = record.ring()
    print(f"epilogue path losses {losses}; launches after {STEPS} steps {bn}, NT-Xent {ntx}; "
          f"step 0's {len(ring)} launches of #5-#8: {sum(ring)} on the ring; "
          f"{record.gradient_copies} gradients not channels-last")
    require(all(bn[n] == BN_PER_STEP[n] * STEPS for n in bn), f"BN kernel launches {bn}")
    require(len(ring) == sum(BN_PER_STEP[n] for n in RING_KERNELS if n in BN_PER_STEP)
            and all(ring), "a launch of #5-#8 in the epilogue step left the ring")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every epilogue step: {ntx}")
    kernel_bound = {n: sum(bn_bound(n, m, c, es)[0] for m, c, es, res in sites
                           if n in BN_PAIRS[res]) for n in BN_REPLACES}
    step_bound = sum(kernel_bound.values())
    print(f"epilogue sites per step: {len(sites)} ({sum(s[3] for s in sites)} with a "
          f"residual); bound of #5-#8 {step_bound:.4f} ms/step: " + ", ".join(
              f"{n} {v:.4f}" for n, v in kernel_bound.items()))

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "epilogue", "epilogue_xla",
                                                       "epilogue_xla", "epilogue", "exact"))
    eval_loss = float(make_eval_step(states["epilogue"].model, cfg)(states["epilogue"], batch)
                      ["contrastive_loss"])
    require(math.isfinite(eval_loss), "non-finite epilogue eval loss")
    launches = {fn.__name__: fn.launches for fn in E.KERNELS}
    n_train = STEPS + 2 * TIMED_STEPS
    require(all(launches[n] == BN_PER_STEP[n] * n_train for n in launches),
            f"BN kernel launches over the epilogue path {launches}")
    print("epilogue path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; eval {eval_loss}; blocks {blocks}")
    perf = {"step0_loss": le, "step0_grad_worst_rel": worst, "step0_grad_all_rel": total,
            "step0_self_worst_rel": self_worst, "step0_self_all_rel": self_total,
            "step_ms": mean_ms, "bn_bound_ms_per_step": step_bound, "step_ms_blocks": blocks,
            "bn_kernel_bound_ms_per_step": kernel_bound}
    perf.update(profile_steps(steps["epilogue"], states["epilogue"], batch))
    for n in BN_REPLACES:
        group = BN_PROFILE_GROUPS[n][0]
        ms, got = perf[f"profile_{group}_ms"], perf[f"profile_{group}_launches"]
        passes = sum_passes([s[:3] for s in sites if n in BN_PAIRS[s[3]]]) if n in BN_SUM_PASS \
            else 0
        sums = (f", sum passes {perf[f'profile_bn_sum_{BN_SUM_PASS[n]}_ms']:.4f}"
                if n in BN_SUM_PASS else "")
        print(f"epilogue step: {n} {ms:.4f} ms/step of device time ({got} launches/step{sums}) "
              f"against its bound {kernel_bound[n]:.4f} ms/step over the step's own sites")
        require(got == BN_PER_STEP[n] + passes,
                f"epilogue step: {got} launches/step of {n}'s group, not "
                f"{BN_PER_STEP[n]} + {passes} sum passes")

    def masked_reduce_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        ones = torch.ones(x.shape[1], device="cuda")
        cs = E._affine_consts(mu, inv, ones, 0.1 * ones)
        return lambda: E.masked_dual_reduce(g, x, *cs)

    def masked_dx_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        ones = torch.ones(x.shape[1], device="cuda")
        cs = E._affine_consts(mu, inv, ones, 0.1 * ones)
        k = [0.01 * ones, 0.02 * ones]
        return lambda: E.masked_dx(g, x, *cs, inv, *k)

    plain_sites = [s[:3] for s in sites if not s[3]]
    for name, make in (("masked_dual_reduce", masked_reduce_at), ("masked_dx", masked_dx_at)):
        perf[f"{name}_sites"] = site_times(name, plain_sites, make,
                                           functools.partial(bn_bound, name), seed)
    del states, steps
    return launches, perf


def fused_bn_bound(m: int, c: int, esize: int) -> tuple[float, str]:
    """Least time of kernel #9: bytes (x and dy read once, mu and inv read,
    the two sums written) over the memory rate, or its five float32
    operations per element (subtract, two multiplies, two adds) over the
    float32 rate, the larger."""
    t_bytes = (2 * m * c * esize + 4 * 4 * c) / HBM_BYTES_PER_S
    t_ops = 5.0 * m * c / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def fused_bn_kernel_phase(seed: int) -> dict:
    """Kernel #9 against its plain version and torch.batch_norm_backward_reduce,
    bf16 and float32, at the sites of BN_SHAPES."""
    import torch

    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for label, shape in BN_SHAPES:
            x, g = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                    .contiguous(memory_format=torch.channels_last) for _ in range(2))
            c = shape[1]
            m = x.numel() // c
            mu, _, inv = E.batch_stats(x, 1e-5)
            weight = torch.ones(c, device="cuda")
            x2d, g2d = E.as_rows(x), E.as_rows(g)

            def kernel():
                return F.bn_backward_reduces(x, g, mu, inv)

            def plain():
                return F.bn_backward_reduces_plain(x2d, g2d, mu, inv)

            def library():
                # grad_bias = sum dy, grad_weight = sum dy (x - mu) inv
                out = torch.batch_norm_backward_reduce(g, x, mu, inv, weight, False, True, True)
                return out[3], out[2]

            want = plain()
            row = {}
            for layout, dy in (("channels_last", g), ("nchw_dy", g.contiguous())):
                got, again = (F.bn_backward_reduces(x, dy, mu, inv) for _ in range(2))
                torch.cuda.synchronize()
                rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
                require(max(rels) <= 1e-5, f"#9 {label} {tag} {layout}: sums rel err {rels}")
                require(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"#9 {label} {tag} {layout}: a second launch gave other bits")
                row[f"rel_err_{layout}"] = max(rels)
            row["second_launch_bit_equal"] = True
            row["ring"] = ring_taken(kernel)
            require(row["ring"] == (label != "ragged"), f"#9 {label} {tag}: ring {row['ring']}")
            row["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(kernel(), want))
            row["library_rel_diff"] = max(float((a - b).abs().max() / b.abs().max())
                                          for a, b in zip(library(), want))
            big = m * c >= 10**8
            row["ms"] = cuda_ms(kernel, 20 if big else 50)
            row["device_ms"] = device_ms(kernel, 10)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["library_ms"] = cuda_ms(library, 20 if big else 50)
            row["library_device_ms"] = device_ms(library, 10)
            row["bound_ms"], row["bound_by"] = fused_bn_bound(m, c, x.element_size())
            if dtype == torch.bfloat16 and label in ("stem", "layer1_bn3"):
                require(row["device_ms"] < row["library_device_ms"],
                        f"#9 {label} bf16: device {row['device_ms']:.4f} ms, not below "
                        f"torch.batch_norm_backward_reduce's {row['library_device_ms']:.4f}")
            report[f"{label}_{tag}"] = row
            print(f"fused-bn kernel bn_backward_reduces {label} {tag} ({m}x{c}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
            del x, g, x2d, g2d
            torch.cuda.empty_cache()
    return {"bn_backward_reduces": report}


def conv_bound(m: int, cin: int, cout: int, affine: bool) -> tuple[float, str]:
    """Least time of kernel #10 (#11 with affine): bytes (x, w read once, y
    and the two sums written; A and B read) over the memory rate, or the
    larger of the GEMM's 2*M*Cin*Cout operations over the bf16 tensor peak
    and the float32 operations (three per y element for the statistics,
    three per x element for the affine) over the float32 rate, the larger."""
    nbytes = 2 * (m * cin + cout * cin + m * cout) + 4 * 2 * cout + (4 * 2 * cin if affine else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    f32_ops = 3.0 * m * cout + (3.0 * m * cin if affine else 0)
    t_ops = max(2.0 * m * cin * cout / BF16_TENSOR_OPS_PER_S, f32_ops / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_kernel_phase(seed: int) -> dict:
    """Kernels #10 and #11 against their plain versions at CONV_SHAPES."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in CONV_REPLACES}
    for label, m, cin, cout, _ in CONV_SHAPES:
        x2d = torch.randn(m, cin, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(cout, cin, device="cuda", generator=gen) / math.sqrt(cin)).bfloat16()
        A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
        B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
        xa = torch.relu(x2d.float() * A + B).bfloat16()
        cases = {
            "conv1x1_stats": (lambda: C.conv1x1_stats(x2d, w),
                              lambda: C.conv1x1_stats_plain(x2d, w), x2d),
            "conv1x1_bn_relu_stats": (lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B),
                                      lambda: C.conv1x1_bn_relu_stats_plain(x2d, w, A, B), xa),
        }
        for name, (kernel, plain, xin) in cases.items():
            (y, s1, s2), (py, ps1, ps2) = kernel(), plain()
            torch.cuda.synchronize()
            a, b = y.float(), py.float()
            _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
            ulp = torch.ldexp(torch.ones_like(a), e - 8)
            diff = (a - b).abs()
            floor = 2.0**-16 * (xin.float().abs() @ w.float().abs().T)
            row = {"max_abs_err": float(diff.max()),
                   "share_differ": float((diff > 0).float().mean()),
                   "share_over_one_ulp": float((diff > ulp).float().mean()),
                   "max_ulps": float((diff / ulp).max())}
            require(bool((diff <= ulp + floor).all()),
                    f"{name} {label}: y beyond one bf16 ulp of the plain version's {row}")
            y64 = y.double()
            own = [float((s.double() - t).abs().max() / t.abs().max())
                   for s, t in ((s1, y64.sum(0)), (s2, (y64 * y64).sum(0)))]
            vs_plain = [float((s - t).abs().max() / t.abs().max()) for s, t in ((s1, ps1), (s2, ps2))]
            row["stats_rel_err_own_y"], row["stats_rel_err_plain"] = max(own), max(vs_plain)
            require(max(own) <= 1e-5, f"{name} {label}: s1/s2 vs its own y {own}")
            require(max(vs_plain) <= 1e-3, f"{name} {label}: s1/s2 vs the plain version {vs_plain}")
            again = kernel()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(again, (y, s1, s2))),
                    f"{name} {label}: a second launch gave other bits")
            del y, s1, s2, py, ps1, ps2, a, b, e, ulp, diff, floor, y64, again
            iters = 50 if m <= 32768 else 20
            row["ms"] = cuda_ms(kernel, iters)
            by_kernel = device_ms_by_kernel(kernel, 10)
            row["device_ms"] = sum(by_kernel.values())
            row["kernel_device_ms"] = sum(v for k, v in by_kernel.items()
                                          if "conv1x1_stats_kernel" in k)
            row["sum_device_ms"] = sum(v for k, v in by_kernel.items()
                                       if "conv1x1_sum_partials" in k)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["matmul_ms"] = cuda_ms(lambda: x2d @ w.T, iters)
            row["matmul_device_ms"] = device_ms(lambda: x2d @ w.T, 10)
            row["ratio_to_matmul"] = row["device_ms"] / row["matmul_ms"]
            row["bound_ms"], row["bound_by"] = conv_bound(m, cin, cout,
                                                          name == "conv1x1_bn_relu_stats")
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            report[name][label] = row
            print(f"conv kernel {name} {label} ({m}x{cin}->{cout}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del cases, x2d, w, xa
        torch.cuda.empty_cache()
    return report


def grad_diff(names, got, want):
    """The worst parameter gradient's difference relative to its norm (with
    its name), and all of them together relative to their norm."""
    errs = [float((a - b).double().norm() / b.double().norm()) for a, b in zip(got, want)]
    total = (sum(float((a - b).double().norm()) ** 2 for a, b in zip(got, want))
             / sum(float(b.double().norm()) ** 2 for b in want)) ** 0.5
    worst = max(range(len(errs)), key=errs.__getitem__)
    return errs[worst], names[worst], total


def fused_bn_path(seed: int, exact_state, batch, exact_loss0: float) -> tuple[dict, dict]:
    """The simhand_w step with bn_fused="pallas" (kernel #9) and True."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    cfg = step_config()
    states = {"pallas": new_state(seed, bn_fused="pallas"),
              "fused_plain": new_state(seed, bn_fused=True)}
    (lp, gp), (lt, gt), (_, gp2) = (step0(states[k], batch, cfg)
                                    for k in ("pallas", "fused_plain", "pallas"))
    names = [n for n, _ in states["pallas"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, gp, gt)
    self_worst, self_name, self_total = grad_diff(names, gp2, gp)
    print(f"fused-bn step 0: loss pallas={lp!r} bn_fused=True {lt!r} exact={exact_loss0!r} "
          f"(rel {abs(lp - exact_loss0) / abs(exact_loss0):.3e}); gradients vs bn_fused=True: "
          f"worst {worst_name} {worst:.3e} of its norm, all {total:.3e}; pallas against "
          f"itself: worst {self_name} {self_worst:.3e}, all {self_total:.3e}")
    require(lp == lt, f"pallas step-0 loss {lp!r} != bn_fused=True's {lt!r}")
    require(abs(lp - exact_loss0) <= LOSS_TWO_ROUNDING_RTOL * abs(exact_loss0),
            f"pallas step-0 loss {lp} differs from the exact route's {exact_loss0}")
    require(worst <= GRAD_TENSOR_RTOL and total <= GRAD_ALL_RTOL,
            "pallas gradients differ from bn_fused=True's")
    del gp, gt, gp2

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "pallas", "fused_plain")}
    sites, handles, record = bn_site_bound(states["pallas"].model, F.FusedBatchNorm)
    F.reset_launches()
    K.reset_launches()
    states["pallas"], losses = run_steps(steps["pallas"], states["pallas"], batch, "pallas",
                                         handles)
    launches, ntx = F.bn_backward_reduces.launches, {fn.__name__: fn.launches for fn in K.KERNELS}
    ring = record.ring()
    print(f"fused-bn path losses {losses}; #9 launches after {STEPS} steps {launches}, "
          f"NT-Xent {ntx}; step 0's {len(ring)} launches of #9: {sum(ring)} on the ring; "
          f"{record.gradient_copies} gradients not channels-last")
    require(len(sites) == FUSED_BN_PER_STEP, f"{len(sites)} FusedBatchNorm sites per step")
    require(len(ring) == FUSED_BN_PER_STEP and all(ring),
            "a launch of #9 in the pallas step left the ring")
    require(launches == FUSED_BN_PER_STEP * STEPS, f"#9 launches {launches}")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every pallas step: {ntx}")
    step_bound = sum(fused_bn_bound(m, c, es)[0] for m, c, es, _ in sites)
    print(f"fused-bn sites per step: {len(sites)}; byte bound of #9 {step_bound:.4f} ms/step")

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "pallas", "fused_plain",
                                                       "fused_plain", "pallas", "exact"))
    eval_loss = float(make_eval_step(states["pallas"].model, cfg)(states["pallas"], batch)
                      ["contrastive_loss"])
    require(math.isfinite(eval_loss), "non-finite pallas eval loss")
    n_train = STEPS + 2 * TIMED_STEPS
    launches = F.bn_backward_reduces.launches
    require(launches == FUSED_BN_PER_STEP * n_train, f"#9 launches over the path {launches}")
    print("fused-bn path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; eval {eval_loss}; blocks {blocks}")
    perf = {"step0_loss": lp, "step0_loss_rel_exact": abs(lp - exact_loss0) / abs(exact_loss0),
            "step0_grad_worst_rel": worst, "step0_grad_all_rel": total,
            "step0_self_worst_rel": self_worst, "step0_self_all_rel": self_total,
            "step_ms": mean_ms, "bound_ms_per_step": step_bound, "step_ms_blocks": blocks}
    perf.update(profile_steps(steps["pallas"], states["pallas"], batch))
    ms, got = perf["profile_bn_dual_reduce_ms"], perf["profile_bn_dual_reduce_launches"]
    passes = sum_passes([s[:3] for s in sites])
    print(f"pallas step: bn_backward_reduces {ms:.4f} ms/step of device time ({got} "
          f"launches/step, sum passes {perf['profile_bn_sum_9_ms']:.4f}) against its bound "
          f"{step_bound:.4f} ms/step over the step's own sites")
    require(got == FUSED_BN_PER_STEP + passes,
            f"pallas step: {got} launches/step of #9's group, not {FUSED_BN_PER_STEP} + "
            f"{passes} sum passes")

    def dual_reduce_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        return lambda: F.bn_backward_reduces(x, g, mu, inv)

    perf["bn_backward_reduces_sites"] = site_times(
        "bn_backward_reduces", [s[:3] for s in sites], dual_reduce_at, fused_bn_bound, seed)
    del states, steps
    return {"bn_backward_reduces": launches}, perf


def conv_site_hooks(model, threshold: int) -> tuple[list, list]:
    """Hooks that record each train-mode fused conv1x1+BN site's (M, Cin,
    Cout): a bottleneck's input is conv1's, its bn2's output conv3's."""
    from simhand_tpu_torch.models.resnet import Bottleneck

    sites, handles = [], []

    def record(module, x, cout):
        if module.training and x.shape[1] >= threshold:
            sites.append((x.numel() // x.shape[1], x.shape[1], cout))

    for block in model.modules():
        if isinstance(block, Bottleneck):
            handles.append(block.register_forward_pre_hook(
                lambda mod, args: record(mod, args[0], mod.conv1.out_channels)))
            handles.append(block.bn2.register_forward_hook(
                lambda mod, args, out, b=block: record(mod, out, b.conv3.out_channels)))
    return sites, handles


# the fused site against cuDNN's conv + BatchNorm at sites of the step
# (N, Cin, H, W, Cout): each of o, dx, dw, dscale, dbias within 1e-2 of its
# norm (bf16 values one ulp apart, 2^-8, in a fraction of the elements)
SITE_SHAPES = (("layer2_conv1", (512, 512, 16, 16), 128),
               ("layer3_conv1", (512, 1024, 8, 8), 256),
               ("layer4_conv3", (512, 512, 4, 4), 2048))
SITE_RTOL = 1e-2


def site_check(seed: int) -> dict:
    """The fused conv1x1+BN site's output and gradients against the exact
    site (the port's Conv2d and BatchNorm2d: cuDNN's convolution and
    PyTorch's batch norm) on the same inputs, bf16, train mode."""
    import torch

    from simhand_tpu_torch.models.fused_conv import fused_conv_bn_site
    from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, shape, cout in SITE_SHAPES:
        conv = Conv2d(shape[1], cout, 1, dtype=torch.bfloat16).cuda()
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, device="cuda", generator=gen)
                              / math.sqrt(shape[1]))
        bn = BatchNorm2d(cout).cuda()
        with torch.no_grad():
            bn.weight.copy_(1 + 0.3 * torch.randn(cout, device="cuda", generator=gen))
            bn.bias.copy_(0.1 * torch.randn(cout, device="cuda", generator=gen))
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16().contiguous(
            memory_format=torch.channels_last)
        g = torch.randn((shape[0], cout, *shape[2:]), device="cuda", generator=gen).bfloat16()
        g = g.contiguous(memory_format=torch.channels_last)
        outs = []
        for fused in (True, False):
            xx = x.clone().requires_grad_()
            o = fused_conv_bn_site(conv, bn, xx) if fused else bn(conv(xx))
            grads = torch.autograd.grad(o, (xx, conv.weight, bn.weight, bn.bias), g)
            outs.append([o.detach(), *grads])
        row = {name: float((a.double() - b.double()).norm() / b.double().norm())
               for name, a, b in zip(("o", "dx", "dw", "dscale", "dbias"), *outs)}
        report[label] = row
        print(f"conv1x1 site {label} {shape} -> {cout}, fused vs exact (rel to norm): "
              + " ".join(f"{k}={v:.3e}" for k, v in row.items()))
        require(max(row.values()) <= SITE_RTOL, f"fused site {label} differs from the exact one")
        del conv, bn, x, g, outs
        torch.cuda.empty_cache()
    return report


def conv1x1_path(seed: int, exact_state, batch) -> tuple[dict, dict]:
    """The simhand_w step with conv1x1_fuse_min_cin=512 (kernel #10)."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config()
    states = {"conv1x1": new_state(seed, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN),
              "exact0": new_state(seed)}
    (lc, gc), (le, ge), (_, ge2) = (step0(states[k], batch, cfg)
                                    for k in ("conv1x1", "exact0", "exact0"))
    names = [n for n, _ in states["conv1x1"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, gc, ge)
    self_worst, self_name, self_total = grad_diff(names, ge2, ge)
    rel = abs(lc - le) / abs(le)
    print(f"conv1x1 step 0: loss conv1x1={lc!r} exact={le!r} (rel {rel:.3e}); gradients vs "
          f"exact: worst {worst_name} {worst:.3e} of its norm, all {total:.3e}; exact against "
          f"itself: worst {self_name} {self_worst:.3e}, all {self_total:.3e}")
    require(rel <= LOSS_EXACT_RTOL, f"conv1x1 step-0 loss {lc} differs from the exact route's {le}")
    # The step's gradients are not held to GRAD_*_RTOL here: those limits
    # compare two routes with the same forward (epilogue and epilogue_xla,
    # pallas and bn_fused=True). This forward rounds differently from the
    # exact one, and the bf16 step's parameter gradients are dominated by
    # rounding at init: on the CPU (scripts/torch_bf16_departure.py) exact
    # bf16 departs from exact float32 by 1.34 of the gradients' norm, the
    # epilogue from exact by 1.38, this route from exact by 0.69 (0.71 on
    # an H100). site_check holds the site's own gradients instead.
    del gc, ge, ge2, states["exact0"]
    sites_vs_exact = site_check(seed)

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "conv1x1")}
    sites, handles = conv_site_hooks(states["conv1x1"].model, CONV_FUSE_MIN_CIN)
    C.reset_launches()
    K.reset_launches()
    states["conv1x1"], losses = run_steps(steps["conv1x1"], states["conv1x1"], batch, "conv1x1",
                                          handles)
    launches = {fn.__name__: fn.launches for fn in C.KERNELS}
    ntx = {fn.__name__: fn.launches for fn in K.KERNELS}
    print(f"conv1x1 path losses {losses}; launches after {STEPS} steps {launches}, NT-Xent {ntx}; "
          f"sites {sorted(set(sites))}")
    require(len(sites) == CONV_PER_STEP, f"{len(sites)} fused conv1x1 sites per step")
    require(launches == {"conv1x1_stats": CONV_PER_STEP * STEPS, "conv1x1_bn_relu_stats": 0},
            f"conv1x1 kernel launches {launches}")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every conv1x1 step: {ntx}")
    step_bound = sum(conv_bound(m, cin, cout, False)[0] for m, cin, cout in sites)
    print(f"conv1x1 sites per step: {len(sites)}; bound of #10 {step_bound:.4f} ms/step")

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "conv1x1", "conv1x1", "exact"))
    launches = {fn.__name__: fn.launches for fn in C.KERNELS}
    n_train = STEPS + 2 * TIMED_STEPS
    require(launches["conv1x1_stats"] == CONV_PER_STEP * n_train,
            f"#10 launches over the path {launches}")
    print("conv1x1 path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; blocks {blocks}")
    perf = {"step0_loss": lc, "step0_loss_rel_exact": rel, "step0_grad_worst_rel": worst,
            "step0_grad_all_rel": total, "exact_self_worst_rel": self_worst,
            "exact_self_all_rel": self_total, "site_vs_exact": sites_vs_exact, "step_ms": mean_ms,
            "bound_ms_per_step": step_bound, "step_ms_blocks": blocks}
    perf.update(profile_steps(steps["conv1x1"], states["conv1x1"], batch))
    del states, steps
    return launches, perf


def conv_f32_bound(m: int, cin: int, cout: int, affine: bool) -> tuple[float, str]:
    """Least time of float32 #10 (#11 with affine): bytes (x, w read once, y
    and the sums written; A and B read) over the memory rate, or the GEMM's
    2*M*Cin*Cout operations and the statistics' (and the affine's) three a
    y (x) element over the float32 rate, the larger."""
    nbytes = 4 * (m * cin + cout * cin + m * cout + 2 * cout + (2 * cin if affine else 0))
    ops = 2.0 * m * cin * cout + 3.0 * m * cout + (3.0 * m * cin if affine else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_f32_phase(seed: int) -> dict:
    """Float32 kernels #10 and #11 against their plain versions at the six
    fused-site shapes of CONV_SHAPES, beside cuBLAS's float32 x @ w.T."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {f"{name}_f32": {} for name in CONV_REPLACES}
    for label, m, cin, cout, per_step in CONV_SHAPES:
        if per_step == 0:
            continue
        x2d = torch.randn(m, cin, device="cuda", generator=gen)
        w = torch.randn(cout, cin, device="cuda", generator=gen) / math.sqrt(cin)
        A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
        B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
        cases = {
            "conv1x1_stats_f32": (lambda: C.conv1x1_stats(x2d, w),
                                  lambda: C.conv1x1_stats_plain(x2d, w)),
            "conv1x1_bn_relu_stats_f32": (lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B),
                                          lambda: C.conv1x1_bn_relu_stats_plain(x2d, w, A, B)),
        }
        for name, (kernel, plain) in cases.items():
            (y, s1, s2), (py, ps1, ps2) = kernel(), plain()
            torch.cuda.synchronize()
            require(y.dtype == torch.float32, f"{name} {label}: y is {y.dtype}")
            err = float((y - py).abs().max())
            row = {"max_abs_err": err, "y_rel_err": err / float(py.abs().max())}
            require(row["y_rel_err"] <= F32_Y_RTOL, f"{name} {label}: y differs {row}")
            y64 = y.double()
            own = [float((u.double() - t).abs().max() / t.abs().max())
                   for u, t in ((s1, y64.sum(0)), (s2, (y64 * y64).sum(0)))]
            vs_plain = [float((u - t).abs().max() / t.abs().max())
                        for u, t in ((s1, ps1), (s2, ps2))]
            row["stats_rel_err_own_y"], row["stats_rel_err_plain"] = max(own), max(vs_plain)
            require(max(own) <= 1e-5, f"{name} {label}: s1/s2 vs its own y {own}")
            again = kernel()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(again, (y, s1, s2))),
                    f"{name} {label}: a second launch gave other bits")
            del y, s1, s2, py, ps1, ps2, y64, again
            row["ms"] = cuda_ms(kernel, 10)
            by_kernel = device_ms_by_kernel(kernel, 5)
            row["device_ms"] = sum(by_kernel.values())
            row["sum_device_ms"] = sum(v for k, v in by_kernel.items()
                                       if "conv1x1_sum_partials" in k)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["matmul_ms"] = cuda_ms(lambda: x2d @ w.T, 10)
            row["matmul_device_ms"] = device_ms(lambda: x2d @ w.T, 5)
            row["ratio_to_matmul"] = row["device_ms"] / row["matmul_device_ms"]
            row["bound_ms"], row["bound_by"] = conv_f32_bound(m, cin, cout, "bn_relu" in name)
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            report[name][label] = row
            print(f"conv kernel {name} {label} ({m}x{cin}->{cout}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del cases, x2d, w
        torch.cuda.empty_cache()
    return report


def conv1x1_f32_path(seed: int, batch) -> tuple[dict, dict]:
    """F32_STEPS float32 steps with conv1x1_fuse_min_cin=512 (float32 #10):
    the step-0 loss against the float32 exact step's."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config()
    exact = new_state(seed, dtype=torch.float32)
    le = step0(exact, batch, cfg)[0]
    del exact
    state = new_state(seed, dtype=torch.float32, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN)
    lc = step0(state, batch, cfg)[0]
    rel = abs(lc - le) / abs(le)
    step = make_train_step(state.model, cfg)
    C.reset_launches()
    state, losses = run_steps(step, state, batch, "float32 conv1x1", steps=F32_STEPS)
    launches = {f"{fn.__name__}_f32": fn.launches for fn in C.KERNELS}
    state, _, dt = timed(step, state, batch, F32_STEPS)
    print(f"float32 conv1x1 path: step-0 loss {lc!r}, float32 exact {le!r} (rel {rel:.3e}); "
          f"losses {losses}; launches after {F32_STEPS} steps {launches}; "
          f"{dt * 1e3:.2f} ms/step")
    require(rel <= F32_LOSS_RTOL, f"float32 conv1x1 step-0 loss {lc} differs from the float32 "
            f"exact step's {le}")
    require(launches == {"conv1x1_stats_f32": CONV_PER_STEP * F32_STEPS,
                         "conv1x1_bn_relu_stats_f32": 0}, f"float32 #10 launches {launches}")
    del state, step
    torch.cuda.empty_cache()
    return launches, {"step0_loss": lc, "exact_step0_loss": le, "step0_loss_rel_exact": rel,
                      "losses": losses, "step_ms": dt * 1e3}


def read_pixels(size: int, out: int, k: int, stride: int, lo: int) -> int:
    """How many of a spatial dimension's `size` positions a convolution's
    windows read (a 1x1/2 reads every other one)."""
    return len({stride * o + t - lo for o in range(out) for t in range(k)} & set(range(size)))


def conv_bias_bound(x_elems: int, m: int, cout: int, k: int, res: bool) -> tuple[float, str]:
    """Least time of the convolution kernel: bytes (the input pixels its
    windows read, the weight, the bias and the residual read once, y written
    once) over the memory rate, or the larger of the 2*M*Cout*K products
    over the bf16 tensor peak and the float32 epilogue (bias, residual,
    ReLU: 2 + res operations per output) over the float32 rate, the
    larger."""
    nbytes = 2 * x_elems + 2 * cout * k + 4 * cout + 2 * m * cout * (2 if res else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(2.0 * m * cout * k / BF16_TENSOR_OPS_PER_S,
                (2.0 + res) * m * cout / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_bias_phase(seed: int) -> dict:
    """The convolution kernel against its plain version at CONV_BIAS_SHAPES,
    beside bf16 cuDNN F.conv2d with the bias."""
    import torch
    import torch.nn.functional as F

    from simhand_tpu_torch.ops import conv_bias as CB

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, n, h, w, cin, cout, k, stride, padding, relu, with_res in CONV_BIAS_SHAPES:
        x = torch.randn(n, h, w, cin, device="cuda", generator=gen).bfloat16()
        wt = (torch.randn(cout, k * k * cin, device="cuda", generator=gen)
              / math.sqrt(k * k * cin)).bfloat16()
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        pads = CB.conv_pads(h, w, (k, k), stride, padding)
        oh, ow = CB.out_size(h, w, (k, k), stride, pads)
        res = (torch.randn(n, oh, ow, cout, device="cuda", generator=gen).bfloat16()
               if with_res else None)
        kw = dict(kernel=(k, k), stride=stride, padding=padding, relu=relu, res=res)
        # the yardstick: one cuDNN call, the NCHW views of the same memory
        xn = x.permute(0, 3, 1, 2)
        w4 = wt.view(cout, k, k, cin).permute(0, 3, 1, 2)
        b16 = b.bfloat16()
        lib_pad = (max(pads[0]), max(pads[1]))

        def kernel():
            return CB.conv_bias_act(x, wt, b, **kw)

        def plain():
            return CB.conv_bias_act_plain(x, wt, b, **kw)

        def library():
            return F.conv2d(xn, w4, b16, stride=stride, padding=lib_pad)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        a, c = got.float(), want.float()
        _, e = torch.frexp(torch.maximum(a.abs(), c.abs()))
        ulp = torch.ldexp(torch.ones_like(a), e - 8)
        diff = (a - c).abs()
        floor = (2.0**-16 * (CB.patches(x.float().abs(), (k, k), stride, pads)
                             @ wt.float().abs().T)).view(a.shape)
        row = {"max_abs_err": float(diff.max()),
               "share_differ": float((diff > 0).float().mean()),
               "share_over_one_ulp": float((diff > ulp).float().mean())}
        require(bool((diff <= ulp + floor).all()),
                f"conv_bias_act {label}: y beyond one bf16 ulp of the plain version's {row}")
        again = kernel()
        torch.cuda.synchronize()
        require(torch.equal(again, got), f"conv_bias_act {label}: a second launch gave other bits")
        del got, want, a, c, e, ulp, diff, floor, again
        big = n * oh * ow * cout >= 2**24
        row["ms"] = cuda_ms(kernel, 20 if big else 50)
        by_kernel = device_ms_by_kernel(kernel, 10)
        row["device_ms"] = sum(by_kernel.values())
        row["kernel_device_ms"] = sum(v for key, v in by_kernel.items()
                                      if "conv_bias_kernel" in key)
        row["plain_ms"] = cuda_ms(plain, 3)
        row["library_ms"] = cuda_ms(library, 20 if big else 50)
        row["library_device_ms"] = device_ms(library, 10)
        row["ratio_to_library"] = row["device_ms"] / row["library_device_ms"]
        x_read = (n * cin * read_pixels(h, oh, k, stride, pads[0][0])
                  * read_pixels(w, ow, k, stride, pads[1][0]))
        row["bound_ms"], row["bound_by"] = conv_bias_bound(x_read, n * oh * ow, cout,
                                                           k * k * cin, with_res)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        report[label] = row
        print(f"conv_bias_act {label} ({n}x{h}x{w}x{cin} -> {cout}, {k}x{k}/{stride}, res "
              f"{with_res}): " + " ".join(f"{key}={v:.4g}" if isinstance(v, float) else
                                          f"{key}={v}" for key, v in row.items()))
        del x, wt, b, res, xn, w4, b16
        torch.cuda.empty_cache()
    return {"conv_bias_act": report}


def block_bound(m: int, cin: int, cm: int) -> tuple[float, str]:
    """Least time of kernel #12: bytes (x read once, y written once, the bf16
    weights and float32 biases read once) over the memory rate, or the three
    GEMMs' 2*M*(Cin*Cm + 9*Cm^2 + Cm*Cin) operations over the bf16 tensor
    peak, the larger."""
    weights = cin * cm + 9 * cm * cm + cm * cin
    t_bytes = (2 * 2 * m * cin + 2 * weights + 4 * (2 * cm + cin)) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * weights / BF16_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def block_args(gen, imgs: int, hw, cin: int, cm: int):
    """x and the K-contiguous folded weights of one identity block, with the
    scales of a folded ResNet block (weights ~ 1/sqrt(fan-in))."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    x = randn(imgs * hw[0] * hw[1], cin).bfloat16()
    w1 = randn(cm, cin, scale=cin**-0.5).bfloat16()
    w2 = randn(cm, 9, cm, scale=(9 * cm) ** -0.5).bfloat16()
    w3 = randn(cin, cm, scale=cm**-0.5).bfloat16()
    return x, w1, 0.1 * randn(cm), w2, 0.1 * randn(cm), w3, 0.1 * randn(cin)


def cudnn_ops(fw: dict):
    """The folded walk's ops through cuDNN, the yardstick the port does not
    use: bf16 cuDNN convolutions (their float32 sums rounded to bf16), the
    float32 bias added in one pass and rounded again, ReLU on the bf16
    result, the shortcut's add in bf16."""
    import torch

    from simhand_tpu_torch.serving.int8_infer import _conv, _maxpool

    weights = {key: (w.to(torch.bfloat16), b.float()) for key, (w, b) in fw.items()}

    class CudnnBf16Ops:
        def input(self, key, x):
            return x.to(torch.bfloat16)

        def conv_bn(self, key, x, stride, padding):
            w, b = weights[key]
            y = _conv(x, w, stride, padding)
            return torch.add(y, b.view(1, -1, 1, 1), out=torch.empty_like(y))

        def conv_bn_relu(self, key, x, stride, padding):
            return torch.relu_(self.conv_bn(key, x, stride, padding))

        def add_relu(self, key, y, shortcut):
            return torch.relu_(y + shortcut)

        def maxpool(self, x):
            return _maxpool(x)

        def to_f32(self, x):
            return x.float()

    return CudnnBf16Ops()


def cudnn_walk(model):
    """The frozen bf16 folded forward through ``cudnn_ops``: images (N, H, W,
    3) -> (N, C) float32."""
    import torch

    from simhand_tpu_torch.serving import int8_infer

    ops = cudnn_ops(int8_infer._fold_resnet(model.encoder, model.resnet_size))

    def forward(images):
        with torch.no_grad():
            return int8_infer._walk_resnet(ops, model.resnet_size, images, pool=True)

    return forward


def cudnn_block(imgs: int, hw, args):
    """The same block through ``cudnn_ops`` (three bf16 cuDNN convolutions,
    the float32 biases, ReLUs and the shortcut's add): a zero-argument
    callable returning the (M, C) plane."""
    x, w1, b1, w2, b2, w3, b3 = args
    (h, w), cm, c = hw, w1.shape[0], x.shape[1]
    ops = cudnn_ops({"b/conv1": (w1.view(cm, c, 1, 1), b1),
                     "b/conv2": (w2.view(cm, 3, 3, cm).permute(0, 3, 1, 2).contiguous(), b2),
                     "b/conv3": (w3.view(c, cm, 1, 1), b3)})
    xi = x.view(imgs, h, w, c).permute(0, 3, 1, 2)

    def run():
        y = ops.conv_bn_relu("b/conv1", xi, 1, "SAME")
        y = ops.conv_bn_relu("b/conv2", y, 1, "SAME")
        y = ops.add_relu("b/out", ops.conv_bn("b/conv3", y, 1, "SAME"), xi)
        return y.permute(0, 2, 3, 1).reshape(-1, c)

    return run


def ulp_share(got, want) -> float:
    """Share of elements more than one bf16 ulp apart at the larger magnitude."""
    import torch

    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() > torch.ldexp(torch.ones_like(a), e - 8)).float().mean())


def block_kernel_phase(seed: int) -> dict:
    """Kernel #12 (three launches of the convolution kernel) against its
    plain version at BLOCK_SHAPES, beside the block through cuDNN."""
    import torch

    from simhand_tpu_torch.ops import bottleneck_block as BB

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, imgs, hw, cin, cm in BLOCK_SHAPES:
        args = block_args(gen, imgs, hw, cin, cm)
        m = args[0].shape[0]

        def kernel():
            return BB.bottleneck_block(*args, hw=hw)

        def plain():
            return BB.bottleneck_block_plain(*args, hw=hw)

        cudnn = cudnn_block(imgs, hw, args)
        got, want, walk = kernel(), plain(), cudnn()
        torch.cuda.synchronize()
        row = {"max_abs_err": float((got.float() - want.float()).abs().max()),
               "share_over_one_ulp": ulp_share(got, want),
               "cudnn_max_abs_diff": float((walk.float() - want.float()).abs().max())}
        close = bool(((got.float() - want.float()).abs()
                      <= BLOCK_RTOL + BLOCK_RTOL * want.float().abs()).all())
        require(close and row["share_over_one_ulp"] <= BLOCK_ULP_SHARE,
                f"#12 {label}: y differs from the plain version's {row}")
        del got, want, walk
        big = m * cin >= 2**24
        row["ms"] = cuda_ms(kernel, 20 if big else 50)
        row["device_ms"] = device_ms(kernel, 10)
        row["plain_ms"] = cuda_ms(plain, 3)
        row["cudnn_block_ms"] = cuda_ms(cudnn, 20 if big else 50)
        # its ~8 launches make the event time depend on the host's enqueue
        row["cudnn_block_device_ms"] = device_ms(cudnn, 10)
        row["bound_ms"], row["bound_by"] = block_bound(m, cin, cm)
        row["ratio_to_cudnn"] = row["device_ms"] / row["cudnn_block_device_ms"]
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        report[label] = row
        print(f"block kernel bottleneck_block {label} ({imgs} x {hw}, C {cin}, Cm {cm}): " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del args, cudnn
        torch.cuda.empty_cache()
    return {"bottleneck_block": report}


def serving_model(seed: int):
    """ResNet-50 ContrastiveModel in bf16 on the card, eval mode, with random
    weights and BatchNorm affines and running statistics from seed (scale
    1 + N(0, 0.1^2), bias N(0, 0.1^2), mean N(0, 0.1^2), var U(0.5, 1.5)):
    near the init's, so that 16 blocks neither blow up nor vanish, and far
    enough from mean 0 / var 1 to exercise the fold."""
    import torch

    from simhand_tpu_torch.models import ContrastiveModel

    torch.manual_seed(seed)
    model = ContrastiveModel(RESNET, dtype=torch.bfloat16).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                c = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, device="cuda", generator=gen))
    return model


def cosines(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1)


def timed_calls(fn, x, n: int) -> float:
    """ms of one call of fn(x) over n calls, host clock around a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def serving_path(seed: int) -> tuple[dict, dict, object]:
    """The frozen bf16 serving forward, every convolution on the kernel and
    layer4_1/2 through #12, against the cuDNN walk, the float32 walk and the
    model's eval forward."""
    import torch

    from simhand_tpu_torch.ops import bottleneck_block as BB
    from simhand_tpu_torch.ops import conv_bias as CB
    from simhand_tpu_torch.serving import fold_encoder_f32

    model = serving_model(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    images = torch.randn(SERVE_IMAGES, SIDE, SIDE, 3, device="cuda", generator=gen)
    walks = {"kernel": BB.make_folded_encoder_bf16(model, SERVE_BLOCKS),
             "cudnn": cudnn_walk(model),
             "eval": lambda x: model(x)[0]}
    BB.reset_launches()
    CB.reset_launches()
    emb = walks["kernel"](images)
    torch.cuda.synchronize()
    per_forward = {"bottleneck_block": BB.bottleneck_block.launches,
                   "conv_bias_act": CB.conv_bias_act.launches}
    require(per_forward == {"bottleneck_block": len(SERVE_BLOCKS),
                            "conv_bias_act": CONV_BIAS_PER_FORWARD},
            f"launches in one forward {per_forward}")
    with torch.no_grad():
        cudnn, ev = walks["cudnn"](images), walks["eval"](images)
        f32 = fold_encoder_f32(model)(images)["embedding"]
    require(emb.shape == (SERVE_IMAGES, 2048) and bool(emb.isfinite().all()),
            f"kernel walk embedding {tuple(emb.shape)}, finite {bool(emb.isfinite().all())}")
    scale = float(cudnn.abs().max())
    perf = {"launches_per_forward": per_forward, "embedding_max_abs": scale,
            "kernel_vs_cudnn_rel": float((emb - cudnn).abs().max()) / scale,
            "kernel_vs_f32_rel": float((emb - f32).abs().max()) / float(f32.abs().max()),
            "cudnn_vs_f32_rel": float((cudnn - f32).abs().max()) / float(f32.abs().max()),
            "min_cos_cudnn": float(cosines(emb, cudnn).min()),
            "min_cos_f32": float(cosines(emb, f32).min()),
            "min_cos_eval": float(cosines(emb, ev).min()),
            "cudnn_min_cos_f32": float(cosines(cudnn, f32).min())}
    print("serving forward: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                         for k, v in perf.items()))
    require(perf["kernel_vs_cudnn_rel"] <= SERVE_WALK_RTOL,
            f"kernel walk differs from the cuDNN walk by {perf['kernel_vs_cudnn_rel']:.3e}")
    require(perf["min_cos_cudnn"] > 0.99 and perf["min_cos_f32"] > 0.99
            and perf["min_cos_eval"] > 0.99,
            "kernel walk's embeddings do not track the cuDNN and float32 walks and the eval "
            "forward")
    del cudnn, ev, f32

    times = {k: [] for k in walks}
    with torch.no_grad():
        for name in ("kernel", "cudnn", "eval", "eval", "cudnn", "kernel"):
            times[name].append(timed_calls(walks[name], images, SERVE_TIMED))
    mean_ms = {k: sum(v) / len(v) for k, v in times.items()}
    perf.update({"forward_ms": mean_ms, "img_per_s": {k: SERVE_IMAGES / v * 1e3
                                                      for k, v in mean_ms.items()},
                 "forward_ms_blocks": times,
                 "launches_in_timing": {"bottleneck_block": BB.bottleneck_block.launches,
                                        "conv_bias_act": CB.conv_bias_act.launches}})
    print("serving forward timing (ms per forward of 256 images, in turns): " + ", ".join(
        f"{k} {v:.3f} = {SERVE_IMAGES / v * 1e3:.1f} img/s" for k, v in mean_ms.items())
        + f"; blocks {times}")
    print("serving profile: one step = one forward of the kernel walk")
    perf.update(profile_steps(lambda st, x: (st, walks["kernel"](x)), None, images))
    print("serving profile: one step = one forward of the cuDNN walk")
    perf["cudnn_walk"] = profile_steps(lambda st, x: (st, walks["cudnn"](x)), None, images)
    # the walk's float32 bias adds are gone; the yardstick shows the check sees them
    require(perf["profile_float_add_launches"] == 0,
            f"the kernel walk ran {perf['profile_float_add_launches']} float32 adds a forward")
    require(perf["cudnn_walk"]["profile_float_add_launches"] > 0,
            "the profile shows no float32 add in the cuDNN walk: the check cannot see them")
    return per_forward, perf, walks["kernel"]


def server_phase(forward) -> dict:
    """The micro-batcher and its HTTP handler over the kernel walk on
    127.0.0.1: eight concurrent requests of mixed sizes checked against the
    direct forward, /healthz, then a burst for requests/s whose answers are
    checked the same way."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from simhand_tpu_torch.serving import MicroBatcher, make_handler
    from simhand_tpu_torch.serving.embed import _preprocess_fn
    from simhand_tpu_torch.serving.server import _nearest_resize

    rng = np.random.default_rng(0)
    sizes = [(128, 128), (96, 160), (200, 200), (64, 64), (128, 100), (150, 90), (128, 128),
             (256, 192)]
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    class Server(ThreadingHTTPServer):
        request_queue_size = 4 * SERVER_BATCH   # a burst's connections wait in the backlog

    batcher = MicroBatcher(lambda x: {"embedding": forward(x)}, SIDE, SERVER_BATCH, 200.0)
    httpd = Server(("127.0.0.1", 0), make_handler(batcher))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def post(img, out, i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/infer?h={img.shape[0]}&w={img.shape[1]}",
            data=img.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            out[i] = json.loads(resp.read())

    def burst(images):
        out = [None] * len(images)
        threads = [threading.Thread(target=post, args=(img, out, i))
                   for i, img in enumerate(images)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        require(not any(th.is_alive() for th in threads), "server requests did not finish")
        return out, time.perf_counter() - t0

    try:
        results, dt = burst(imgs)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            require(r.read() == b"ok\n", "/healthz did not answer ok")
        padded = np.zeros((SERVER_BATCH, SIDE, SIDE, 3), np.uint8)
        padded[:len(imgs)] = np.stack([_nearest_resize(img, SIDE) for img in imgs])
        want = forward(_preprocess_fn(SIDE)(padded)).cpu().numpy()

        def row_errors(answers, what):
            """Each answer's distance from the direct forward's row of its
            image; fails on a request left unanswered or a row off by more
            than 1e-4."""
            errs = []
            for i, res in enumerate(answers):
                require(res is not None, f"{what} request {i} was not answered")
                got, ref = np.asarray(res["embedding"], np.float32), want[i % len(imgs)]
                require(got.shape == ref.shape, f"{what} request {i}: row of shape {got.shape}")
                errs.append(float(np.abs(got - ref).max()))
                require(bool(np.allclose(got, ref, rtol=1e-4, atol=1e-4)),
                        f"{what} request {i}: row differs from the direct forward by {errs[-1]}")
            return errs

        errs = row_errors(results, "mixed-size")
        n_burst = 2 * SERVER_BATCH
        many = [imgs[i % len(imgs)] for i in range(n_burst)]
        answers, dt_burst = burst(many)
        burst_errs = row_errors(answers, "burst")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    require(not batcher.thread.is_alive(), "the micro-batcher's executor did not stop")
    perf = {"requests": len(imgs), "max_abs_err": max(errs), "first_burst_s": dt,
            "burst_requests": n_burst, "burst_s": dt_burst, "burst_max_abs_err": max(burst_errs),
            "requests_per_s": n_burst / dt_burst}
    print(f"server: {len(imgs)} concurrent requests answered in {dt:.3f} s, rows within "
          f"{max(errs):.3e} of the direct forward; burst of {n_burst} requests, every row "
          f"within {max(burst_errs):.3e} of it, in {dt_burst:.3f} s = "
          f"{n_burst / dt_burst:.1f} requests/s")
    return perf


def plain_family(state, batch) -> tuple[dict, dict]:
    """simhand-base steps through kernels #1 and #3: step 0's loss and
    dL/dprojections against the dense route on the same projections, the
    launches, and a profile with #1's and #3's ms and launches a step."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config(experiment_type="simhand-base")
    compare_routes(state, batch, cfg, "plain family step 0")
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
    perf = profile_steps(step, state, batch)
    for name in ("ntxent_denominator", "ntxent_grad"):
        group, want = NTXENT_PROFILE_GROUPS[name][0], ntxent_launches_a_step(name)
        require(perf[f"profile_{group}_launches"] == want,
                f"the plain family's profile counts {perf[f'profile_{group}_launches']} "
                f"launches of {name} a step, not {want} (the kernel and its sum pass)")
    return launches, perf


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
    # one compiler for each source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(native.build, SOURCES))
    print(f"built {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    card = card_line()
    print(card)

    report = kernel_phase(args.seed)
    bn_report = bn_kernel_phase(args.seed)
    fused_bn_report = fused_bn_kernel_phase(args.seed)
    conv_report = conv_kernel_phase(args.seed)
    conv_report.update(conv_f32_phase(args.seed))
    conv_bias_report = conv_bias_phase(args.seed)
    block_report = block_kernel_phase(args.seed)
    state, batch, main_launches, perf = main_path(args.seed)
    cache_fed_perf = cache_fed_path(args.seed, state, batch)
    bn_launches, bn_perf = epilogue_path(args.seed, state, batch, perf["step0_loss"])
    fused_bn_launches, fused_bn_perf = fused_bn_path(args.seed, state, batch, perf["step0_loss"])
    conv_launches, conv_perf = conv1x1_path(args.seed, state, batch)
    plain_launches, plain_perf = plain_family(state, batch)
    del state
    f32_launches, f32_perf = conv1x1_f32_path(args.seed, batch)
    conv_launches.update(f32_launches)
    del batch
    serve_launches, serve_perf, kernel_walk = serving_path(args.seed)
    server_perf = server_phase(kernel_walk)

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
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "sum_device_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **{k: main_row[k] for k in ("exact_pair_ms", "exact_pair_device_ms",
                                        "pair_bound_ms")},
            "at": shapes,
        })
    main_row = fused_bn_report["bn_backward_reduces"]["stem_bf16"]
    kernels.append({
        "name": "bn_backward_reduces", "route": "cuda", "source": SOURCES["bn_epilogue"],
        "replaces": FUSED_BN_REPLACES["bn_backward_reduces"],
        "launches": fused_bn_launches["bn_backward_reduces"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")},
        "at": fused_bn_report["bn_backward_reduces"],
    })
    for name, shapes in conv_report.items():
        main_row = shapes[CONV_MAIN_SHAPE]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["conv1x1"],
            "replaces": CONV_REPLACES[name.removesuffix("_f32")], "launches": conv_launches[name],
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "sum_device_ms",
                                        "plain_ms", "bound_ms", "bound_by", "matmul_ms",
                                        "ratio_to_matmul")},
            "library_ms": None, "at": shapes,
        })
    main_row = conv_bias_report["conv_bias_act"][CONV_BIAS_MAIN_SHAPE]
    kernels.append({
        "name": "conv_bias_act", "route": "cuda", "source": SOURCES["conv_bias"],
        "replaces": CONV_BIAS_REPLACES["conv_bias_act"],
        "launches": serve_launches["conv_bias_act"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")},
        "at": conv_bias_report["conv_bias_act"],
    })
    main_row = block_report["bottleneck_block"][BLOCK_MAIN_SHAPE]
    kernels.append({
        "name": "bottleneck_block", "route": "cuda", "source": SOURCES["conv_bias"],
        "replaces": BLOCK_REPLACES["bottleneck_block"],
        "launches": serve_launches["bottleneck_block"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "cudnn_block_ms", "cudnn_block_device_ms",
                                    "share_over_one_ulp")},
        "library_ms": None, "at": block_report["bottleneck_block"],
    })
    for k in kernels:
        print(f"kernel {k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
              f"ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f}")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"step": perf, "cache_fed_step": cache_fed_perf,
                      "epilogue_step": bn_perf, "fused_bn_step": fused_bn_perf,
                      "conv1x1_step": conv_perf, "conv1x1_f32_step": f32_perf,
                      "plain_family_step": plain_perf,
                      "serving": serve_perf, "server": server_perf, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
