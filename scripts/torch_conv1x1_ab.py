#!/usr/bin/env python3
"""Times kernels #10/#11 of the PyTorch port (``csrc/conv1x1.cu``) against
other versions of the same source, in turns on one card.

    python3 scripts/torch_conv1x1_ab.py --other old=path/to/conv1x1.cu [--other ...]

Each other source is built with the port's nvcc flags into ``build/`` and
called through the same C entry points (a source without
``conv1x1_partial_floats`` gets one (2, N) row of scratch per 128-row
tile, as the first design took). At each shape of ``chip_smoke.CONV_SHAPES``
but the largest, for #10 and #11: every version's y, s1 and s2 must equal
this tree's within one bf16 ulp (plus 2^-16 * sum |x||w|) and rel 1e-3;
then the device time of each (torch.profiler, kernel and sum pass) in the
order this, others, others reversed, this, and cuBLAS's x @ w.T. Prints one
JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from simhand_tpu_torch import native  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_other(label: str, src: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = native.BUILD_DIR / f"libconv1x1_{label}-{digest}.so"
    if not out.exists():
        native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def caller(lib: ctypes.CDLL):
    """(affine, x2d, w, A, B) -> (y, s1, s2) through lib's entry points."""
    import torch

    lib.conv1x1_stats.argtypes = [_P, _P] + [_I] * 3 + [_P] * 4
    lib.conv1x1_bn_relu_stats.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 4
    sized = hasattr(lib, "conv1x1_partial_floats")
    if sized:
        lib.conv1x1_partial_floats.argtypes = [_I, _I]

    def call(affine, x2d, w, A, B):
        m, cout = x2d.shape[0], w.shape[0]
        y = x2d.new_empty((m, cout))
        out = x2d.new_empty((2, cout), dtype=torch.float32)
        floats = lib.conv1x1_partial_floats(m, cout) if sized else math.ceil(m / 128) * 2 * cout
        partial = out if floats <= 2 * cout else out.new_empty(floats)
        stream = torch.cuda.current_stream().cuda_stream
        consts = (A.data_ptr(), B.data_ptr()) if affine else ()
        fn = lib.conv1x1_bn_relu_stats if affine else lib.conv1x1_stats
        err = fn(x2d.data_ptr(), w.data_ptr(), *consts, m, cout, x2d.shape[1], y.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return y, out[0], out[1]

    return call


def check(got, want, xin, w, what: str) -> None:
    import torch

    a, b = got[0].float(), want[0].float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    floor = 2.0**-16 * (xin.float().abs() @ w.float().abs().T)
    chip_smoke.require(bool(((a - b).abs() <= ulp + floor).all()), f"{what}: y differs")
    for s, t in zip(got[1:], want[1:]):
        rel = float((s - t).abs().max() / t.abs().max())
        chip_smoke.require(rel <= 1e-3, f"{what}: sums differ by {rel}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", required=True,
                        help="label=path of another conv1x1.cu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    callers = {"this": caller(native.load("conv1x1"))}
    for spec in args.other:
        label, path = spec.split("=", 1)
        callers[label] = caller(build_other(label, Path(path)))
    order = list(callers) + list(reversed(callers))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {}
    for label, m, cin, cout, _ in chip_smoke.CONV_SHAPES:
        if m > 1 << 20:
            continue
        x2d = torch.randn(m, cin, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(cout, cin, device="cuda", generator=gen) / math.sqrt(cin)).bfloat16()
        A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
        B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
        xa = torch.relu(x2d.float() * A + B).bfloat16()
        for affine, name in ((False, "conv1x1_stats"), (True, "conv1x1_bn_relu_stats")):
            want = callers["this"](affine, x2d, w, A, B)
            for other, call in callers.items():
                check(call(affine, x2d, w, A, B), want, xa if affine else x2d, w,
                      f"{other} {name} {label}")
            times = {k: [] for k in callers}
            for k in order:
                times[k].append(chip_smoke.device_ms(
                    lambda: callers[k](affine, x2d, w, A, B), 10))
            row = {k: sum(v) / len(v) for k, v in times.items()}
            row["matmul_device_ms"] = chip_smoke.device_ms(lambda: x2d @ w.T, 10)
            report.setdefault(name, {})[label] = row
            print(f"{name} {label} ({m}x{cin}->{cout}) device ms: "
                  + " ".join(f"{k}={v:.5f}" for k, v in row.items()), flush=True)
        del x2d, w, xa
        torch.cuda.empty_cache()
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"card": card, "device_ms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
