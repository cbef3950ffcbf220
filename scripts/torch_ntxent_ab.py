#!/usr/bin/env python3
"""Times variants of the tensor-core NT-Xent kernels #1, #2 and #3 of the
PyTorch port (``csrc/ntxent.cu``) against the source as it stands, in turns
on one card.

    python3 scripts/torch_ntxent_ab.py [--variants name ...] [--rounds 1] [--seed 0] \
        [--other label=path/to/ntxent.cu ...]

Each variant in ``VARIANTS`` (all of them unless ``--variants`` names some)
is a textual edit of ``csrc/ntxent.cu``; each other source must have the
same C entry points for #2 and #3, and for #1 either today's or the one
before #1 took the tensor-core grid (no ``cols_per_split``; its grid is
then planned as that source's wrapper planned it). The source, the others
and the variants are built at once with the port's nvcc flags into
``build/ab/``, and each one's ptxas registers and spills for #1
(``plain_denom_kernel``, or the earlier ``ntxent_tile_kernel``), #2
(``weighted_denom_kernel``) and #3 (``plain_grad_kernel``) are printed. At
each shape of ``chip_smoke.SHAPES``, every version of #1-#3 is held
against its plain version (rel 1e-5; 1e-5 of max|G|) with a second launch
bit-equal; then the device time of each (torch.profiler, kernel and sum
pass) in the order kept, variants, variants reversed, kept, ``--rounds``
times. Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from simhand_tpu_torch import native  # noqa: E402
from simhand_tpu_torch.losses import ntxent_kernels as K  # noqa: E402

KERNELS = {"ntxent_denominator": ("plain_denom_kernel", "ntxent_tile_kernel"),
           "weighted_ntxent_denominator": ("weighted_denom_kernel",),
           "ntxent_grad": ("plain_grad_kernel",)}
# #1's tile width in a source, and its entry point before it took cols_per_split
DBN = re.compile(r"constexpr int DBN = (\d+);")
OLD_DENOMINATOR = "int splits, void* partial, void* out, void* stream) {\n  if (M <= 0"

# #3's P z_c with both halves of 64 features in flight at once
BOTH_HALVES = """    {
      float p0[32], p1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p0[i] = p1[i] = 0.f;
      fence_regs(p0);
      fence_regs(p1);
      wgmma_fence();
      const uint32_t bs[3] = {ZT_HI, ZT_LO, ZT_HI};
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int ks = 0; ks < GBN / 8; ++ks) {
          const uint32_t(&a)[16] = p == 0 ? pl : ph;
          mma_n64_rs(p0, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                     smem_desc(base + bs[p] + ks * 32), p + ks > 0);
          mma_n64_rs(p1, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                     smem_desc(base + bs[p] + 64 * 128 + ks * 32), p + ks > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p0);
      fence_regs(p1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[i] = __fadd_rn(acc[i], p0[i]);
        acc[32 + i] = __fadd_rn(acc[32 + i], p1[i]);
      }
    }
"""
# #2's joint distance, and two other ways to compute it
DIST = "  return sqrt_approx(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));"
RSQRT_DIST = """  const float x = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(x, 1e-30f)));
  return __fmul_rn(x, r);"""
NO_FFMA_DIST = "  return sqrt_approx(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));"


def _both_halves(src: str) -> str:
    """#3's second product replaced by BOTH_HALVES (#4's kept)."""
    at = src.index("plain_grad_kernel(const float*")
    body = src[at:]
    start = body.index("#pragma unroll\n    for (int half = 0; half < 2; ++half) {")
    end = body.index("    __syncwarp();\n    if (lane == 0) mbar_arrive(zt_free);")
    return src[:at] + body[:start] + BOTH_HALVES + body[end:]


HELPER_MAP = "    const int h = tid - MMA_THREADS, jb = h / (D / 4), db = h % (D / 4);"


VARIANTS = {
    # #1 on 32-column tiles (#2's m64n32k8 product) where it takes 64
    "tile32": lambda s: s.replace("constexpr int DBN = 64;", "constexpr int DBN = 32;"),
    # #2's product in three chains of wgmma, one a TF32 pass (#3's)
    "three_chains": lambda s: s.replace("product_rows_cols<1>(", "product_rows_cols<3>("),
    # #3's product in one chain (#2's)
    "one_chain": lambda s: s.replace("product_rows_cols<3>(", "product_rows_cols<1>("),
    # #3's two halves of P z_c in flight together
    "both_halves": _both_halves,
    # #2's square roots as x * rsqrt(x) (one MUFU.RSQ and a multiply; 0 at x = 0)
    "rsqrt": lambda s: s.replace(DIST, RSQRT_DIST),
    # #2's squared distance without the FFMA (two multiplies and an add)
    "no_ffma": lambda s: s.replace(DIST, NO_FFMA_DIST),
    # #3's helpers laid out so that the eight lanes of a quarter-warp hit
    # distinct banks in the raw loads and in both planes' 16-byte stores (on
    # #4's layout the transposed stores take four times the wavefronts)
    "conflict_free_helpers": lambda s: s.replace(HELPER_MAP, (
        "    const int h = tid - MMA_THREADS, q = h % 8, u = h / 8;\n"
        "    const int jb = (q / 2) ^ (u % 8), db = q + 8 * (u / 8);")),
}


def build(label: str, text: str) -> tuple[ctypes.CDLL, str]:
    """Builds one version of the source; returns it loaded, and its ptxas
    registers and spills for #1-#3."""
    out_dir = native.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"ntxent_{label}.cu"
    src.write_text(text)
    lib_path = out_dir / f"libntxent_{label}.so"
    res = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC), "-o",
                          str(lib_path), str(src)], capture_output=True, text=True, check=True)
    report = []
    block = res.stdout + res.stderr
    for kernels in KERNELS.values():
        kernel, at = next((k, m.start()) for k in kernels
                          for m in [re.search(rf"{k}[EI]", block)] if m)
        regs = re.search(r"Used (\d+) registers", block[at:]).group(1)
        spill = re.search(r"(\d+) bytes spill stores", block[at:]).group(1)
        report.append(f"{kernel} {regs} registers, {spill} bytes spilled")
    if "serialized" in res.stdout + res.stderr:
        report.append("ptxas serialised wgmma")
    lib = ctypes.CDLL(str(lib_path))
    for name in KERNELS:
        getattr(lib, name).argtypes = K._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    if OLD_DENOMINATOR in text:        # no cols_per_split
        lib.ntxent_denominator.argtypes = K._SIGNATURES["ntxent_denominator"][:7] + [
            ctypes.c_void_p] * 3
    return lib, "; ".join(report)


def old_denominator_splits(m: int, n: int, device) -> int:
    """Column splits of #1's grid before it took the tensor-core grid:
    enough for about two 64-row blocks an SM, at most one a 64-column tile."""
    return max(1, min(math.ceil(n / 64), math.ceil(2 * K._sm_count(device) / math.ceil(m / 64))))


def caller(lib: ctypes.CDLL, name: str, text: str):
    """The wrapper's arguments -> its kernel's output, through lib built
    from the source ``text``."""
    import torch

    tile = K._TILE[name]
    if name == "ntxent_denominator" and OLD_DENOMINATOR not in text:
        tile = int(DBN.search(text).group(1))

    def call(*a):
        m, n, temperature = a[0].shape[0], a[1].shape[0], a[-1]
        if name == "ntxent_denominator":
            inputs, out = list(a[:3]), a[0].new_empty((m,))
        elif name == "ntxent_grad":
            inputs, out = list(a[:5]), a[0].new_empty((m, K.D))
        else:
            z_rows, z_cols, j_rows, j_cols, row_ids, d_max, d_min, _ = a
            inputs = [z_rows, z_cols, j_rows.reshape(m, 42), j_cols.reshape(n, 42), row_ids,
                      torch.stack([d_max, d_min])]
            out = a[0].new_empty((m,))
        if name == "ntxent_denominator" and OLD_DENOMINATOR in text:
            splits = old_denominator_splits(m, n, out.device)
            grid = [splits]
        else:
            splits, cols = K._tensor_core_grid(m, n, out.device, tile)
            grid = [splits, cols]
        partial = out if splits == 1 else out.new_empty((splits, *out.shape))
        err = getattr(lib, name)(*[t.data_ptr() for t in inputs], m, n, float(temperature),
                                 *grid, partial.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        chip_smoke.require(err == 0, f"{name}: CUDA error {err}")
        return out

    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[], metavar="label=path")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS), default=list(VARIANTS))
    parser.add_argument("--rounds", type=int, default=1,
                        help="times each version is timed in each direction of the order")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    from simhand_tpu_torch.losses.weights import pairwise_minmax

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    source = (native.CSRC / "ntxent.cu").read_text()
    texts = {"kept": source, **{k: VARIANTS[k](source) for k in args.variants}}
    for label, text in texts.items():
        chip_smoke.require(label == "kept" or text != source, f"variant {label} changed nothing")
    for spec in args.other:
        label, path = spec.split("=", 1)
        texts[label] = Path(path).read_text()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(build, texts, texts.values())))
    for label, (_, ptxas) in built.items():
        print(f"{label}: {ptxas}", flush=True)
    order = (list(built) + list(reversed(built))) * args.rounds
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {}
    for label, m, n, offset in chip_smoke.SHAPES:
        z_cols = torch.randn(n, 128, device="cuda", generator=gen)
        z_cols = z_cols / z_cols.norm(dim=1, keepdim=True)
        j_cols = torch.rand(n, 21, 2, device="cuda", generator=gen) * 128.0
        z_rows, j_rows = (t[offset:offset + m].contiguous() for t in (z_cols, j_cols))
        row_ids = torch.arange(offset, offset + m, dtype=torch.int32, device="cuda")
        col_ids = torch.arange(n, dtype=torch.int32, device="cuda")
        d_min, d_max = pairwise_minmax(j_cols, "mpjpe")
        inv_cols = 1.0 / K.ntxent_denominator_plain(z_cols, z_cols, col_ids, 0.5)
        inv_rows = inv_cols[offset:offset + m].contiguous()
        inputs = {
            "ntxent_denominator": (z_rows, z_cols, row_ids, 0.5),
            "weighted_ntxent_denominator": (z_rows, z_cols, j_rows, j_cols, row_ids, d_max, d_min,
                                            0.5),
            "ntxent_grad": (z_rows, z_cols, inv_rows, inv_cols, row_ids, 0.5),
        }
        for name, a in inputs.items():
            want = getattr(K, f"{name}_plain")(*a)
            calls = {k: caller(lib, name, texts[k]) for k, (lib, _) in built.items()}
            for k, call in calls.items():
                got, again = call(*a), call(*a)
                torch.cuda.synchronize()
                chip_smoke.require(torch.equal(got, again), f"{k} {name} {label}: other bits")
                if "grad" in name:
                    err, limit = float((got - want).abs().max()), 1e-5 * float(want.abs().max())
                else:
                    err, limit = float(((got - want) / want).abs().max()), 1e-5
                chip_smoke.require(err <= limit, f"{k} {name} {label}: err {err} > {limit}")
            iters = 50 if m * n <= 512 * 16384 else 5
            times = {k: [] for k in calls}
            for k in order:
                times[k].append(chip_smoke.device_ms(lambda: calls[k](*a), iters))
            row = {k: sum(v) / len(v) for k, v in times.items()}
            report.setdefault(name, {})[label] = row
            print(f"{name} {label} device ms: " + " ".join(f"{k}={v:.5f}" for k, v in row.items()),
                  flush=True)
        del inputs, z_cols, j_cols, z_rows, j_rows, inv_cols, inv_rows
        torch.cuda.empty_cache()
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"card": card, "ptxas": {k: v for k, (_, v) in built.items()},
                      "device_ms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
