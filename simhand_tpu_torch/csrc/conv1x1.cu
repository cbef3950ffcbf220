// 1x1 convolution as a bf16 matrix product with a BatchNorm-statistics
// epilogue, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of simhand_tpu/ops/conv1x1.py, both
// reached through _stats_call and _stats_epilogue:
//   conv1x1_stats          (AFFINE = false) <- conv1x1_stats / _matmul_stats_kernel
//   conv1x1_bn_relu_stats  (AFFINE = true)  <- conv1x1_bn_relu_stats /
//                                              _affine_matmul_stats_kernel
//
// What they compute, for x the row-major (M, K) bf16 plane of a
// channels-last activation and w the row-major (N, K) bf16 weight (the
// (Cout, Cin) view of a 1x1 convolution's weight):
//   AFFINE:  x[m, k] <- bf16(relu(float(x[m, k]) * A[k] + B[k]))
//            (__fmul_rn, then __fadd_rn, then fmaxf(., 0), then bf16 RN)
//   y[m, n] = bf16(sum_k x[m, k] w[n, k])       float32 accumulation
//   s1[n]   = sum_m float(y[m, n]),  s2[n] = sum_m float(y[m, n])^2
// The statistics are those of the rounded y, as the reference's epilogue
// takes them (conv1x1.py:50-57).
//
// What bounds them on this card: the ResNet-50 step's sites are either
// memory-bound (131,072 x 512 -> 128: 0.18 GB, 0.050 ms at 3.35 TB/s against
// 17 GFLOP, 0.017 ms at 989 TFLOP/s) or operation-bound (8,192 x 2,048 ->
// 512: 17 GFLOP against 0.043 GB). Both need the tensor cores' wgmma path
// and loads that never wait on the math.
//
// Design: a warp-specialised, persistent TMA + wgmma GEMM.
// - Tiles of 128 rows x BN columns, BN = 128 when N <= 128, else 256, so at
//   the step's memory-bound sites (N <= 256) one tile spans every column
//   and each x row is read from memory once.
// - Three warpgroups. The third is the producer: one thread issues TMA
//   loads (cp.async.bulk.tensor, 128-byte swizzle, K boxes of 64) of the x
//   and w tiles into a ring of STAGES stages with full/empty mbarriers. The
//   first two are consumers: each owns 64 rows of the tile and runs
//   wgmma.m64n{BN}k16 with a float32 accumulator in registers (BN / 2 a
//   thread); setmaxnreg moves the producer's registers to them. TMA fills
//   out-of-bounds rows and columns with zeros and clips out-of-bounds
//   stores, so a ragged M, N or K needs no masks.
// - Clusters of two CTAs on neighbouring SMs share the column tile: each
//   producer loads its own x tile and half of the w tile, which TMA
//   multicasts into both CTAs, so a CTA pulls 16 KB + BN * 64 bytes a K
//   step from L2 instead of 16 KB + BN * 128. On an NVIDIA H100 80GB HBM3
//   at 700 W (scripts/torch_conv1x1_ab.py, in turns) that took 32,768 x
//   1,024 -> 256 from 0.0434 to 0.0383 ms and 8,192 x 2,048 -> 512 from
//   0.0330 to 0.0301, and cost <= 2% at the other sites. A stage's empty
//   barrier counts the consumer warps of both CTAs; each producer, before
//   it exits, waits until both CTAs have released every stage.
// - A persistent grid: n_tiles * rows CTAs, rows / 2 = min(ceil(m_tiles /
//   2), clusters / n_tiles), with clusters the number the card holds at
//   once. Cluster q keeps column tile q % n_tiles and walks pairs of row
//   tiles, so the CTAs at work together read the same x rows (through L2),
//   and the producer loads the next tile while the consumers run the
//   epilogue.
// - AFFINE takes wgmma's register-A form: each consumer ldmatrix-es its
//   64 x 16 slices of the swizzled x stage, applies the affine to the
//   fragments (the K index of every register follows from the m16n8k16 A
//   layout), and issues wgmma with A in registers and w in shared memory;
//   the transformed x never goes back to shared memory. A and B are read
//   through the read-only cache; K columns past K take A = B = 0, so the
//   zero-filled x stays 0.
// - Epilogue, per consumer warpgroup: the accumulators are rounded to bf16
//   into a y stage of its own (swizzled as the y tensor map's boxes, so the
//   4-byte stores hit 32 banks), which one thread stores with TMA while the
//   next tile's loads already run. The column sums are taken from the same
//   rounded stage: thread (half, pair) adds rows of two columns in order, a
//   16-byte row segment per warp; shared loads cost fewer instructions than
//   the shuffle reduction over the accumulator registers would (64 loads a
//   thread at BN = 256 against 3 x 4 shuffles for each of 32 column groups)
//   and need no registers beside the accumulators. Rows at or past M are
//   left out (with AFFINE they hold relu(B) @ w, not 0). Each thread adds a
//   tile's rows, then that sum into its running sums over all of its CTA's
//   tiles (two levels: at 8,388,481 rows a thread covers ~500 tiles); at
//   the end the parts are added in a fixed order into one (2, N) row a row
//   group, and a second kernel adds the <= 132 rows: eight warps a block
//   each add every eighth row for 32 columns, then one adds the eight in
//   turn (one thread adding all the rows in order waits on L2 at every
//   step: 3.9 us at 131,072 x 512 -> 128 on an NVIDIA H100 80GB HBM3 at
//   700 W, against 2.2 us). No atomics: the same inputs give the same bits
//   on one card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int BM = 128;         // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 64;          // K columns of a stage: one 128-byte swizzle row
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int SUB = 64 * 128;   // bytes of one 64 x 64 bf16 box of y

template <int BN>
struct Config {
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr int X_BYTES = BM * BK * 2;           // 16 KB
  static constexpr int STAGE_BYTES = X_BYTES + BN * BK * 2;
  static constexpr int Y_BYTES = BM * BN * 2;          // y stage of both warpgroups
  static constexpr int PAIRS = BN / 2;                 // column pairs of a tile
  static constexpr int SPLIT = 128 / PAIRS;            // threads that sum one pair
  static constexpr int RED_BYTES = 2 * SPLIT * 2 * BN * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + Y_BYTES + RED_BYTES + 2 * STAGES * 8;
};
static_assert(Config<256>::SMEM <= 232448 && Config<128>::SMEM <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers, TMA, named barriers ---------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// box (c0 + [0, box0), c1 + [0, box1)) of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the same box into the same offsets of both CTAs of the cluster, each of
// whose barrier at bar's offset counts the bytes
__device__ __forceinline__ void tma_load_both(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"((uint16_t)3)
      : "memory");
}
// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- wgmma -----------------------------------------------------------------

// K-major operand of 8-row groups 1,024 bytes apart (rows of 128 bytes),
// 128-byte swizzle; a K step of 16 adds 32 bytes (2 units) to the address
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
              "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define D64 D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
#define D128 D64, D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
#define REGS64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define REGS128                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "        \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "        \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "        \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "        \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "        \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "  \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "     \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= a b for a 64 x 16 slice of x and a BN x 16 slice of w; ss: both from
// shared memory, rs: a in registers (the m16n8k16 A fragment of each warp);
// scale_d = 0 starts the sum
template <int BN>
struct Mma;
template <>
struct Mma<128> {
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : D64
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <>
struct Mma<256> {
  __device__ static __forceinline__ void ss(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : D128
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ static __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// relu(x * a + b) of one bf16 value, rounded to bf16
__device__ __forceinline__ uint32_t affine1(uint32_t bits, float a, float b) {
  const float v = fmaxf(__fadd_rn(__fmul_rn(__uint_as_float(bits << 16), a), b), 0.f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// the same for the two bf16 values of a 32-bit word (k in the low half, k + 1)
__device__ __forceinline__ uint32_t affine2(uint32_t v, const float (&a)[2], const float (&b)[2]) {
  return affine1(v & 0xffffu, a[0], b[0]) | (affine1(v >> 16, a[1], b[1]) << 16);
}

// Grid: clusters of two CTAs, n_tiles * rows / 2 of them. Cluster q
// computes column tile q % n_tiles; its CTA of rank r walks the row tiles
// 2 (q / n_tiles) + r + i * rows and writes its (2, N) column sums, over all
// of them, to partial[2 (q / n_tiles) + r]. Each CTA loads its own x tiles
// and half of every w tile, which TMA writes into both CTAs.
template <int BN, bool AFFINE>
__global__ void __launch_bounds__(THREADS, 1)
conv1x1_stats_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap y_map, const float* __restrict__ A,
                     const float* __restrict__ B, int M, int N, int K,
                     float* __restrict__ partial) {
  using Cfg = Config<BN>;
  constexpr int STAGES = Cfg::STAGES, PAIRS = Cfg::PAIRS, SPLIT = Cfg::SPLIT;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: the tiles start on it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ystage = ring + STAGES * Cfg::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(ystage + Cfg::Y_BYTES);
  const uint32_t full0 = smem_u32(ystage + Cfg::Y_BYTES + Cfg::RED_BYTES);
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
  const int k_tiles = (K + BK - 1) / BK;
  const int cluster = (int)blockIdx.x / 2, rank = (int)cluster_rank();
  const int rows = (int)gridDim.x / n_tiles, first = 2 * (cluster / n_tiles);
  const int group = first + rank, n0 = (cluster % n_tiles) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 16);   // one arrival per consumer warp of both CTAs
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // both CTAs' barriers exist before either is signalled

  const int wg = (int)threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      // a tile past the last (rank 1 of an odd count) or a w half past N
      // loads valid rows instead: their results are neither stored nor summed
      const int w_row = n0 + rank * (BN / 2) < N ? n0 + rank * (BN / 2) : 0;
      const uint32_t w_dst = Cfg::X_BYTES + rank * (BN / 2) * 128;
      int stage = 0;
      uint32_t phase = 0;
      for (int mt0 = first; mt0 < m_tiles; mt0 += rows) {
        const int x_row = mt0 + rank < m_tiles ? (mt0 + rank) * BM : 0;
        for (int kt = 0; kt < k_tiles; ++kt) {
          // the stage is free in both CTAs: the peer's half lands here too
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t xs = smem_u32(ring + stage * Cfg::STAGE_BYTES);
          mbar_expect_tx(full, Cfg::STAGE_BYTES);
          tma_load(xs, &x_map, full, kt * BK, x_row);
          tma_load_both(xs + w_dst, &w_map, full, kt * BK, w_row);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
      // stay until both CTAs' consumers have released every stage, so no
      // remote arrival reaches a CTA that has exited
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumers: rows [64 wg, 64 wg + 64) of each tile -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = (int)threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    uint8_t* ys = ystage + wg * (BN * 128);
    // column sums: thread (hh, p) adds rows [hh * RPT, +RPT) of columns 2p, 2p + 1
    constexpr int RPT = 64 / SPLIT;
    const int p = tid % PAIRS, hh = tid / PAIRS, pc = 2 * p;
    const uint32_t pc_base = (pc >> 6) * SUB + (pc & 7) * 2, pc_chunk = (pc & 63) >> 3;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    // the stage goes back to both producers
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty0 + 8 * s);
        mbar_arrive_cluster(empty0 + 8 * s, rank ^ 1);
      }
    };
    for (int mt0 = first; mt0 < m_tiles; mt0 += rows) {
      const int mt = mt0 + rank;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t xs = smem_u32(ring + stage * Cfg::STAGE_BYTES) + wg * (64 * 128);
        const uint64_t db = smem_desc(smem_u32(ring + stage * Cfg::STAGE_BYTES) + Cfg::X_BYTES);
        if constexpr (AFFINE) {
          uint32_t a[4][4];
          const int row = warp * 16 + (lane & 15);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t chunk = 2 * s + (lane >> 4);
            ldmatrix_x4(a[s], xs + row * 128 + ((chunk ^ (row & 7)) << 4));
            // a[s][0], a[s][1]: k, k + 1; a[s][2], a[s][3]: k + 8, k + 9
            const int k = kt * BK + 16 * s + 2 * (lane & 3);
            float alo[2] = {0.f, 0.f}, blo[2] = {0.f, 0.f}, ahi[2] = {0.f, 0.f},
                  bhi[2] = {0.f, 0.f};
            if (k < K) {   // K is even: k + 1 < K too
              alo[0] = __ldg(A + k), alo[1] = __ldg(A + k + 1);
              blo[0] = __ldg(B + k), blo[1] = __ldg(B + k + 1);
            }
            if (k + 8 < K) {
              ahi[0] = __ldg(A + k + 8), ahi[1] = __ldg(A + k + 9);
              bhi[0] = __ldg(B + k + 8), bhi[1] = __ldg(B + k + 9);
            }
            a[s][0] = affine2(a[s][0], alo, blo);
            a[s][1] = affine2(a[s][1], alo, blo);
            a[s][2] = affine2(a[s][2], ahi, bhi);
            a[s][3] = affine2(a[s][3], ahi, bhi);
          }
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) Mma<BN>::rs(acc, a[s], db + 2 * s, kt > 0 || s > 0);
          wgmma_commit();
          // the A registers are read until the group completes
          wgmma_wait<0>();
          fence_regs(acc);
          release(stage);
        } else {
          const uint64_t da = smem_desc(xs);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) Mma<BN>::ss(acc, da + 2 * s, db + 2 * s, kt > 0 || s > 0);
          wgmma_commit();
          fence_regs(acc);
          if (kt > 0) {   // the previous stage's products are done: release it
            wgmma_wait<1>();
            fence_regs(acc);
            release(prev);
          }
          prev = stage;
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      if constexpr (!AFFINE) {
        wgmma_wait<0>();
        fence_regs(acc);
        release(prev);
      }

      // ---- epilogue: y rounded into the stage, stored by TMA, summed ----------
      const int m_wg = mt * BM + wg * 64;
      if (tid == 0) bulk_wait_read();   // the last tile's y has left the stage
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + (lane >> 2) + 8 * h;
          const uint32_t off =
              (j >> 3) * SUB + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3);
          *reinterpret_cast<__nv_bfloat162*>(ys + off) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (tid == 0 && m_wg < M) {
        for (int q = 0; q < BN / 64 && n0 + 64 * q < N; ++q)
          tma_store(&y_map, smem_u32(ys + q * SUB), n0 + 64 * q, m_wg);
        bulk_commit();
      }
      // this tile's rows in order, then into the running sums (two levels
      // keep a sum over many tiles as exact as one over few)
      float t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
      const int r_end = min(M - m_wg, (hh + 1) * RPT);
      for (int r = hh * RPT; r < r_end; ++r) {
        const uint32_t bits = *reinterpret_cast<const uint32_t*>(
            ys + pc_base + r * 128 + ((pc_chunk ^ (r & 7)) << 4));
        const float v0 = __uint_as_float(bits << 16), v1 = __uint_as_float(bits & 0xffff0000u);
        t1[0] = __fadd_rn(t1[0], v0);
        t2[0] = __fadd_rn(t2[0], __fmul_rn(v0, v0));
        t1[1] = __fadd_rn(t1[1], v1);
        t2[1] = __fadd_rn(t2[1], __fmul_rn(v1, v1));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) s1[e] = __fadd_rn(s1[e], t1[e]), s2[e] = __fadd_rn(s2[e], t2[e]);
    }
    if (tid == 0) bulk_wait();

    // the 2 * SPLIT parts of each column, added in order into partial[group]
    float* part = red + (wg * SPLIT + hh) * 2 * BN;
    part[pc] = s1[0], part[pc + 1] = s1[1];
    part[BN + pc] = s2[0], part[BN + pc + 1] = s2[1];
    named_sync(3, 256);
    if (wg == 0 && hh == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = pc + e;
        float t1 = red[c], t2 = red[BN + c];
#pragma unroll
        for (int i = 1; i < 2 * SPLIT; ++i) {
          t1 = __fadd_rn(t1, red[i * 2 * BN + c]);
          t2 = __fadd_rn(t2, red[i * 2 * BN + BN + c]);
        }
        if (n0 + c < N) {
          float* dst = partial + (size_t)group * 2 * N + n0 + c;
          dst[0] = t1;
          dst[N] = t2;
        }
      }
    }
  }
}

// out[i] = sum over the row groups g of partial[g * count + i], in a fixed
// order: warp w of a block adds groups w, w + 8, ... for 32 consecutive i,
// then warp 0 adds the eight warps' sums in turn
constexpr int SUM_WARPS = 8;
__global__ void __launch_bounds__(32 * SUM_WARPS)
conv1x1_sum_partials_kernel(const float* __restrict__ partial, int groups, int count,
                            float* __restrict__ out) {
  __shared__ float part[SUM_WARPS][32];
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int i = (int)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < count)
    for (int g = warp; g < groups; g += SUM_WARPS) s = __fadd_rn(s, partial[(size_t)g * count + i]);
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < count) {
#pragma unroll
    for (int w = 1; w < SUM_WARPS; ++w) s = __fadd_rn(s, part[w][lane]);
    out[i] = s;
  }
}

// ---- host ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) bf16 matrix read or written in boxes of
// box_rows x box_cols (box_cols * 2 = 128 bytes, the swizzle's width)
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int tile_cols(int N) { return N <= 128 ? 128 : 256; }

// a launch of the kernel in clusters of two CTAs
template <int BN>
cudaLaunchConfig_t cluster_config(int ctas, cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2, attr->val.clusterDim.y = 1, attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas), cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Config<BN>::SMEM, cfg.stream = s;
  cfg.attrs = attr, cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of the kernel the current device holds at once (the
// SMs of a GPC pair up); 0 if it cannot be read
template <int BN>
int max_clusters() {
  static int known[64] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (known[dev] > 0) return known[dev];
  const auto kernel = conv1x1_stats_kernel<BN, false>;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BN>(2, nullptr, &attr);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Config<BN>::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n <= 0)
    return 0;
  return known[dev] = n;
}

// CTAs per column tile (rows of the partial sums, an even number) on the
// current device; 0 if it cannot be read
int row_groups(int M, int N) {
  const int clusters = tile_cols(N) == 128 ? max_clusters<128>() : max_clusters<256>();
  if (clusters == 0) return 0;
  const int n_tiles = (N + tile_cols(N) - 1) / tile_cols(N), m_tiles = (M + BM - 1) / BM;
  return 2 * std::max(1, std::min((m_tiles + 1) / 2, clusters / n_tiles));
}

template <int BN, bool AFFINE>
int launch(const void* x, const void* w, const void* A, const void* B, int M, int N, int K,
           void* y, void* partial, void* out, cudaStream_t s) {
  const int rows = row_groups(M, N);
  if (rows == 0) return (int)cudaErrorNoDevice;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap x_map, w_map, y_map;
  if (!make_map(&x_map, x, M, K, BM) || !make_map(&w_map, w, N, K, BN / 2) ||
      !make_map(&y_map, y, M, N, 64))
    return (int)cudaErrorInvalidValue;
  const auto kernel = conv1x1_stats_kernel<BN, AFFINE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Config<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BN>((N + BN - 1) / BN * rows, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, y_map, static_cast<const float*>(A),
                           static_cast<const float*>(B), M, N, K, static_cast<float*>(partial));
  if (err != cudaSuccess) return (int)err;
  conv1x1_sum_partials_kernel<<<(2 * N + 31) / 32, 32 * SUM_WARPS, 0, s>>>(
      static_cast<const float*>(partial), rows, 2 * N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <bool AFFINE>
int launch_any(const void* x, const void* w, const void* A, const void* B, int M, int N, int K,
               void* y, void* partial, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || (AFFINE && (A == nullptr || B == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_cols(N) == 128 ? launch<128, AFFINE>(x, w, A, B, M, N, K, y, partial, out, s)
                             : launch<256, AFFINE>(x, w, A, B, M, N, K, y, partial, out, s);
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). x is a device
// pointer to a row-major (M, K) bf16 plane, w to a row-major (N, K) bf16
// weight, y to the row-major (M, N) bf16 output; K and N are multiples of 8
// and the pointers 16-byte aligned. out is (2, N) float32: [s1; s2].
// partial holds conv1x1_partial_floats(M, N) floats on the current device.

// The float32 scratch the kernels need for (M, N) on the current device,
// or -1 if the device cannot be read.
int conv1x1_partial_floats(int M, int N) {
  if (M <= 0 || N <= 0) return -1;
  const int rows = row_groups(M, N);
  return rows == 0 ? -1 : rows * 2 * N;
}

// Replaces conv1x1_stats (conv1x1.py:128, _matmul_stats_kernel :26-31 with
// _stats_epilogue :49-73, called through _stats_call :102).
int conv1x1_stats(const void* x, const void* w, int M, int N, int K, void* y, void* partial,
                  void* out, void* stream) {
  return launch_any<false>(x, w, nullptr, nullptr, M, N, K, y, partial, out, stream);
}

// Replaces conv1x1_bn_relu_stats (conv1x1.py:133, _affine_matmul_stats_kernel
// :34-46): A and B are contiguous float32 (K,) vectors.
int conv1x1_bn_relu_stats(const void* x, const void* w, const void* A, const void* B, int M,
                          int N, int K, void* y, void* partial, void* out, void* stream) {
  return launch_any<true>(x, w, A, B, M, N, K, y, partial, out, stream);
}

const char* conv1x1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
