// 1x1 convolution as a matrix product with a BatchNorm-statistics epilogue,
// for Hopper (sm_90a): bf16 on the tensor cores (TMA + wgmma), and float32
// on the CUDA cores (the section "float32" below).
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

#include <algorithm>

#include "hopper.cuh"

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

// ---- float32 ---------------------------------------------------------------
//
// The float32 instantiations (y and the sums in float32, as the reference
// keeps y in x's dtype): the products on the CUDA cores in float32, not
// TF32, which the port keeps off. Bound by operations at 67 TFLOP/s, so a
// plain tiled GEMM: a CTA of 256 threads computes a 128 x 128 tile, each
// thread 8 x 8 outputs (rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j
// and 64 + 4 tx + j), over K in slices of 8 through two shared-memory
// buffers, the next slice held in registers while the current one is
// multiplied. Every output adds its k in order with one fmaf each, and the
// affine is __fmul_rn then __fadd_rn then fmaxf, as the bf16 kernel does it.
// The epilogue stores y and adds the tile's rows of y and y^2 per column in
// a fixed order (a thread's 8 rows, then the 16 row groups of the tile) into
// row `row tile` of the partial sums, which conv1x1_sum_partials_kernel adds
// up: the same inputs give the same bits.

constexpr int F_TILE = 128, F_BK = 8, F_THREADS = 256;

template <bool AFFINE>
__global__ void __launch_bounds__(F_THREADS)
conv1x1_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ A, const float* __restrict__ B, int M, int N,
                         int K, float* __restrict__ y, float* __restrict__ partial) {
  // the x and w slices of both buffers, k-major; then the column sums' parts
  __shared__ __align__(16) float smem[2 * 2 * F_BK * F_TILE];
  float* xs = smem;                       // [buffer][k][row]
  float* ws = smem + 2 * F_BK * F_TILE;   // [buffer][k][column]
  const int tid = (int)threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = (int)blockIdx.x * F_TILE, n0 = (int)blockIdx.y * F_TILE;
  // thread t loads k .. k + 3 of row t / 2 of both tiles (K is a multiple of 8)
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool x_ok = m0 + lr < M, w_ok = n0 + lr < N;
  const float* xp = x + (size_t)(x_ok ? m0 + lr : 0) * K + lk;
  const float* wp = w + (size_t)(w_ok ? n0 + lr : 0) * K + lk;
  float xv[4], wv[4];
  auto fetch = [&](int k0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = x_ok ? *reinterpret_cast<const float4*>(xp + k0) : zero;
    const float4 b = w_ok ? *reinterpret_cast<const float4*>(wp + k0) : zero;
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
    wv[0] = b.x, wv[1] = b.y, wv[2] = b.z, wv[3] = b.w;
    if constexpr (AFFINE) {   // rows past M hold relu(B): never stored or summed
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + lk + i;
        xv[i] = fmaxf(__fadd_rn(__fmul_rn(xv[i], __ldg(A + k)), __ldg(B + k)), 0.f);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[(buf * F_BK + lk + i) * F_TILE + lr] = xv[i];
      ws[(buf * F_BK + lk + i) * F_TILE + lr] = wv[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  stash(0);
  __syncthreads();
  const int k_steps = K / F_BK;
  for (int ks = 0; ks < k_steps; ++ks) {
    const int cur = ks & 1;
    if (ks + 1 < k_steps) fetch((ks + 1) * F_BK);
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float* xr = xs + (cur * F_BK + k) * F_TILE;
      const float* wr = ws + (cur * F_BK + k) * F_TILE;
      const float4 a0 = *reinterpret_cast<const float4*>(xr + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(wr + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(wr + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (ks + 1 < k_steps) stash(cur ^ 1);
    __syncthreads();
  }

  // y, and this thread's rows of y and y^2 per column, rows in order
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = 0.f, s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;   // N is a multiple of 8: all four or none
      if (n < N)
        *reinterpret_cast<float4*>(y + (size_t)m * N + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] = __fadd_rn(s1[j], acc[i][j]);
      s2[j] = __fadd_rn(s2[j], __fmul_rn(acc[i][j], acc[i][j]));
    }
  }
  // the 16 row groups' parts of each column, added in order (the last
  // barrier of the K loop freed the buffers)
  float* red = smem;   // [ty][s1 of the 128 columns, s2 of the 128 columns]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
    red[ty * 2 * F_TILE + c] = s1[j];
    red[ty * 2 * F_TILE + F_TILE + c] = s2[j];
  }
  __syncthreads();
  const int c = tid % F_TILE, n = n0 + c;
  if (n < N) {
    float t = red[tid];
#pragma unroll
    for (int g = 1; g < 16; ++g) t = __fadd_rn(t, red[g * 2 * F_TILE + tid]);
    partial[(size_t)blockIdx.x * 2 * N + (tid < F_TILE ? n : N + n)] = t;
  }
}

// ---- host ------------------------------------------------------------------

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

// how many clusters of the kernel the current device holds at once; 0 if
// it cannot be read
template <int BN>
int clusters_of() {
  static int known[64] = {};
  return max_clusters(conv1x1_stats_kernel<BN, false>, THREADS, Config<BN>::SMEM, known);
}

// CTAs per column tile (rows of the partial sums, an even number) on the
// current device; 0 if it cannot be read
int row_groups(int M, int N) {
  const int clusters = tile_cols(N) == 128 ? clusters_of<128>() : clusters_of<256>();
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
  const cudaLaunchConfig_t cfg =
      cluster_config((N + BN - 1) / BN * rows, THREADS, Config<BN>::SMEM, s, &attr);
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

template <bool AFFINE>
int launch_f32(const void* x, const void* w, const void* A, const void* B, int M, int N, int K,
               void* y, void* partial, void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || (AFFINE && (A == nullptr || B == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + F_TILE - 1) / F_TILE;
  conv1x1_stats_f32_kernel<AFFINE><<<dim3(m_tiles, (N + F_TILE - 1) / F_TILE), F_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(A),
      static_cast<const float*>(B), M, N, K, static_cast<float*>(y), static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv1x1_sum_partials_kernel<<<(2 * N + 31) / 32, 32 * SUM_WARPS, 0, s>>>(
      static_cast<const float*>(partial), m_tiles, 2 * N, static_cast<float*>(out));
  return (int)cudaGetLastError();
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

// The float32 instantiations of the two (x, w and y float32; the same
// partial sums, conv1x1_partial_floats_f32(M, N) floats of them).
int conv1x1_partial_floats_f32(int M, int N) {
  if (M <= 0 || N <= 0) return -1;
  return (M + F_TILE - 1) / F_TILE * 2 * N;
}

int conv1x1_stats_f32(const void* x, const void* w, int M, int N, int K, void* y, void* partial,
                      void* out, void* stream) {
  return launch_f32<false>(x, w, nullptr, nullptr, M, N, K, y, partial, out, stream);
}

int conv1x1_bn_relu_stats_f32(const void* x, const void* w, const void* A, const void* B, int M,
                              int N, int K, void* y, void* partial, void* out, void* stream) {
  return launch_f32<true>(x, w, A, B, M, N, K, y, partial, out, stream);
}

const char* conv1x1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
