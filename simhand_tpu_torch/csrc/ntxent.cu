// NT-Xent denominator and gradient kernels for Hopper (sm_90a), float32.
//
// Replaces the four Pallas TPU kernels of simhand_tpu/losses/pallas_ntxent.py:
//   ntxent_denominator           <- ntxent_denominator / _ntxent_denom_kernel
//   weighted_ntxent_denominator  <- weighted_ntxent_denominator / _weighted_denom_kernel
//   ntxent_grad                  <- _ntxent_grad / _ntxent_grad_kernel
//   weighted_grad_rows           <- _weighted_grad_rows / _weighted_grad_kernel
//
// What they compute, for rows i of z_rows (M, 128) against columns j of
// z_cols (N, 128), with the self pair (j == row_ids[i]) masked out:
//   plain denominator     neg_i = sum_j exp(c_ij / T),           c_ij = z_i . z_j
//   weighted denominator  neg_i = sum_j exp(c_ij * w_ij / T)
//   plain gradient        G_i   = sum_j exp(c_ij / T) (inv_i + inv_j) z_j
//   weighted gradient     G_i   = sum_j exp(c_ij w_ij / T) w_ij (inv_i + inv_j) z_j
// with d_ij = (sum_k |joint_i^k - joint_j^k|) * (1/21) over 21 2-D joints
// and w_ij = (d_max - d_ij) / (d_max - d_min); d_max and d_min are read
// from device memory, so the caller never synchronises for them.
//
// All four are designed for Hopper (plain_denom_kernel<DBN>,
// weighted_denom_kernel, plain_grad_kernel, weighted_grad_kernel). Their
// products, c = z_r z_c^T and for the gradients G += P z_c, run on the
// tensor cores (wgmma) in three TF32 passes: each operand is split as a =
// hi + lo with hi = tf32(a) and lo = tf32(a - hi), both rounded to nearest
// (ties away), and the float32 sums take lo*hi, hi*lo, then hi*hi. That
// keeps a product to about 2^-22 of |a||b| (one TF32 pass: 2^-11, which
// breaks the gradients' 1e-5 * max|G| limit and the denominators' rel 1e-5
// where the rows' rounding does not average out), at a third of the 495
// TFLOP/s TF32 rate. Arithmetic otherwise follows the Pallas kernels:
// float32 throughout, the distance sum before the *(1/21), the self mask by
// global id; ragged edges are masked. The Pallas grid walked its column
// axis in order and carried the row sums in VMEM scratch; here a CTA walks
// its column tiles itself and keeps its rows' sums in registers.
// - #1 and #3 have no distances: their tensor-core warpgroup's chain a tile
//   bounds them (see #3's note). #1 is #2 without the joints, the distances
//   and the w plane: the product in three chains of wgmma, one a TF32 pass
//   (as #3's), then exp(c * (1 / T)) and the rows' sums on the warpgroup's
//   accumulator, while the helpers split the next tile. Every operand of a
//   wgmma step comes from shared memory (64 x 8 of A, TN x 8 of B), so the
//   tile's width sets how much is read a product: DBN = 64 columns
//   (m64n64k8, 4 KB a step for 32,768 multiply-adds) where #2's 32 reads 3
//   KB for half as many. On an H100 (PERF.md, PR 11) the 64-column tile
//   takes 0.0529 and 1.509 ms at 512 x 16,384 and 16,384 x 16,384 against
//   the 32-column one's 0.0676 and 1.855, and is kept; the 32-column tile
//   is faster only at 512 x 512 (0.0064 against 0.0077 ms), where 64
//   columns fill 64 SMs instead of 128.
// - What is left on the CUDA cores bounds #2 and #4: the 21 joint distances
//   a pair (subtract, square, add, a square root, add), the weight, exp and
//   the self mask, about 230 instructions a pair against the products'
//   768 (#2) or 1,536 (#4) tensor-core flops.
// - The square root is sqrt.approx (one MUFU operation, within about an
//   ulp): __fsqrt_rn's slow-path branch kept a thread's pairs from
//   interleaving. The weights then differ from the plain version's in their
//   last bits, well inside the limits at every shape.
// - The tensor cores' float32 sums truncate, so a long sum in one
//   accumulator drifts (1e-4 of max|G| over 16,384 columns): each tile's
//   P z_c starts from 0 there and is added to the row's G in registers by
//   round-to-nearest float32 adds; #2's row sums are kept the same way.
// - A CTA owns 64 rows and the column tiles of one split, 32 columns a
//   tile (#1: 64). Its rows' hi and lo planes stay in shared memory for the
//   whole walk, the A operand of the first product.
// - Twelve warps, 168 registers each (#1: 136; the register file; a
//   thirteenth warp would round the allocation up to sixteen and cut it to
//   128, with spills). Warps 0-3, the tensor-core warpgroup, run the
//   products and work on their accumulator: exp(c / T) and the rows' sums
//   (#1), exp(c w / T) and the rows' sums (#2), P =
//   exp(c / T) (inv_i + inv_j) (#3), P = exp(c w / T) w (inv_i + inv_j)
//   (#4), and G (#3, #4). Warps 4-11, the helpers, split z_c into its
//   operands and (#2, #4) compute the tile's distances and weights (8 pairs
//   a thread, the row's joints in registers) into a double-buffered w
//   plane. Thread 0 keeps three stages of raw column tiles (z_c rows, and
//   for #2-#4 their joints and/or 1/neg) arriving through 1-D bulk copies,
//   two tiles ahead; a copy's ragged tail of fewer than 16 bytes goes by
//   plain stores before the stage's barrier is posted (#1 copies whole
//   rows of 512 bytes: it has none). Stages, w buffers and operand
//   planes are handed over by mbarriers; no wgmma is left in flight across
//   a pass of the loop (one that is makes ptxas serialise them all).
// - The helpers split z_c into hi and lo as rows of 128 (K = the feature,
//   the first product's B operand) and, for the gradients, transposed, as
//   128 rows of 32 columns (K = the column, the second product's B
//   operand; TF32 wgmma takes shared-memory operands K-major only). #4's P
//   goes through shared memory as hi and lo (the A operand); #3 keeps it in
//   registers. Every shared operand is stored in the 128-byte swizzle that
//   wgmma's descriptors name.
// - #2 splits z_c before the tile's distances, so that its product runs
//   beside them, and forms w / T with one multiply by (1 / (d_max -
//   d_min)) (1 / T) where the plain version divides twice (a last-bit
//   change; two multiplies cost the register that made the helpers spill).
// - Shared memory: #4 rows 64 KB, the split column tile 64 KB, P 16 KB, w
//   16 KB, three 21.4 KB stages: 225 KB. #2 rows 64, the tile's row planes
//   32, w 16, three 21.25 KB stages: 177 KB. #3 rows 64, the tile 64, three
//   16.1 KB stages: 177 KB. #1 rows 64, the tile's row planes 64, three 32
//   KB stages: 225 KB. One CTA an SM.
// - Splits: when the row blocks are fewer than the SMs the columns are cut
//   into as many splits as fill them (the wrapper's _tensor_core_grid: 16
//   of 32 columns at 512 x 512 and of 1,024 at 512 x 16,384 for #2-#4, 8
//   of 64 and 16 of 1,024 for #1; none at 16,384 x 16,384); the partial
//   plane holds 16 and 32 KiB for #1, 32 KiB for #2 and 4 MiB for #3/#4
//   there. The splits' partials are added in their order by
//   sum_splits_kernel<K>, one instance a kernel: a second launch gives the
//   same bits.

#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int D = 128;           // projection width
constexpr int NJ = 21;           // joints
constexpr int JW = 2 * NJ;       // interleaved [x0, y0, x1, y1, ...]

// out[i] = sum over splits s, in order, of partial[s * count + i]; one
// instance for each kernel #K, so that a profile tells the sum passes apart
template <int K>
__global__ void sum_splits_kernel(const float* __restrict__ partial, int splits,
                                  int64_t count, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * count + i];
  out[i] = s;
}

// ---- #4 on Hopper: weighted_grad_kernel ------------------------------------

constexpr int GBM = 64;                    // rows of a CTA
constexpr int GBN = 32;                    // columns of a tile
constexpr int GSTAGES = 3;                 // raw column tiles in flight
constexpr int MMA_THREADS = 128;           // warps 0-3: the tensor-core warpgroup
constexpr int HELPERS = 256;               // warps 4-11: distances and the split
constexpr int GTHREADS = MMA_THREADS + HELPERS;   // 12 warps: 168 registers a thread
// shared memory, from a 1,024-byte aligned base: swizzled K-major planes
// (rows of 128 bytes, 32 TF32 values, in K-blocks of R rows)
constexpr int ZR_HI = 0, ZR_LO = 32768;          // z_r: 4 K-blocks x 64 rows
constexpr int ZC_HI = 65536, ZC_LO = 81920;      // z_c: 4 K-blocks x 32 rows
constexpr int ZT_HI = 98304, ZT_LO = 114688;     // z_c^T: 1 K-block x 128 rows
constexpr int P_HI = 131072, P_LO = 139264;      // P: 1 K-block x 64 rows
constexpr int WPLANE = 147456;                   // w, two buffers of 64 x 32 floats
constexpr int STAGE0 = WPLANE + 2 * GBM * GBN * 4;   // the ring of raw tiles
constexpr int ST_Z = 0, ST_J = GBN * D * 4, ST_I = ST_J + GBN * JW * 4;
constexpr int STAGE_BYTES = ST_I + GBN * 4;      // 21,888
constexpr int GBARS = STAGE0 + GSTAGES * STAGE_BYTES;
// full[3], empty[3], w_ready[2], w_free[2], planes_ready, planes_free
constexpr int NBARS = 2 * GSTAGES + 4 + 2;
constexpr int GSMEM = GBARS + 8 * NBARS + 1024;  // and the base's alignment
static_assert(STAGE0 % 16 == 0 && STAGE_BYTES % 16 == 0, "bulk copies land 16-byte aligned");
static_assert(GSMEM <= 232448, "one CTA an SM");

// round to TF32 (10 explicit mantissa bits), to nearest, ties away from 0
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, hi));
}
__device__ __forceinline__ void split4(const float4& a, float4& hi, float4& lo) {
  split(a.x, hi.x, lo.x), split(a.y, hi.y, lo.y), split(a.z, hi.z, lo.z), split(a.w, hi.w, lo.w);
}

// byte offset of 16-byte chunk ch (4 K values) of row r in a K-major plane of
// R-row K-blocks, 128-byte swizzle
__device__ __forceinline__ int swz(int r, int ch, int R) {
  return (ch >> 3) * R * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

#define D16 D8(0), D8(8)
#define REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= a b, 64 x 8 of A against 32 x 8 of B (TF32, K-major, shared memory)
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
      ", %16, %17, p, 1, 1;\n}\n"
      : D16
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (+)= a b, 64 x 8 of A against 64 x 8 of B
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : D32
      : "l"(a), "l"(b), "r"(scale_d));
}

// one MUFU operation, no branch (__fsqrt_rn's slow-path test keeps a
// thread's pairs from interleaving); within about an ulp, and exact at 0
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One CTA: rows [blockIdx.x * GBM, +GBM) against the columns [blockIdx.y *
// cols_per_split, +cols_per_split) of N; dst is (splits, M, D).
__global__ void __launch_bounds__(GTHREADS, 1)
weighted_grad_kernel(const float* __restrict__ z_rows, const float* __restrict__ z_cols,
                     const float* __restrict__ j_rows, const float* __restrict__ j_cols,
                     const float* __restrict__ inv_rows, const float* __restrict__ inv_cols,
                     const int* __restrict__ row_ids, const float* __restrict__ minmax, int M,
                     int N, float temperature, int cols_per_split, float* __restrict__ dst) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + GBARS, empty0 = full0 + 8 * GSTAGES;
  const uint32_t wready0 = empty0 + 8 * GSTAGES, wfree0 = wready0 + 16;
  const uint32_t pready = wfree0 + 16, pfree = pready + 8;
  const int row0 = (int)blockIdx.x * GBM;
  const int col_begin = (int)blockIdx.y * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const int tiles = (col_end - col_begin + GBN - 1) / GBN;
  const int tid = (int)threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, GTHREADS / 32);    // every warp reads a stage
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(wready0 + 8 * b, HELPERS / 32);
      mbar_init(wfree0 + 8 * b, MMA_THREADS / 32);
    }
    mbar_init(pready, HELPERS / 32);
    mbar_init(pfree, MMA_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies tile k into its stage: z_c rows, their joints and 1/neg;
  // ragged tails (< 16 bytes) by plain stores, posted with the barrier
  const auto load_tile = [&](int k) {
    const int s = k % GSTAGES;
    if (k >= GSTAGES) mbar_wait(empty0 + 8 * s, (k / GSTAGES - 1) & 1);
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    uint8_t* st = sm + STAGE0 + s * STAGE_BYTES;
    const uint32_t jbytes = n * JW * 4, ibytes = n * 4;
    const uint32_t jbulk = jbytes & ~15u, ibulk = ibytes & ~15u;
    for (uint32_t w = jbulk / 4; w < jbytes / 4; ++w)
      reinterpret_cast<float*>(st + ST_J)[w] = j_cols[(size_t)c0 * JW + w];
    for (uint32_t w = ibulk / 4; w < ibytes / 4; ++w)
      reinterpret_cast<float*>(st + ST_I)[w] = inv_cols[c0 + w];
    const uint32_t bar = full0 + 8 * s, dst0 = base + STAGE0 + s * STAGE_BYTES;
    mbar_expect_tx(bar, (uint32_t)n * D * 4 + jbulk + ibulk);
    bulk_load(dst0 + ST_Z, z_cols + (size_t)c0 * D, n * D * 4, bar);
    if (jbulk) bulk_load(dst0 + ST_J, j_cols + (size_t)c0 * JW, jbulk, bar);
    if (ibulk) bulk_load(dst0 + ST_I, inv_cols + c0, ibulk, bar);
  };
  if (tid == 0)
    for (int k = 0; k < min(tiles, GSTAGES - 1); ++k) load_tile(k);

  // the rows' hi and lo planes of z_r, shared by every consumer
  for (int i = tid; i < GBM * (D / 4); i += GTHREADS) {
    const int r = i / (D / 4), ch = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < M) v = reinterpret_cast<const float4*>(z_rows + (size_t)(row0 + r) * D)[ch];
    float4 hi, lo;
    split4(v, hi, lo);
    *reinterpret_cast<float4*>(sm + ZR_HI + swz(r, ch, GBM)) = hi;
    *reinterpret_cast<float4*>(sm + ZR_LO + swz(r, ch, GBM)) = lo;
  }
  fence_async_smem();
  named_sync(1, GTHREADS);

  if (tid >= MMA_THREADS) {
    // ---- the helpers: row r, columns cg + 4c (c < 8) of every tile ----
    const int h = tid - MMA_THREADS, r = h / 4, cg = h % 4;
    float rj[JW];                                    // the row's joints
#pragma unroll
    for (int q = 0; q < JW; ++q) rj[q] = row0 + r < M ? j_rows[(size_t)(row0 + r) * JW + q] : 0.f;
    const float d_max = minmax[0], d_range = __fsub_rn(d_max, minmax[1]);
    // where w of (r, col) goes: the slot of the MMA thread that holds the
    // pair in its accumulator, pair index i, as w[i * 128 + thread]
    const int wslot = (r / 16) * 32 + (r % 8) * 4, wi = 2 * ((r % 16) / 8);
    for (int k = 0; k < tiles; ++k) {
      const int s = k % GSTAGES, b = k & 1;
      const uint8_t* st = sm + STAGE0 + s * STAGE_BYTES;
      const float* jc = reinterpret_cast<const float*>(st + ST_J);
      mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);
      float dist[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) dist[c] = 0.f;
#pragma unroll
      for (int q = 0; q < NJ; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 cj = *reinterpret_cast<const float2*>(jc + (cg + 4 * c) * JW + 2 * q);
          const float dx = __fsub_rn(rj[2 * q], cj.x), dy = __fsub_rn(rj[2 * q + 1], cj.y);
          dist[c] = __fadd_rn(dist[c], sqrt_approx(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))));
        }
      if (k >= 2) mbar_wait(wfree0 + 8 * b, (k / 2 - 1) & 1);
      float* w = reinterpret_cast<float*>(sm + WPLANE + b * GBM * GBN * 4);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = cg + 4 * c;
        const int i = 4 * (col / 8) + wi + col % 2, slot = wslot + (col % 8) / 2;
        w[i * MMA_THREADS + slot] =
            __fdiv_rn(__fsub_rn(d_max, __fmul_rn(dist[c], 1.0f / 21.0f)), d_range);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(wready0 + 8 * b);

      // z_c split into hi and lo, as rows (K = feature) and transposed (K =
      // column), once the last tile's products are done; columns past the
      // tile's end are zero
      const int n = min(GBN, col_end - (col_begin + k * GBN));
      if (k >= 1) mbar_wait(pfree, (k - 1) & 1);
      {
        const int jb = h / (D / 4), db = h % (D / 4);
        float4 hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * jb + e;
          const float4 v = j < n ? *reinterpret_cast<const float4*>(st + ST_Z + j * D * 4 + db * 16)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          split4(v, hi[e], lo[e]);
          *reinterpret_cast<float4*>(sm + ZC_HI + swz(j, db, GBN)) = hi[e];
          *reinterpret_cast<float4*>(sm + ZC_LO + swz(j, db, GBN)) = lo[e];
        }
        const float4 th[4] = {make_float4(hi[0].x, hi[1].x, hi[2].x, hi[3].x),
                              make_float4(hi[0].y, hi[1].y, hi[2].y, hi[3].y),
                              make_float4(hi[0].z, hi[1].z, hi[2].z, hi[3].z),
                              make_float4(hi[0].w, hi[1].w, hi[2].w, hi[3].w)};
        const float4 tl[4] = {make_float4(lo[0].x, lo[1].x, lo[2].x, lo[3].x),
                              make_float4(lo[0].y, lo[1].y, lo[2].y, lo[3].y),
                              make_float4(lo[0].z, lo[1].z, lo[2].z, lo[3].z),
                              make_float4(lo[0].w, lo[1].w, lo[2].w, lo[3].w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          *reinterpret_cast<float4*>(sm + ZT_HI + swz(4 * db + e, jb, D)) = th[e];
          *reinterpret_cast<float4*>(sm + ZT_LO + swz(4 * db + e, jb, D)) = tl[e];
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(pready);
        mbar_arrive(empty0 + 8 * s);                 // the raw tile is consumed here
      }
    }
    return;
  }

  // ---- the tensor-core warpgroup: rows ra, rb; columns 8q + 2t + e ----
  const int warp = tid / 32, gq = lane / 4, t = lane % 4;
  const int ra = 16 * warp + gq, rb = ra + 8;
  int rid[2];
  float inv_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    rid[hh] = r < M ? row_ids[r] : -1;      // global ids are >= 0
    inv_r[hh] = r < M ? inv_rows[r] : 0.f;
  }
  // G: each tile's P z_c on the tensor cores from 0 (their float32 sums
  // truncate, so a long sum there drifts), added here by round-to-nearest
  // float32 adds, tile after tile; every wgmma group is waited for inside
  // its pass of the loop (one in flight across the back edge makes ptxas
  // serialise them)
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % GSTAGES, b = k & 1;
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    const float* ic = reinterpret_cast<const float*>(sm + STAGE0 + s * STAGE_BYTES + ST_I);
    // two tiles ahead, into the stage tile k - 1 has left
    if (tid == 0 && k + GSTAGES - 1 < tiles) load_tile(k + GSTAGES - 1);
    __syncwarp();                 // warp 0 whole again before the .aligned wgmma

    // c = z_r z_c^T: lo*hi, hi*lo, then hi*hi, 16 K-steps each
    mbar_wait(pready, k & 1);
    float cov[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) cov[i] = 0.f;
    fence_regs(cov);
    wgmma_fence();
    {
      const uint32_t as[3] = {ZR_LO, ZR_HI, ZR_HI}, bs[3] = {ZC_HI, ZC_LO, ZC_HI};
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          const uint32_t ka = (ks / 4) * GBM * 128 + (ks % 4) * 32;
          const uint32_t kb = (ks / 4) * GBN * 128 + (ks % 4) * 32;
          mma_n32(cov, smem_desc(base + as[p] + ka), smem_desc(base + bs[p] + kb), p + ks > 0);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cov);

    // P = exp(c w / T) w (inv_i + inv_j), 0 on the self pair and past the end
    mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);    // 1/neg of the columns
    mbar_wait(wready0 + 8 * b, (k / 2) & 1);
    const float* w = reinterpret_cast<const float*>(sm + WPLANE + b * GBM * GBN * 4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * q + 2 * hh + e, j = 8 * q + 2 * t + e;
          const float wv = w[i * MMA_THREADS + tid];
          const float ex = expf(__fdiv_rn(__fmul_rn(cov[i], wv), temperature));
          const float pv = __fmul_rn(__fmul_rn(ex, wv), __fadd_rn(inv_r[hh], ic[j]));
          v[e] = (j < n && c0 + j != rid[hh] && rid[hh] >= 0) ? pv : 0.f;
        }
        const int r = hh ? rb : ra, ch = 2 * q + t / 2, off = (2 * t) % 4 * 4;
        float2 hi, lo;
        split(v[0], hi.x, lo.x);
        split(v[1], hi.y, lo.y);
        *reinterpret_cast<float2*>(sm + P_HI + swz(r, ch, GBM) + off) = hi;
        *reinterpret_cast<float2*>(sm + P_LO + swz(r, ch, GBM) + off) = lo;
      }
    fence_async_smem();
    named_sync(2, MMA_THREADS);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(wfree0 + 8 * b);
      mbar_arrive(empty0 + 8 * s);
    }

    // G += P z_c in two halves of 64 features: lo*hi, hi*lo, hi*hi, 4 K-steps each
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      fence_regs(part);
      wgmma_fence();
      const uint32_t as[3] = {P_LO, P_HI, P_HI}, bs[3] = {ZT_HI, ZT_LO, ZT_HI};
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int ks = 0; ks < GBN / 8; ++ks)
          mma_n64(part, smem_desc(base + as[p] + ks * 32),
                  smem_desc(base + bs[p] + half * 64 * 128 + ks * 32), p + ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * half + i] = __fadd_rn(acc[32 * half + i], part[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(pfree);                // the planes may be overwritten
  }

  float* out = dst + (size_t)blockIdx.y * M * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    if (r < M) {
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * q + 2 * t) =
            make_float2(acc[4 * q + 2 * hh], acc[4 * q + 2 * hh + 1]);
    }
  }
}

// the rows' hi and lo planes of z_r, split by all GTHREADS threads
__device__ __forceinline__ void split_rows(uint8_t* sm, const float* __restrict__ z_rows, int row0,
                                           int M) {
  for (int i = (int)threadIdx.x; i < GBM * (D / 4); i += GTHREADS) {
    const int r = i / (D / 4), ch = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < M) v = reinterpret_cast<const float4*>(z_rows + (size_t)(row0 + r) * D)[ch];
    float4 hi, lo;
    split4(v, hi, lo);
    *reinterpret_cast<float4*>(sm + ZR_HI + swz(r, ch, GBM)) = hi;
    *reinterpret_cast<float4*>(sm + ZR_LO + swz(r, ch, GBM)) = lo;
  }
}

// rows j[e] (e < 4) of a raw z_c tile of n rows, 16-byte chunk db of each
// (4 features), split into hi and lo; rows past n are zero
__device__ __forceinline__ void split_col_chunks(const uint8_t* st, const int (&j)[4], int db,
                                                 int n, float4 (&hi)[4], float4 (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 v = j[e] < n ? *reinterpret_cast<const float4*>(st + j[e] * D * 4 + db * 16)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    split4(v, hi[e], lo[e]);
  }
}

// d (+)= a b, 64 x 8 of A from registers against 64 x 8 of B: a0..a3 are
// the warp's (row lane / 4, K lane % 4), (row + 8, K), (row, K + 4),
// (row + 8, K + 4) of its 16 rows
__device__ __forceinline__ void mma_n64_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// c = z_r z_c^T for the warpgroup's 64 rows against the tile's 32 columns:
// lo*hi, hi*lo, then hi*hi, 16 K-steps each, waited for before it returns.
// With CHAINS = 3 each pass sums into an accumulator of its own, three
// chains of wgmma that do not wait for each other, then (lo*hi + hi*lo) +
// hi*hi; that pays in #3, not in #2 (PERF.md).
template <int CHAINS>
__device__ __forceinline__ void product_rows_cols(float (&cov)[16], uint32_t base) {
  [[maybe_unused]] float a[CHAINS == 3 ? 16 : 1], b[CHAINS == 3 ? 16 : 1];
#pragma unroll
  for (int i = 0; i < 16; ++i) cov[i] = 0.f;
  fence_regs(cov);
  if constexpr (CHAINS == 3) {
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = b[i] = 0.f;
    fence_regs(a);
    fence_regs(b);
  }
  wgmma_fence();
  const uint32_t as[3] = {ZR_LO, ZR_HI, ZR_HI}, bs[3] = {ZC_HI, ZC_LO, ZC_HI};
  // one chain: the passes in turn; three: the K-steps in turn, each one's passes
#pragma unroll
  for (int step = 0; step < 3 * (D / 8); ++step) {
    const int p = CHAINS == 3 ? step % 3 : step / (D / 8);
    const int ks = CHAINS == 3 ? step / 3 : step % (D / 8);
    const uint32_t ka = (ks / 4) * GBM * 128 + (ks % 4) * 32;
    const uint32_t kb = (ks / 4) * GBN * 128 + (ks % 4) * 32;
    const uint64_t da = smem_desc(base + as[p] + ka), db = smem_desc(base + bs[p] + kb);
    if constexpr (CHAINS == 3) {
      if (p == 0)
        mma_n32(a, da, db, ks > 0);
      else if (p == 1)
        mma_n32(b, da, db, ks > 0);
      else
        mma_n32(cov, da, db, ks > 0);
    } else {
      mma_n32(cov, da, db, step > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(cov);
  if constexpr (CHAINS == 3) {
    fence_regs(a);
    fence_regs(b);
#pragma unroll
    for (int i = 0; i < 16; ++i) cov[i] = __fadd_rn(__fadd_rn(a[i], b[i]), cov[i]);
  }
}

// |a - b| of a pair of 2-D joints for #2: an FFMA in the square (a last-bit
// change against the plain version's two products), sqrt.approx
__device__ __forceinline__ float joint_distance(float ax, float ay, float bx, float by) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by);
  return sqrt_approx(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// ---- #2 on Hopper: weighted_denom_kernel -----------------------------------
//
// #4's design with one product: the rows' planes (ZR_HI, ZR_LO) and the
// tile's row planes (ZC_HI, ZC_LO) at #4's offsets, then the w / T plane
// and the ring of raw tiles (z_c rows and their joints; no 1/neg)
constexpr int DW_PLANE = 98304;                        // w / T, two buffers of 64 x 32 floats
constexpr int DSTAGE0 = DW_PLANE + 2 * GBM * GBN * 4;
constexpr int DSTAGE_BYTES = ST_J + GBN * JW * 4;      // 21,760
constexpr int DBARS = DSTAGE0 + GSTAGES * DSTAGE_BYTES;
// full[3], empty[3], w_ready[2], w_free[2], planes_ready, planes_free
constexpr int DSMEM = DBARS + 8 * NBARS + 1024;
static_assert(DSTAGE0 % 16 == 0 && DSTAGE_BYTES % 16 == 0, "bulk copies land 16-byte aligned");
static_assert(DSMEM <= 232448, "one CTA an SM");

// One CTA: rows [blockIdx.x * GBM, +GBM) against the columns [blockIdx.y *
// cols_per_split, +cols_per_split) of N; dst is (splits, M).
__global__ void __launch_bounds__(GTHREADS, 1)
weighted_denom_kernel(const float* __restrict__ z_rows, const float* __restrict__ z_cols,
                      const float* __restrict__ j_rows, const float* __restrict__ j_cols,
                      const int* __restrict__ row_ids, const float* __restrict__ minmax, int M,
                      int N, float temperature, int cols_per_split, float* __restrict__ dst) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + DBARS, empty0 = full0 + 8 * GSTAGES;
  const uint32_t wready0 = empty0 + 8 * GSTAGES, wfree0 = wready0 + 16;
  const uint32_t pready = wfree0 + 16, pfree = pready + 8;
  const int row0 = (int)blockIdx.x * GBM;
  const int col_begin = (int)blockIdx.y * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const int tiles = (col_end - col_begin + GBN - 1) / GBN;
  const int tid = (int)threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, HELPERS / 32);      // only the helpers read a stage
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(wready0 + 8 * b, HELPERS / 32);
      mbar_init(wfree0 + 8 * b, MMA_THREADS / 32);
    }
    mbar_init(pready, HELPERS / 32);
    mbar_init(pfree, MMA_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies tile k into its stage: z_c rows and their joints; a
  // ragged tail (< 16 bytes) by plain stores, posted with the barrier
  const auto load_tile = [&](int k) {
    const int s = k % GSTAGES;
    if (k >= GSTAGES) mbar_wait(empty0 + 8 * s, (k / GSTAGES - 1) & 1);
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    uint8_t* st = sm + DSTAGE0 + s * DSTAGE_BYTES;
    const uint32_t jbytes = n * JW * 4, jbulk = jbytes & ~15u;
    for (uint32_t w = jbulk / 4; w < jbytes / 4; ++w)
      reinterpret_cast<float*>(st + ST_J)[w] = j_cols[(size_t)c0 * JW + w];
    const uint32_t bar = full0 + 8 * s, dst0 = base + DSTAGE0 + s * DSTAGE_BYTES;
    mbar_expect_tx(bar, (uint32_t)n * D * 4 + jbulk);
    bulk_load(dst0 + ST_Z, z_cols + (size_t)c0 * D, n * D * 4, bar);
    if (jbulk) bulk_load(dst0 + ST_J, j_cols + (size_t)c0 * JW, jbulk, bar);
  };
  if (tid == 0)
    for (int k = 0; k < min(tiles, GSTAGES - 1); ++k) load_tile(k);
  split_rows(sm, z_rows, row0, M);
  fence_async_smem();
  named_sync(1, GTHREADS);

  if (tid >= MMA_THREADS) {
    // ---- the helpers: split the tile, then row r against columns cg + 4c ----
    const int h = tid - MMA_THREADS, r = h / 4, cg = h % 4;
    float rj[JW];                                    // the row's joints
#pragma unroll
    for (int q = 0; q < JW; ++q) rj[q] = row0 + r < M ? j_rows[(size_t)(row0 + r) * JW + q] : 0.f;
    // w / T = (d_max - d / 21) * scale, scale = (1 / (d_max - d_min)) (1 / T):
    // one multiply where the plain version divides twice (within a few ulp;
    // a register fewer than two multiplies, which spill at 168)
    const float d_max = minmax[0];
    const float scale = __fmul_rn(__frcp_rn(__fsub_rn(d_max, minmax[1])), __frcp_rn(temperature));
    const int wslot = (r / 16) * 32 + (r % 8) * 4, wi = 2 * ((r % 16) / 8);
    for (int k = 0; k < tiles; ++k) {
      const int s = k % GSTAGES, b = k & 1;
      const uint8_t* st = sm + DSTAGE0 + s * DSTAGE_BYTES;
      const float* jc = reinterpret_cast<const float*>(st + ST_J);
      const int n = min(GBN, col_end - (col_begin + k * GBN));
      mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);

      // z_c into hi and lo (K = feature) first, so that the tile's product
      // runs beside its distances; once the last tile's product is done
      {
        const int jb = h / (D / 4), db = h % (D / 4);
        const int j[4] = {4 * jb, 4 * jb + 1, 4 * jb + 2, 4 * jb + 3};
        float4 hi[4], lo[4];
        split_col_chunks(st + ST_Z, j, db, n, hi, lo);
        if (k >= 1) mbar_wait(pfree, (k - 1) & 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          *reinterpret_cast<float4*>(sm + ZC_HI + swz(4 * jb + e, db, GBN)) = hi[e];
          *reinterpret_cast<float4*>(sm + ZC_LO + swz(4 * jb + e, db, GBN)) = lo[e];
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(pready);

      float dist[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) dist[c] = 0.f;
#pragma unroll
      for (int q = 0; q < NJ; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 cj = *reinterpret_cast<const float2*>(jc + (cg + 4 * c) * JW + 2 * q);
          dist[c] = __fadd_rn(dist[c], joint_distance(rj[2 * q], rj[2 * q + 1], cj.x, cj.y));
        }
      if (k >= 2) mbar_wait(wfree0 + 8 * b, (k / 2 - 1) & 1);
      float* w = reinterpret_cast<float*>(sm + DW_PLANE + b * GBM * GBN * 4);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = cg + 4 * c;
        const int i = 4 * (col / 8) + wi + col % 2, slot = wslot + (col % 8) / 2;
        w[i * MMA_THREADS + slot] =
            __fmul_rn(__fsub_rn(d_max, __fmul_rn(dist[c], 1.0f / 21.0f)), scale);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(wready0 + 8 * b);
        mbar_arrive(empty0 + 8 * s);                 // the raw tile is consumed here
      }
    }
    return;
  }

  // ---- the tensor-core warpgroup: rows ra, rb; columns 8q + 2t + e ----
  const int warp = tid / 32, gq = lane / 4, t = lane % 4;
  const int ra = 16 * warp + gq, rb = ra + 8;
  int rid[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    rid[hh] = r < M ? row_ids[r] : -1;      // global ids are >= 0
  }
  // each row's sum in registers: a tile's eight terms, then round-to-nearest
  // adds tile after tile; the quad's four sums at the end
  float sum[2] = {0.f, 0.f};
  for (int k = 0; k < tiles; ++k) {
    const int b = k & 1;
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    // two tiles ahead, into the stage tile k - 1 has left
    if (tid == 0 && k + GSTAGES - 1 < tiles) load_tile(k + GSTAGES - 1);
    __syncwarp();                 // warp 0 whole again before the .aligned wgmma

    mbar_wait(pready, k & 1);
    float cov[16];
    product_rows_cols<1>(cov, base);
    __syncwarp();
    if (lane == 0) mbar_arrive(pfree);                // the planes may be overwritten

    // exp(c w / T), 0 on the self pair and past the end
    mbar_wait(wready0 + 8 * b, (k / 2) & 1);
    const float* w = reinterpret_cast<const float*>(sm + DW_PLANE + b * GBM * GBN * 4);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * q + 2 * hh + e, j = 8 * q + 2 * t + e;
          const float ex = expf(__fmul_rn(cov[i], w[i * MMA_THREADS + tid]));
          if (j < n && c0 + j != rid[hh] && rid[hh] >= 0) part[hh] = __fadd_rn(part[hh], ex);
        }
    __syncwarp();
    if (lane == 0) mbar_arrive(wfree0 + 8 * b);
    sum[0] = __fadd_rn(sum[0], part[0]);
    sum[1] = __fadd_rn(sum[1], part[1]);
  }

  // the four lanes of a row (t = 0..3) in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 1));
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 2));
  }
  if (t == 0) {
    float* out = dst + (size_t)blockIdx.y * M;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + (hh ? rb : ra);
      if (r < M) out[r] = sum[hh];
    }
  }
}

// ---- #3 on Hopper: plain_grad_kernel ---------------------------------------
//
// #4's design without the distances. What bounds #3 is its tensor-core
// warpgroup's chain a tile: c, P, then P z_c, each product's operands read
// from shared memory by the tensor cores (about 3 KB a 64 x 32 x 8 TF32
// product, against the SM's 128 bytes a cycle).
// - c runs in three chains of wgmma, one a TF32 pass, that do not wait for
//   each other (product_rows_cols<3>).
// - P stays in registers as the A operand of G += P z_c: the columns 2t
//   and 2t + 1 of each 8-column group that a thread holds in c's
//   accumulator are its fragment's K = t and t + 4, so the transposed
//   planes hold each 8-column group in the order 0, 2, 4, 6, 1, 3, 5, 7.
//   No P plane and no barrier for it, and the second product reads half
//   of what it read from shared memory.
// - The tile's row planes and its transposed planes have barriers of their
//   own, so the helpers split tile k + 1's rows while P z_c of tile k runs,
//   and its transpose while c of tile k + 1 runs.
// Shared memory: the planes of #4 at its offsets (rows, the tile's rows and
// its transpose), then the ring of raw tiles (z_c rows and their 1/neg).
constexpr int PSTAGE0 = P_HI;                          // no P plane, no w plane
constexpr int PST_I = GBN * D * 4;
constexpr int PSTAGE_BYTES = PST_I + GBN * 4;          // 16,512
constexpr int PBARS = PSTAGE0 + GSTAGES * PSTAGE_BYTES;
// full[3], empty[3], zc_ready, zc_free, zt_ready, zt_free
constexpr int PNBARS = 2 * GSTAGES + 4;
constexpr int PSMEM = PBARS + 8 * PNBARS + 1024;
static_assert(PSTAGE0 % 16 == 0 && PSTAGE_BYTES % 16 == 0, "bulk copies land 16-byte aligned");
static_assert(PSMEM <= 232448, "one CTA an SM");

// One CTA: rows [blockIdx.x * GBM, +GBM) against the columns [blockIdx.y *
// cols_per_split, +cols_per_split) of N; dst is (splits, M, D).
__global__ void __launch_bounds__(GTHREADS, 1)
plain_grad_kernel(const float* __restrict__ z_rows, const float* __restrict__ z_cols,
                  const float* __restrict__ inv_rows, const float* __restrict__ inv_cols,
                  const int* __restrict__ row_ids, int M, int N, float temperature,
                  int cols_per_split, float* __restrict__ dst) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + PBARS, empty0 = full0 + 8 * GSTAGES;
  const uint32_t zc_ready = empty0 + 8 * GSTAGES, zc_free = zc_ready + 8;
  const uint32_t zt_ready = zc_free + 8, zt_free = zt_ready + 8;
  const int row0 = (int)blockIdx.x * GBM;
  const int col_begin = (int)blockIdx.y * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const int tiles = (col_end - col_begin + GBN - 1) / GBN;
  const int tid = (int)threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, GTHREADS / 32);    // every warp reads a stage
    }
    mbar_init(zc_ready, HELPERS / 32);
    mbar_init(zc_free, MMA_THREADS / 32);
    mbar_init(zt_ready, HELPERS / 32);
    mbar_init(zt_free, MMA_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies tile k into its stage: z_c rows and 1/neg; a ragged
  // tail (< 16 bytes) by plain stores, posted with the barrier
  const auto load_tile = [&](int k) {
    const int s = k % GSTAGES;
    if (k >= GSTAGES) mbar_wait(empty0 + 8 * s, (k / GSTAGES - 1) & 1);
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    uint8_t* st = sm + PSTAGE0 + s * PSTAGE_BYTES;
    const uint32_t ibytes = n * 4, ibulk = ibytes & ~15u;
    for (uint32_t w = ibulk / 4; w < ibytes / 4; ++w)
      reinterpret_cast<float*>(st + PST_I)[w] = inv_cols[c0 + w];
    const uint32_t bar = full0 + 8 * s, dst0 = base + PSTAGE0 + s * PSTAGE_BYTES;
    mbar_expect_tx(bar, (uint32_t)n * D * 4 + ibulk);
    bulk_load(dst0 + ST_Z, z_cols + (size_t)c0 * D, n * D * 4, bar);
    if (ibulk) bulk_load(dst0 + PST_I, inv_cols + c0, ibulk, bar);
  };
  if (tid == 0)
    for (int k = 0; k < min(tiles, GSTAGES - 1); ++k) load_tile(k);
  split_rows(sm, z_rows, row0, M);
  fence_async_smem();
  named_sync(1, GTHREADS);

  if (tid >= MMA_THREADS) {
    // ---- the helpers: z_c into hi and lo, as rows (K = feature) and
    // transposed (K = column); columns past the tile's end are zero. Helper
    // h takes the columns j[e] = 8 (jb / 2) + 2e + jb % 2, which the
    // transposed planes hold at K = 4 jb + e, and feature chunk db ----
    const int h = tid - MMA_THREADS, jb = h / (D / 4), db = h % (D / 4);
    int j[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) j[e] = 8 * (jb / 2) + 2 * e + jb % 2;
    for (int k = 0; k < tiles; ++k) {
      const int s = k % GSTAGES;
      const uint8_t* st = sm + PSTAGE0 + s * PSTAGE_BYTES;
      const int n = min(GBN, col_end - (col_begin + k * GBN));
      mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);
      float4 hi[4], lo[4];
      split_col_chunks(st + ST_Z, j, db, n, hi, lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the raw tile is in registers

      if (k >= 1) mbar_wait(zc_free, (k - 1) & 1);    // c of tile k - 1 is done
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<float4*>(sm + ZC_HI + swz(j[e], db, GBN)) = hi[e];
        *reinterpret_cast<float4*>(sm + ZC_LO + swz(j[e], db, GBN)) = lo[e];
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(zc_ready);

      const float4 th[4] = {make_float4(hi[0].x, hi[1].x, hi[2].x, hi[3].x),
                            make_float4(hi[0].y, hi[1].y, hi[2].y, hi[3].y),
                            make_float4(hi[0].z, hi[1].z, hi[2].z, hi[3].z),
                            make_float4(hi[0].w, hi[1].w, hi[2].w, hi[3].w)};
      const float4 tl[4] = {make_float4(lo[0].x, lo[1].x, lo[2].x, lo[3].x),
                            make_float4(lo[0].y, lo[1].y, lo[2].y, lo[3].y),
                            make_float4(lo[0].z, lo[1].z, lo[2].z, lo[3].z),
                            make_float4(lo[0].w, lo[1].w, lo[2].w, lo[3].w)};
      if (k >= 1) mbar_wait(zt_free, (k - 1) & 1);    // P z_c of tile k - 1 is done
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<float4*>(sm + ZT_HI + swz(4 * db + e, jb, D)) = th[e];
        *reinterpret_cast<float4*>(sm + ZT_LO + swz(4 * db + e, jb, D)) = tl[e];
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(zt_ready);
    }
    return;
  }

  // ---- the tensor-core warpgroup: rows ra, rb; columns 8q + 2t + e ----
  const int warp = tid / 32, gq = lane / 4, t = lane % 4;
  const int ra = 16 * warp + gq, rb = ra + 8;
  const float inv_t = __frcp_rn(temperature);   // exp(c * (1 / T)): within an ulp of c / T
  int rid[2];
  float inv_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    rid[hh] = r < M ? row_ids[r] : -1;      // global ids are >= 0
    inv_r[hh] = r < M ? inv_rows[r] : 0.f;
  }
  // G as #4's: each tile's P z_c from 0, added by round-to-nearest adds
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % GSTAGES;
    const int c0 = col_begin + k * GBN, n = min(GBN, col_end - c0);
    const float* ic = reinterpret_cast<const float*>(sm + PSTAGE0 + s * PSTAGE_BYTES + PST_I);
    if (tid == 0 && k + GSTAGES - 1 < tiles) load_tile(k + GSTAGES - 1);
    __syncwarp();                 // warp 0 whole again before the .aligned wgmma

    mbar_wait(zc_ready, k & 1);
    float cov[16];
    product_rows_cols<3>(cov, base);
    __syncwarp();
    if (lane == 0) mbar_arrive(zc_free);

    // P = exp(c / T) (inv_i + inv_j), 0 on the self pair and past the end,
    // in hi and lo: the A fragments of G += P z_c, K-step q holding this
    // thread's columns 8q + 2t (K = t) and 8q + 2t + 1 (K = t + 4)
    mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);    // 1/neg of the columns
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * q + 2 * hh + e, j = 8 * q + 2 * t + e;
          const float pv = __fmul_rn(expf(__fmul_rn(cov[i], inv_t)), __fadd_rn(inv_r[hh], ic[j]));
          float hi, lo;
          split((j < n && c0 + j != rid[hh] && rid[hh] >= 0) ? pv : 0.f, hi, lo);
          ph[4 * q + 2 * e + hh] = __float_as_uint(hi);
          pl[4 * q + 2 * e + hh] = __float_as_uint(lo);
        }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    // G += P z_c in two halves of 64 features: lo*hi, hi*lo, hi*hi, 4 K-steps each
    mbar_wait(zt_ready, k & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      fence_regs(part);
      wgmma_fence();
      const uint32_t bs[3] = {ZT_HI, ZT_LO, ZT_HI};
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int ks = 0; ks < GBN / 8; ++ks) {
          const uint64_t b = smem_desc(base + bs[p] + half * 64 * 128 + ks * 32);
          if (p == 0)
            mma_n64_rs(part, pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3], b, ks > 0);
          else
            mma_n64_rs(part, ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3], b, 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * half + i] = __fadd_rn(acc[32 * half + i], part[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(zt_free);             // the transposed planes may be overwritten
  }

  float* out = dst + (size_t)blockIdx.y * M * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    if (r < M) {
#pragma unroll
      for (int q = 0; q < D / 8; ++q)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * q + 2 * t) =
            make_float2(acc[4 * q + 2 * hh], acc[4 * q + 2 * hh + 1]);
    }
  }
}

// ---- #1 on Hopper: plain_denom_kernel --------------------------------------
//
// #2's kernel without the joints, the distances and the w plane: the rows'
// planes at #4's offsets (ZR_HI, ZR_LO), the tile's row planes after them,
// then the ring of raw tiles, z_c rows alone. A tile has TN columns (DBN
// is the width the entry point takes; see the note at the top).
constexpr int DBN = 64;
template <int TN>
struct DenomLayout {
  static constexpr int ZC_HI = 65536, ZC_LO = ZC_HI + TN * D * 4;
  static constexpr int STAGE0 = ZC_LO + TN * D * 4;
  static constexpr int STAGE_BYTES = TN * D * 4;
  static constexpr int BARS = STAGE0 + GSTAGES * STAGE_BYTES;
  // full[3], empty[3], zc_ready, zc_free; and the base's alignment
  static constexpr int SMEM = BARS + 8 * (2 * GSTAGES + 2) + 1024;
  static_assert(SMEM <= 232448, "one CTA an SM");
};

// d (+)= a b, 64 x 8 of A against TN x 8 of B
template <int TN>
__device__ __forceinline__ void mma_cols(float (&d)[TN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (TN == 32)
    mma_n32(d, a, b, scale_d);
  else
    mma_n64(d, a, b, scale_d);
}

// c = z_r z_c^T for the warpgroup's 64 rows against a tile's TN columns:
// lo*hi, hi*lo and hi*hi, each pass a chain of 16 K-steps into its own
// accumulator, waited for before it returns; then (lo*hi + hi*lo) + hi*hi,
// as product_rows_cols<3> adds them
template <int TN>
__device__ __forceinline__ void denom_product(float (&cov)[TN / 2], uint32_t base) {
  using L = DenomLayout<TN>;
  float a[TN / 2], b[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) cov[i] = a[i] = b[i] = 0.f;
  fence_regs(cov);
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint32_t ka = (ks / 4) * GBM * 128 + (ks % 4) * 32;
    const uint32_t kb = (ks / 4) * TN * 128 + (ks % 4) * 32;
    mma_cols<TN>(a, smem_desc(base + ZR_LO + ka), smem_desc(base + L::ZC_HI + kb), ks > 0);
    mma_cols<TN>(b, smem_desc(base + ZR_HI + ka), smem_desc(base + L::ZC_LO + kb), ks > 0);
    mma_cols<TN>(cov, smem_desc(base + ZR_HI + ka), smem_desc(base + L::ZC_HI + kb), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(cov);
  fence_regs(a);
  fence_regs(b);
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) cov[i] = __fadd_rn(__fadd_rn(a[i], b[i]), cov[i]);
}

// One CTA: rows [blockIdx.x * GBM, +GBM) against the columns [blockIdx.y *
// cols_per_split, +cols_per_split) of N; dst is (splits, M).
template <int TN>
__global__ void __launch_bounds__(GTHREADS, 1)
plain_denom_kernel(const float* __restrict__ z_rows, const float* __restrict__ z_cols,
                   const int* __restrict__ row_ids, int M, int N, float temperature,
                   int cols_per_split, float* __restrict__ dst) {
  using L = DenomLayout<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + L::BARS, empty0 = full0 + 8 * GSTAGES;
  const uint32_t zc_ready = empty0 + 8 * GSTAGES, zc_free = zc_ready + 8;
  const int row0 = (int)blockIdx.x * GBM;
  const int col_begin = (int)blockIdx.y * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);
  const int tiles = (col_end - col_begin + TN - 1) / TN;
  const int tid = (int)threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, HELPERS / 32);      // only the helpers read a stage
    }
    mbar_init(zc_ready, HELPERS / 32);
    mbar_init(zc_free, MMA_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies tile k's z_c rows into its stage: whole rows of 512
  // bytes, so no ragged tail
  const auto load_tile = [&](int k) {
    const int s = k % GSTAGES;
    if (k >= GSTAGES) mbar_wait(empty0 + 8 * s, (k / GSTAGES - 1) & 1);
    const int c0 = col_begin + k * TN, n = min(TN, col_end - c0);
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, (uint32_t)n * D * 4);
    bulk_load(base + L::STAGE0 + s * L::STAGE_BYTES, z_cols + (size_t)c0 * D, n * D * 4, bar);
  };
  if (tid == 0)
    for (int k = 0; k < min(tiles, GSTAGES - 1); ++k) load_tile(k);
  split_rows(sm, z_rows, row0, M);
  fence_async_smem();
  named_sync(1, GTHREADS);

  if (tid >= MMA_THREADS) {
    // ---- the helpers: rows E jb + e (e < E) of each tile, feature chunk db,
    // into hi and lo; rows past the tile's end are zero ----
    constexpr int E = TN * (D / 4) / HELPERS;
    const int h = tid - MMA_THREADS, jb = h / (D / 4), db = h % (D / 4);
    for (int k = 0; k < tiles; ++k) {
      const int s = k % GSTAGES;
      const uint8_t* st = sm + L::STAGE0 + s * L::STAGE_BYTES;
      const int n = min(TN, col_end - (col_begin + k * TN));
      mbar_wait(full0 + 8 * s, (k / GSTAGES) & 1);
      float4 hi[E], lo[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = E * jb + e;
        const float4 v = j < n ? *reinterpret_cast<const float4*>(st + j * D * 4 + db * 16)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        split4(v, hi[e], lo[e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the raw tile is in registers

      if (k >= 1) mbar_wait(zc_free, (k - 1) & 1);    // c of tile k - 1 is done
#pragma unroll
      for (int e = 0; e < E; ++e) {
        *reinterpret_cast<float4*>(sm + L::ZC_HI + swz(E * jb + e, db, TN)) = hi[e];
        *reinterpret_cast<float4*>(sm + L::ZC_LO + swz(E * jb + e, db, TN)) = lo[e];
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(zc_ready);
    }
    return;
  }

  // ---- the tensor-core warpgroup: rows ra, rb; columns 8q + 2t + e ----
  const int warp = tid / 32, gq = lane / 4, t = lane % 4;
  const int ra = 16 * warp + gq, rb = ra + 8;
  const float inv_t = __frcp_rn(temperature);   // exp(c * (1 / T)): within an ulp of c / T
  int rid[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (hh ? rb : ra);
    rid[hh] = r < M ? row_ids[r] : -1;      // global ids are >= 0
  }
  // each row's sum as #2's: a tile's terms in registers, then
  // round-to-nearest adds tile after tile; the quad's four sums at the end
  float sum[2] = {0.f, 0.f};
  for (int k = 0; k < tiles; ++k) {
    const int c0 = col_begin + k * TN, n = min(TN, col_end - c0);
    // two tiles ahead, into the stage tile k - 1 has left
    if (tid == 0 && k + GSTAGES - 1 < tiles) load_tile(k + GSTAGES - 1);
    __syncwarp();                 // warp 0 whole again before the .aligned wgmma

    mbar_wait(zc_ready, k & 1);
    float cov[TN / 2];
    denom_product<TN>(cov, base);
    __syncwarp();
    if (lane == 0) mbar_arrive(zc_free);              // the planes may be overwritten

    // exp(c / T), 0 on the self pair and past the end
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < TN / 8; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * q + 2 * hh + e, j = 8 * q + 2 * t + e;
          const float ex = expf(__fmul_rn(cov[i], inv_t));
          if (j < n && c0 + j != rid[hh]) part[hh] = __fadd_rn(part[hh], ex);
        }
    sum[0] = __fadd_rn(sum[0], part[0]);
    sum[1] = __fadd_rn(sum[1], part[1]);
  }

  // the four lanes of a row (t = 0..3) in a fixed order
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 1));
    sum[hh] = __fadd_rn(sum[hh], __shfl_xor_sync(0xffffffffu, sum[hh], 2));
  }
  if (t == 0) {
    float* out = dst + (size_t)blockIdx.y * M;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + (hh ? rb : ra);
      if (r < M) out[r] = sum[hh];
    }
  }
}

#undef D16
#undef REGS16

// the dynamic shared memory `kernel` may take, set once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// launch(dst) runs kernel #K's CTAs with dst = out, or with splits, dst =
// partial, whose splits x count floats #K's own sum pass then adds into out
template <int K, typename Launch>
int with_splits(int splits, int64_t count, void* partial, void* out, cudaStream_t s,
                Launch launch) {
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  launch(dst);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  sum_splits_kernel<K><<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      dst, splits, count, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// the tensor-core kernels' grid: split s of the splits takes the columns
// [s * cols_per_split, (s + 1) * cols_per_split), a multiple of the
// kernel's tile (32 columns; #1's DBN), and the splits cover the N columns
// exactly
bool bad_split_grid(int M, int N, int splits, int cols_per_split, int tile = GBN) {
  return M <= 0 || N <= 0 || splits <= 0 || cols_per_split <= 0 || cols_per_split % tile != 0 ||
         (long long)cols_per_split * splits < N || (long long)cols_per_split * (splits - 1) >= N ||
         splits > 65535;
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). Pointers are
// device pointers to contiguous float32 (row_ids: int32) tensors; z tensors
// are 16-byte aligned with 128 columns; joints are (rows, 42); minmax is
// [d_max, d_min]; partial holds splits * M (denominators) or
// splits * M * 128 (gradients) floats and is unused when splits == 1.

// Replaces _ntxent_denom_kernel (pallas_ntxent.py:46-72, called at :88).
// The product on the tensor cores in three TF32 passes (see the note
// above). The grid as weighted_grad_rows', with tiles of DBN columns;
// z_rows and z_cols are 16-byte aligned (float4 loads, bulk copies).
int ntxent_denominator(const void* z_rows, const void* z_cols, const void* row_ids, int M, int N,
                       float temperature, int splits, int cols_per_split, void* partial,
                       void* out, void* stream) {
  if (bad_split_grid(M, N, splits, cols_per_split, DBN)) return (int)cudaErrorInvalidValue;
  if (misaligned({z_rows, z_cols})) return (int)cudaErrorMisalignedAddress;
  constexpr int smem = DenomLayout<DBN>::SMEM;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(plain_denom_kernel<DBN>, smem, done);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_splits<1>(splits, M, partial, out, s, [&](float* dst) {
    plain_denom_kernel<DBN><<<dim3((M + GBM - 1) / GBM, splits), GTHREADS, smem, s>>>(
        static_cast<const float*>(z_rows), static_cast<const float*>(z_cols),
        static_cast<const int*>(row_ids), M, N, temperature, cols_per_split, dst);
  });
}

// Replaces _weighted_denom_kernel (pallas_ntxent.py:109-150, called at
// :177). The product on the tensor cores in three TF32 passes, the 21 joint
// distances a pair on the CUDA cores (see the note above). The grid as
// weighted_grad_rows'; z_cols and j_cols are 16-byte aligned (bulk copies),
// z_rows too (float4 loads).
int weighted_ntxent_denominator(const void* z_rows, const void* z_cols,
                                const void* j_rows, const void* j_cols,
                                const void* row_ids, const void* minmax,
                                int M, int N, float temperature, int splits,
                                int cols_per_split, void* partial, void* out,
                                void* stream) {
  if (bad_split_grid(M, N, splits, cols_per_split)) return (int)cudaErrorInvalidValue;
  if (misaligned({z_rows, z_cols, j_cols})) return (int)cudaErrorMisalignedAddress;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(weighted_denom_kernel, DSMEM, done);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_splits<2>(splits, M, partial, out, s, [&](float* dst) {
    weighted_denom_kernel<<<dim3((M + GBM - 1) / GBM, splits), GTHREADS, DSMEM, s>>>(
        static_cast<const float*>(z_rows), static_cast<const float*>(z_cols),
        static_cast<const float*>(j_rows), static_cast<const float*>(j_cols),
        static_cast<const int*>(row_ids), static_cast<const float*>(minmax), M, N, temperature,
        cols_per_split, dst);
  });
}

// Replaces _ntxent_grad_kernel (pallas_ntxent.py:204-232, called at :244).
// Both products on the tensor cores in three TF32 passes (see the note
// above). The grid as weighted_grad_rows'; z_cols and inv_cols are 16-byte
// aligned (bulk copies), z_rows too (float4 loads).
int ntxent_grad(const void* z_rows, const void* z_cols, const void* inv_rows,
                const void* inv_cols, const void* row_ids, int M, int N,
                float temperature, int splits, int cols_per_split, void* partial,
                void* out, void* stream) {
  if (bad_split_grid(M, N, splits, cols_per_split)) return (int)cudaErrorInvalidValue;
  if (misaligned({z_rows, z_cols, inv_cols})) return (int)cudaErrorMisalignedAddress;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(plain_grad_kernel, PSMEM, done);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_splits<3>(splits, (int64_t)M * D, partial, out, s, [&](float* dst) {
    plain_grad_kernel<<<dim3((M + GBM - 1) / GBM, splits), GTHREADS, PSMEM, s>>>(
        static_cast<const float*>(z_rows), static_cast<const float*>(z_cols),
        static_cast<const float*>(inv_rows), static_cast<const float*>(inv_cols),
        static_cast<const int*>(row_ids), M, N, temperature, cols_per_split, dst);
  });
}

// Replaces _weighted_grad_kernel (pallas_ntxent.py:316-360, called at :608).
// The products on the tensor cores in three TF32 passes, the distances on
// the CUDA cores (see the note above). Split s of the splits takes the
// columns [s * cols_per_split, (s + 1) * cols_per_split), a multiple of 32,
// and the splits cover the N columns exactly; z_cols, j_cols and inv_cols
// are 16-byte aligned (bulk copies), z_rows too (float4 loads).
int weighted_grad_rows(const void* z_rows, const void* z_cols,
                       const void* j_rows, const void* j_cols,
                       const void* inv_rows, const void* inv_cols,
                       const void* row_ids, const void* minmax, int M, int N,
                       float temperature, int splits, int cols_per_split,
                       void* partial, void* out, void* stream) {
  if (bad_split_grid(M, N, splits, cols_per_split)) return (int)cudaErrorInvalidValue;
  if (misaligned({z_rows, z_cols, j_cols, inv_cols})) return (int)cudaErrorMisalignedAddress;
  static bool done[64] = {};
  const cudaError_t err = allow_smem(weighted_grad_kernel, GSMEM, done);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_splits<4>(splits, (int64_t)M * D, partial, out, s, [&](float* dst) {
    weighted_grad_kernel<<<dim3((M + GBM - 1) / GBM, splits), GTHREADS, GSMEM, s>>>(
        static_cast<const float*>(z_rows), static_cast<const float*>(z_cols),
        static_cast<const float*>(j_rows), static_cast<const float*>(j_cols),
        static_cast<const float*>(inv_rows), static_cast<const float*>(inv_cols),
        static_cast<const int*>(row_ids), static_cast<const float*>(minmax), M, N, temperature,
        cols_per_split, dst);
  });
}

const char* ntxent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
