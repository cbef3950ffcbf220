// A bf16 convolution with a float32 bias / residual / ReLU epilogue, for
// Hopper (sm_90a): an implicit GEMM on TMA and wgmma.
//
// What it computes, for x a channels-last (N, H, W, Cin) bf16 activation, w
// the (Cout, KH * KW * Cin) bf16 weight (tap-major, Cin innermost: tap
// (ky, kx) at columns (ky * KW + kx) * Cin + c), b a float32 (Cout,) bias
// and res an optional (N, OH, OW, Cout) bf16 residual:
//   y[n, oy, ox, o] = bf16(act(sum_{ky, kx, c} x[n, s oy + ky - pt, s ox + kx - pl, c]
//                                                * w[o, (ky KW + kx) Cin + c]
//                              + b[o] (+ float(res[n, oy, ox, o]))))
// with reads outside the image zero, act ReLU or the identity, float32 sums
// of bf16 products, and one rounding at the end.
//
// What it replaces: the serving forward's convolutions, each of which the
// reference runs as jax.lax.conv_general_dilated(preferred_element_type=
// float32) + b, rounded once (simhand_tpu/ops/bottleneck_block.py:186-204,
// FoldedBf16Ops), and kernel #12, the whole frozen identity bottleneck
// (simhand_tpu/ops/bottleneck_block.py:92 bottleneck_block, _block_kernel
// :46-89), which ops/bottleneck_block.py runs as three launches of this
// kernel: a 1x1 with ReLU, the 3x3 'SAME' with ReLU, a 1x1 with the
// residual x and ReLU.
//
// Why three launches and not one program a block, on this card. The Pallas
// kernel keeps h1 and h2 in VMEM to save bytes. At the serving shape (layer4,
// 4 x 4 images, 256 of them, C = 2,048, Cm = 512) the block is bound by
// operations: 36.5 GFLOP, 0.0369 ms at 989 TFLOP/s, against 42.5 MB, 0.0127
// ms at 3.35 TB/s. It has only M = 4,096 rows, 32 row tiles of 128: a
// program that owns whole rows of the block fills at most 32 of 132 SMs, or
// it must shrink its tiles (the earlier one-launch design: 32-row blocks
// that each read all 8.9 MB of weights through L2, ~1.1 GB a launch). Split
// by output columns, the three GEMMs give 128, 128 and 256 tiles; h1 and h2
// (4.2 MB each) stay in the 50 MB L2, and their round trips add ~16 MB, ~5 us
// at the memory rate. On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py)
// the three launches take 0.092 ms of device time there, the one-launch
// design 0.351 and cuDNN's three convolutions with their bias and ReLU
// passes 0.159. Where the block is bound by bytes it costs more: at layer1 of
// a 128 x 128 input (M = 262,144, C = 256, Cm = 64), x and y are 268 MB
// (0.080 ms) and h1 and h2 add 134 MB. That shape is not on the serving
// configuration's path; the block runs it, which the whole-image design could
// not (its h1 and h2 outgrew shared memory).
//
// Design: conv1x1.cu's warp-specialised, persistent TMA + wgmma GEMM with an
// implicit-GEMM A operand.
// - A (M = N OH OW output pixels x K): a 4-D TMA map over x (Cin, W, H, N),
//   one box per (tap, 64 input channels): a tile of output pixels is a box
//   of whole image rows or whole images, timg x trows x tcols pixels (<= 128
//   rows: 8 images of 4 x 4, 4 rows of 32, 128 columns of a long row), and
//   tap (ky, kx)'s box starts at (c0, s ox0 + kx - pl, s oy0 + ky - pt, n0).
//   TMA fills coordinates outside the tensor, negative ones included, with
//   zeros: that is the convolution's padding, with no mask and no copy, and
//   a tile never needs its whole image. Channels past Cin read zeros too, so
//   Cin need only be a multiple of 8 (the weight columns they meet multiply
//   zeros). Stride 2 takes the map's element strides (box 2 tcols x 2 trows,
//   every other element loaded), which keep the tiled mode's 128-byte swizzle
//   and the wgmma descriptors of the 1x1 GEMM; TMA's im2col mode would walk
//   pixels across image rows, which the row tiles do not need. A 1x1 stride-1
//   convolution is given as one image of one row of N H W pixels, so every
//   tile is 128 full rows. A tile's rows past its box are never stored.
// - B: a 2-D map over w (Cout, K), boxes of 64 K columns; clusters of two
//   CTAs share a column tile and each loads half of it, which TMA multicasts
//   into both (conv1x1.cu's header gives what that saved there).
// - Tiles of 128 pixels x BN output channels, BN = 64 for Cout <= 64, else
//   256 where that still gives the card at least one tile per SM, else 128
//   (layer4's 512 channels at M = 4,096: 128 tiles, not 64).
// - Warpgroups 0 and 1 consume (64 rows each, wgmma.m64n{BN}k16, float32
//   accumulators; setmaxnreg 232), warpgroup 2's first thread produces (TMA
//   into a ring of 128-byte-swizzled stages; setmaxnreg 40). A persistent
//   grid: cluster q keeps column tile q % n_tiles and walks pairs of row
//   tiles, so the producer loads the next tile during the epilogue.
// - Epilogue, on the float32 accumulators: + b, + the residual, ReLU, one
//   rounding to bf16 into a y stage laid out as the y map's boxes (128-byte
//   swizzle, so the 4-byte stores hit 32 banks), stored with one TMA store a
//   64-channel chunk (clipped at the image's edge). The residual tile is
//   loaded by TMA into that same stage while the tile's K loop runs, and
//   each thread reads its elements just before it writes them back. No
//   atomics, and every output sums its K in one order: a second launch gives
//   the same bits.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // pixels of a tile: two consumer warpgroups of 64
constexpr int BK = 64;            // K columns of a stage: one 128-byte swizzle row
constexpr int THREADS = 384;      // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CHUNK = BM * 128;   // bytes of one 64-channel chunk of the y stage

template <int BN>
struct Config {
  static constexpr int STAGES = BN == 256 ? 3 : (BN == 128 ? 5 : 8);
  static constexpr int X_BYTES = BM * BK * 2;   // 16 KB
  static constexpr int STAGE_BYTES = X_BYTES + BN * BK * 2;
  static constexpr int Y_BYTES = BM * BN * 2;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + Y_BYTES + (2 * STAGES + 1) * 8;
};
static_assert(Config<256>::SMEM <= 232448 && Config<128>::SMEM <= 232448 &&
                  Config<64>::SMEM <= 232448,
              "shared memory");

// The output's tiling and the convolution's geometry.
struct Geo {
  int tiles_c, tiles_r;        // column and row tiles of an image (tiles_i = the rest)
  int tcols, trows, timg;      // a tile's box, in output pixels
  int rows;                    // tcols * trows * timg <= BM
  int stride, pt, pl, kw, taps, chunks, cin, cout;
  int relu, res;
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the first output pixel (ox0, oy0, n0) of row tile mt
__device__ __forceinline__ void tile_origin(const Geo& g, int mt, int& ox0, int& oy0, int& n0) {
  const int ct = mt % g.tiles_c, rest = mt / g.tiles_c;
  ox0 = ct * g.tcols, oy0 = (rest % g.tiles_r) * g.trows, n0 = (rest / g.tiles_r) * g.timg;
}

// Grid: clusters of two CTAs, n_tiles * groups / 2 of them. Cluster q
// computes column tile q % n_tiles; its CTA of rank r walks the row tiles
// 2 (q / n_tiles) + r + i * groups.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_bias_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap y_map,
                 const __grid_constant__ CUtensorMap r_map, const float* __restrict__ bias,
                 int m_tiles, const Geo g) {
  using Cfg = Config<BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: the tiles start on it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ystage = ring + STAGES * Cfg::STAGE_BYTES;
  const uint32_t full0 = smem_u32(ystage + Cfg::Y_BYTES);
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t res_full = empty0 + 8 * STAGES;

  const int n_tiles = (g.cout + BN - 1) / BN;
  const int k_steps = g.taps * g.chunks;
  const int cluster = (int)blockIdx.x / 2, rank = (int)cluster_rank();
  const int groups = (int)gridDim.x / n_tiles, first = 2 * (cluster / n_tiles);
  const int n0 = (cluster % n_tiles) * BN;
  const uint32_t a_bytes = (uint32_t)g.rows * 128;
  // the 64-channel chunks of the column tile inside Cout
  const int chunks_out = min(BN, g.cout - n0 + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 16);   // one arrival per consumer warp of both CTAs
    }
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // both CTAs' barriers exist before either is signalled

  const int wg = (int)threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      // a tile past the last (rank 1 of an odd count) or a w half past Cout
      // loads valid data instead: its results are not stored
      const int w_row = n0 + rank * (BN / 2) < g.cout ? n0 + rank * (BN / 2) : 0;
      const uint32_t w_dst = Cfg::X_BYTES + rank * (BN / 2) * 128;
      int stage = 0;
      uint32_t phase = 0;
      for (int mt0 = first; mt0 < m_tiles; mt0 += groups) {
        int ox0, oy0, img0;
        tile_origin(g, mt0 + rank < m_tiles ? mt0 + rank : 0, ox0, oy0, img0);
        const int ix0 = ox0 * g.stride - g.pl, iy0 = oy0 * g.stride - g.pt;
        for (int t = 0; t < g.taps; ++t) {
          const int ky = t / g.kw, kx = t % g.kw;
          for (int c = 0; c < g.chunks; ++c) {
            // the stage is free in both CTAs: the peer's half lands here too
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t full = full0 + 8 * stage;
            const uint32_t xs = smem_u32(ring + stage * Cfg::STAGE_BYTES);
            mbar_expect_tx(full, a_bytes + BN * 128);
            tma_load_4d(xs, &x_map, full, c * BK, ix0 + kx, iy0 + ky, img0);
            tma_load_both(xs + w_dst, &w_map, full, t * g.cin + c * BK, w_row);
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
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
    const int tid = (int)threadIdx.x, warp = (tid & 127) >> 5, lane = tid & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0, res_phase = 0;
    // the stage goes back to both producers
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty0 + 8 * s);
        mbar_arrive_cluster(empty0 + 8 * s, rank ^ 1);
      }
    };
    for (int mt0 = first; mt0 < m_tiles; mt0 += groups) {
      const int mt = mt0 + rank;
      int ox0, oy0, img0;
      tile_origin(g, mt < m_tiles ? mt : 0, ox0, oy0, img0);
      if (g.res && tid == 0) {
        // the residual tile into the y stage, once the last tile's stores
        // have read it; it lands while the K loop runs
        bulk_wait_read();
        mbar_expect_tx(res_full, chunks_out * a_bytes);
        for (int q = 0; q < chunks_out; ++q)
          tma_load_4d(smem_u32(ystage + q * CHUNK), &r_map, res_full, n0 + 64 * q, ox0, oy0, img0);
      }
      for (int kt = 0; kt < k_steps; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t base = smem_u32(ring + stage * Cfg::STAGE_BYTES);
        const uint64_t da = smem_desc(base + wg * (64 * 128));
        const uint64_t db = smem_desc(base + Cfg::X_BYTES);
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
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);

      // ---- epilogue: + b (+ res), act, one rounding, TMA store --------------
      if (g.res) {
        mbar_wait(res_full, res_phase);
        res_phase ^= 1;
      } else if (tid == 0) {
        bulk_wait_read();   // the last tile's y has left the stage
      }
      named_sync(1, 256);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        float2 bj = make_float2(0.f, 0.f);
        if (col < g.cout) bj = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
          uint8_t* p = ystage + (j >> 3) * CHUNK + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
                       4 * (lane & 3);
          float v0 = __fadd_rn(acc[4 * j + 2 * h], bj.x);
          float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], bj.y);
          if (g.res) {
            const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
            v0 = __fadd_rn(v0, rv.x), v1 = __fadd_rn(v1, rv.y);
          }
          if (g.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_async_smem();
      named_sync(1, 256);
      if (tid == 0 && mt < m_tiles) {
        for (int q = 0; q < chunks_out; ++q)
          tma_store_4d(&y_map, smem_u32(ystage + q * CHUNK), n0 + 64 * q, ox0, oy0, img0);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// ---- host ------------------------------------------------------------------

// a (d0, d1, d2, d3) bf16 tensor, d0 innermost and contiguous, read or
// written in boxes of box[0..3] elements (box[0] = 64: 128 bytes, the
// swizzle's width), every step-th element along d1 and d2
bool make_map_4d(CUtensorMap* map, const void* ptr, const int (&dims)[4], const int (&box)[4],
                 int step) {
  const cuuint64_t d[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2],
                           (cuuint64_t)dims[3]};
  const cuuint64_t strides[3] = {d[0] * 2, d[0] * d[1] * 2, d[0] * d[1] * d[2] * 2};
  const cuuint32_t b[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1], (cuuint32_t)box[2],
                           (cuuint32_t)box[3]};
  const cuuint32_t elem[4] = {1, (cuuint32_t)step, (cuuint32_t)step, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), d,
                        strides, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int clusters_of() {
  static int known[64] = {};
  return max_clusters(conv_bias_kernel<BN>, THREADS, Config<BN>::SMEM, known);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <int BN>
int launch(const void* x, const void* w, const void* b, const void* res, void* y, int N, int H,
           int W, int OH, int OW, const Geo& g, cudaStream_t s) {
  const int clusters = clusters_of<BN>();
  if (clusters == 0) return (int)cudaErrorNoDevice;
  const int m_tiles = g.tiles_c * g.tiles_r * ((N + g.timg - 1) / g.timg);
  const int n_tiles = (g.cout + BN - 1) / BN;
  const int groups = 2 * std::max(1, std::min((m_tiles + 1) / 2, clusters / n_tiles));
  const int k = g.taps * g.cin;
  CUtensorMap x_map, w_map, y_map, r_map;
  const int xd[4] = {g.cin, W, H, N}, yd[4] = {g.cout, OW, OH, N};
  const int xb[4] = {64, g.tcols * g.stride, g.trows * g.stride, g.timg};
  const int yb[4] = {64, g.tcols, g.trows, g.timg};
  if (!make_map_4d(&x_map, x, xd, xb, g.stride) || !make_map_2d(&w_map, w, g.cout, k, BN / 2) ||
      !make_map_4d(&y_map, y, yd, yb, 1) || !make_map_4d(&r_map, res ? res : y, yd, yb, 1))
    return (int)cudaErrorInvalidValue;
  const auto kernel = conv_bias_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Config<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_tiles * groups, THREADS, Config<BN>::SMEM, s, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, y_map, r_map, static_cast<const float*>(b),
                           m_tiles, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Replaces the serving walk's convolutions (simhand_tpu/ops/bottleneck_block.py:186-204)
// and, three launches a block, kernel #12 (:92 bottleneck_block). Returns a
// cudaError_t (0 on success). x: a contiguous (N, H, W, Cin) bf16 tensor;
// w: a contiguous (Cout, KH * KW * Cin) bf16 weight, tap-major; b: float32
// (Cout,); res: null or a contiguous (N, OH, OW, Cout) bf16 tensor; y: the
// contiguous (N, OH, OW, Cout) bf16 output. Cin and Cout are multiples of 8,
// the pointers 16-byte aligned, stride 1 or 2, pt and pl >= 0 (the bottom and
// right pads follow from OH and OW: reads past the image are zeros).
int conv_bias_act(const void* x, const void* w, const void* b, const void* res, void* y, int N,
                  int H, int W, int Cin, int OH, int OW, int Cout, int KH, int KW, int stride,
                  int pt, int pl, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 ||
      Cout % 8 || KH <= 0 || KW <= 0 || (stride != 1 && stride != 2) || pt < 0 || pl < 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  Geo g;
  if (OW >= BM) {   // part of a long row
    g.tcols = BM, g.trows = 1, g.timg = 1;
  } else if (OH * OW <= BM) {   // whole images
    g.tcols = OW, g.trows = OH, g.timg = std::min(N, BM / (OH * OW));
  } else {   // whole rows of an image
    g.tcols = OW, g.trows = BM / OW, g.timg = 1;
  }
  g.rows = g.tcols * g.trows * g.timg;
  g.tiles_c = (OW + g.tcols - 1) / g.tcols, g.tiles_r = (OH + g.trows - 1) / g.trows;
  g.stride = stride, g.pt = pt, g.pl = pl, g.kw = KW, g.taps = KH * KW;
  g.chunks = (Cin + BK - 1) / BK, g.cin = Cin, g.cout = Cout;
  g.relu = relu != 0, g.res = res != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64) return launch<64>(x, w, b, res, y, N, H, W, OH, OW, g, s);
  const long m_tiles = (long)g.tiles_c * g.tiles_r * ((N + g.timg - 1) / g.timg);
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  if (Cout > 128 && m_tiles * ((Cout + 255) / 256) >= sms)
    return launch<256>(x, w, b, res, y, N, H, W, OH, OW, g, s);
  return launch<128>(x, w, b, res, y, N, H, W, OH, OW, g, s);
}

const char* conv_bias_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
