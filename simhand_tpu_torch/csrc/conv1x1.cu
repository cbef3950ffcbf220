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
//   y[m, n] = bf16(sum_k x[m, k] w[n, k])       float32 accumulation
//   s1[n]   = sum_m float(y[m, n]),  s2[n] = sum_m float(y[m, n])^2
// The statistics are those of the rounded y, as the reference's epilogue
// takes them (conv1x1.py:50-57).
//
// What bounds them on this card: the ResNet-50 step's sites are either
// memory-bound (131,072 x 512 -> 128: 0.18 GB, 0.050 ms at 3.35 TB/s against
// 17 GFLOP, 0.017 ms at 989 TFLOP/s) or operation-bound (8,192 x 2,048 ->
// 512: 17 GFLOP against 0.043 GB).
//
// Design: a simple tensor-core GEMM. A block of 8 warps computes a 128 x 128
// tile of y; the K loop takes 32 columns a step, with cp.async 16-byte
// copies of the x and w tiles into double-buffered shared memory (rows
// padded to 40 bf16, so ldmatrix reads no bank twice). Each warp computes a
// 64 x 32 part with mma.sync.m16n8k16 (bf16 in, float32 accumulators). With
// AFFINE the x tile goes through registers instead: loaded a step ahead,
// transformed with the _rn intrinsics in the plain version's order, rounded
// to bf16 and stored. The epilogue rounds the accumulators to bf16, stages
// them in shared memory (the tile buffers), writes y with 16-byte stores
// and sums each column of the rounded tile over its rows in a fixed order:
// one (2, N) partial per row tile, added in order by a second kernel, so
// the sums are deterministic (no atomics). Rows and columns are masked at
// the edges: any M, and K and N multiples of 8. TMA, wgmma and a deeper
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;         // block tile, K step
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;    // 256
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 64 x 32
constexpr int MI = WM / 16, NI = WN / 8;           // its 4 x 4 mma tiles
constexpr int LDS = BK + 8;       // row pitch of a tile in shared memory: 80 bytes
constexpr int LDY = BN + 8;       // row pitch of the staged y: 272 bytes
constexpr int TILE = BM * LDS;    // bf16 elements of an x (or w) tile; BM == BN
constexpr int CHUNKS = BM * BK / 8 / THREADS;      // 16-byte copies per thread per tile
constexpr int SMEM = 2 * 2 * TILE;                 // x and w tiles, two stages
static_assert(BM == BN && BM * LDY <= SMEM && CHUNKS * THREADS * 8 == BM * BK,
              "tile shapes");
static_assert(THREADS == 2 * BN, "two threads sum each column");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu(x * a + b) of one bf16 value, rounded to bf16
__device__ __forceinline__ unsigned affine1(unsigned bits, float a, float b) {
  const float v = fmaxf(__fadd_rn(__fmul_rn(__uint_as_float(bits << 16), a), b), 0.f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the same for the two bf16 values of a 32-bit word (k and k + 1)
__device__ __forceinline__ unsigned affine2(unsigned v, const float* A, const float* B) {
  return affine1(v & 0xffffu, A[0], B[0]) | (affine1(v >> 16, A[1], B[1]) << 16);
}

// Block (blockIdx.x, blockIdx.y): columns [128 bx, +128), rows [128 by, +128)
// of y; writes its tile of y and its (2, N) partial sums, partial[by].
template <bool AFFINE>
__global__ void __launch_bounds__(THREADS)
conv1x1_stats_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ A, const float* __restrict__ B, int M, int N,
                     int K, __nv_bfloat16* __restrict__ y, float* __restrict__ partial) {
  __shared__ __align__(16) unsigned short smem_raw[SMEM];
  __shared__ float colsum[2][BN];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = (int)blockIdx.x * BN, m0 = (int)blockIdx.y * BM;
  const int k_steps = (K + BK - 1) / BK;
  auto x_tile = [&](int stage) { return smem + stage * 2 * TILE; };
  auto w_tile = [&](int stage) { return smem + stage * 2 * TILE + TILE; };

  // copy (r0 + [0, 128)) x (k0 + [0, 32)) of a row-major (rows, K) matrix
  auto copy_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int rows, int r0, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      const bool ok = r0 + r < rows && k0 + k < K;
      cp_async16(dst + r * LDS + k, ok ? src + (size_t)(r0 + r) * K + k0 + k : src, ok);
    }
  };
  uint4 staged[CHUNKS];   // AFFINE: the next x tile, on its way through registers
  auto load_x = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      staged[i] = m0 + r < M && k0 + k < K
                      ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + k))
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_x = [&](__nv_bfloat16* dst, int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), k = (c % (BK / 8)) * 8;
      uint4 v = staged[i];
      if (k0 + k < K) {   // columns past K stay 0, as w's do
        const float* a = A + k0 + k;
        const float* b = B + k0 + k;
        v.x = affine2(v.x, a, b);
        v.y = affine2(v.y, a + 2, b + 2);
        v.z = affine2(v.z, a + 4, b + 4);
        v.w = affine2(v.w, a + 6, b + 6);
      }
      *reinterpret_cast<uint4*>(dst + r * LDS + k) = v;
    }
  };
  auto load_step = [&](int step, int stage) {
    copy_tile(w_tile(stage), w, N, n0, step * BK);
    if constexpr (AFFINE) load_x(step * BK);
    else copy_tile(x_tile(stage), x, M, m0, step * BK);
    cp_async_commit();
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_step(0, 0);
  if constexpr (AFFINE) store_x(x_tile(0), 0);
  for (int step = 0; step < k_steps; ++step) {
    const int stage = step & 1;
    const bool next = step + 1 < k_steps;
    if (next) load_step(step + 1, stage ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* xs = x_tile(stage);
    const __nv_bfloat16* ws = w_tile(stage);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], xs + (wm * WM + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, ws + (wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                           ((lane >> 3) & 1) * 8);
        b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if constexpr (AFFINE) {
      if (next) store_x(x_tile(stage ^ 1), (step + 1) * BK);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // epilogue: the tile rounded to bf16, staged in the (now free) tile buffers
  __nv_bfloat16* ys = smem;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int r = wm * WM + i * 16 + g, c = wn * WN + j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(ys + r * LDY + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (r + 8) * LDY + c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  const int rows = min(BM, M - m0), cols = min(BN, N - n0);
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (r < rows && c < cols)
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * LDY + c);
  }
  // column sums of the rounded values: thread (half, c) adds rows
  // [64 half, 64 half + 64) in order, then half 0 adds half 1's sums
  const int c = tid % BN, half = tid / BN;
  float s1 = 0.f, s2 = 0.f;
  const int r_end = min(rows, (half + 1) * (BM / 2));
  for (int r = half * (BM / 2); r < r_end; ++r) {
    const float v = __bfloat162float(ys[r * LDY + c]);
    s1 = __fadd_rn(s1, v);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  if (half == 1) colsum[0][c] = s1, colsum[1][c] = s2;
  __syncthreads();
  if (half == 0 && c < cols) {
    float* dst = partial + (size_t)blockIdx.y * 2 * N + n0 + c;
    dst[0] = __fadd_rn(s1, colsum[0][c]);
    dst[N] = __fadd_rn(s2, colsum[1][c]);
  }
}

// out[i] = sum over row tiles s, in order, of partial[s * count + i]
__global__ void conv1x1_sum_partials_kernel(const float* __restrict__ partial, int splits,
                                            int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s = __fadd_rn(s, partial[(size_t)k * count + i]);
  out[i] = s;
}

template <bool AFFINE>
int launch(const void* x, const void* w, const void* A, const void* B, int M, int N, int K,
           void* y, void* partial, void* out, void* stream) {
  const int m_tiles = (M + BM - 1) / BM;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || m_tiles > 65535 ||
      (AFFINE && (A == nullptr || B == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(m_tiles == 1 ? out : partial);
  const dim3 grid((N + BN - 1) / BN, m_tiles);
  conv1x1_stats_kernel<AFFINE><<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(A), static_cast<const float*>(B), M, N, K,
      static_cast<__nv_bfloat16*>(y), dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m_tiles == 1) return (int)err;
  conv1x1_sum_partials_kernel<<<(2 * N + 255) / 256, 256, 0, s>>>(dst, m_tiles, 2 * N,
                                                                   static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). x is a device
// pointer to a row-major (M, K) bf16 plane, w to a row-major (N, K) bf16
// weight, y to the row-major (M, N) bf16 output; K and N are multiples of 8
// and the pointers 16-byte aligned. out is (2, N) float32: [s1; s2].
// partial holds ceil(M / 128) * 2 * N floats (unused when M <= 128).

// Replaces conv1x1_stats (conv1x1.py:128, _matmul_stats_kernel :26-31 with
// _stats_epilogue :49-73, called through _stats_call :102).
int conv1x1_stats(const void* x, const void* w, int M, int N, int K, void* y, void* partial,
                  void* out, void* stream) {
  return launch<false>(x, w, nullptr, nullptr, M, N, K, y, partial, out, stream);
}

// Replaces conv1x1_bn_relu_stats (conv1x1.py:133, _affine_matmul_stats_kernel
// :34-46): A and B are contiguous float32 (K,) vectors.
int conv1x1_bn_relu_stats(const void* x, const void* w, const void* A, const void* B, int M,
                          int N, int K, void* y, void* partial, void* out, void* stream) {
  return launch<true>(x, w, A, B, M, N, K, y, partial, out, stream);
}

const char* conv1x1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
