// BatchNorm backward kernels for Hopper (sm_90a), bf16 or float32 planes:
// the fused BatchNorm + ReLU backward, and the two reduces of the plain
// BatchNorm backward.
//
// Replaces the four Pallas TPU kernels of simhand_tpu/models/bn_epilogue.py:
//   masked_dual_reduce (RES = false) <- masked_dual_reduce / _masked_reduce_kernel
//   masked_dual_reduce (RES = true)  <- _bn_add_relu_bwd / _dual_reduce_res_kernel
//   masked_dx          (RES = false) <- masked_dx / _dx_kernel
//   masked_dx          (RES = true)  <- _bn_add_relu_bwd / _dx_res_kernel
// and the one of simhand_tpu/models/fused_bn.py:
//   dual_reduce                      <- bn_backward_reduces / _dual_reduce_kernel
//
// What they compute, per channel c of the row-major (M, C) planes g, x and
// (with RES) r, with float32 per-channel constants read from the card:
//   y    = A x + B (+ r)           the forward's pre-activation, in float32
//   dy   = y > 0 ? g : 0           the ReLU mask, recomputed, never stored
//   xhat = C x + D
//   reduce:  sum_rows dy, sum_rows dy * xhat            -> (2, C) float32
//   dx:      dx = P (dy - k1 - xhat k2) in the planes' dtype; RES: dres = dy
// dual_reduce takes no mask: dy = g and xhat = (x - mu) * inv (subtract,
// then multiply, as fused_bn.py does), with mu and inv float32 vectors.
// Every product and sum is a separately rounded float32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn) in the order of the plain PyTorch
// version, so that nvcc contracts nothing into an FMA: the mask, dx and
// dres equal the plain version's bit for bit.
//
// What bounds them on this card: memory. Each element costs a handful of
// float32 operations against 4 (reduce) to 10 (dx with a residual) bytes
// of bf16 traffic, far below the card's operations-per-byte balance. At
// the ResNet-50 step's stem site (M = 2,097,152, C = 64, bf16) the reduce
// moves 0.54 GB: 0.160 ms at 3.35 TB/s.
//
// Design. The Pallas grid walked the rows of a column tile in order and
// carried the sums in VMEM scratch; CUDA blocks run in no order. Here a
// block of 32 x 8 threads owns 32 channels (one per thread along x, so a
// warp reads 32 neighbouring elements of a row) and a range of rows, which
// its 8 row lanes walk with a stride of 8. Each thread loads its channel's
// constants once and keeps its sums in registers. The reduce writes one
// partial per row range; a second kernel adds the partials of each channel
// in a fixed order, so the sums are deterministic (no atomics). The masked
// reduces and dual_reduce share that structure (reduce_rows) and differ only
// in the two terms of an element. The dx pass
// is elementwise and needs no second pass. Rows and channels are masked at
// the edges, so any M and C work. A simple design: wider loads, TMA and
// fusing the two passes' reads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TX = 32;   // channels of a block, one per thread
constexpr int TY = 8;    // row lanes of a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dy and xhat of element i, in the plain version's order of operations
template <typename T, bool RES>
__device__ __forceinline__ void masked(const T* __restrict__ g, const T* __restrict__ x,
                                       const T* __restrict__ r, size_t i, float a, float b,
                                       float c, float d, float& dy, float& xhat) {
  const float xv = to_f32(x[i]);
  float y = __fadd_rn(__fmul_rn(xv, a), b);
  if (RES) y = __fadd_rn(y, to_f32(r[i]));
  dy = y > 0.f ? to_f32(g[i]) : 0.f;
  xhat = __fadd_rn(__fmul_rn(xv, c), d);
}

// The reduce of a block (blockIdx.x, blockIdx.y): channels [32 bx, +32),
// rows [by * rows_per_block, +rows_per_block); terms(i, dy, xhat) gives the
// two terms of element i of channel c. Writes the block's two partial sums
// to dst, which is (gridDim.y, 2, C).
template <typename Terms>
__device__ __forceinline__ void reduce_rows(int c, int M, int C, int rows_per_block,
                                            Terms terms, float* __restrict__ dst) {
  __shared__ float sums[2][TY][TX];
  const int row0 = (int)blockIdx.y * rows_per_block;
  const int row_end = min(M, row0 + rows_per_block);
  float sdy = 0.f, sdyx = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int row = row0 + (int)threadIdx.y; row < row_end; row += TY) {
      float dy, xhat;
      terms((size_t)row * C + c, dy, xhat);
      sdy = __fadd_rn(sdy, dy);
      sdyx = __fadd_rn(sdyx, __fmul_rn(dy, xhat));
    }
  }
  sums[0][threadIdx.y][threadIdx.x] = sdy;
  sums[1][threadIdx.y][threadIdx.x] = sdyx;
  __syncthreads();
  if (threadIdx.y < 2 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TY; ++k) s = __fadd_rn(s, sums[threadIdx.y][k][threadIdx.x]);
    dst[((size_t)blockIdx.y * 2 + threadIdx.y) * C + c] = s;
  }
}

template <typename T, bool RES>
__global__ void __launch_bounds__(TX * TY)
bn_masked_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x,
                        const T* __restrict__ r, const float* __restrict__ A,
                        const float* __restrict__ B, const float* __restrict__ Cc,
                        const float* __restrict__ D, int M, int C, int rows_per_block,
                        float* __restrict__ dst) {
  const int c = (int)(blockIdx.x * TX + threadIdx.x);
  float a = 0.f, b = 0.f, cc = 0.f, d = 0.f;
  if (c < C) a = A[c], b = B[c], cc = Cc[c], d = D[c];
  reduce_rows(c, M, C, rows_per_block, [&](size_t i, float& dy, float& xhat) {
    masked<T, RES>(g, x, r, i, a, b, cc, d, dy, xhat);
  }, dst);
}

// kernel #9: no mask; dy = g, xhat = (x - mu) * inv
template <typename T>
__global__ void __launch_bounds__(TX * TY)
bn_dual_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const float* __restrict__ mu, const float* __restrict__ inv, int M,
                      int C, int rows_per_block, float* __restrict__ dst) {
  const int c = (int)(blockIdx.x * TX + threadIdx.x);
  float m = 0.f, v = 0.f;
  if (c < C) m = mu[c], v = inv[c];
  reduce_rows(c, M, C, rows_per_block, [&](size_t i, float& dy, float& xhat) {
    dy = to_f32(g[i]);
    xhat = __fmul_rn(__fsub_rn(to_f32(x[i]), m), v);
  }, dst);
}

// out[i] = sum over row ranges s, in order, of partial[s * count + i]
__global__ void bn_sum_partials_kernel(const float* __restrict__ partial, int splits,
                                       int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s = __fadd_rn(s, partial[(size_t)k * count + i]);
  out[i] = s;
}

template <typename T, bool RES>
__global__ void __launch_bounds__(TX * TY)
bn_masked_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ r, const float* __restrict__ A,
                    const float* __restrict__ B, const float* __restrict__ Cc,
                    const float* __restrict__ D, const float* __restrict__ P,
                    const float* __restrict__ K1, const float* __restrict__ K2, int M,
                    int C, int rows_per_block, T* __restrict__ dx, T* __restrict__ dres) {
  const int c = (int)(blockIdx.x * TX + threadIdx.x);
  if (c >= C) return;
  const float a = A[c], b = B[c], cc = Cc[c], d = D[c], p = P[c], k1 = K1[c], k2 = K2[c];
  const int row0 = (int)blockIdx.y * rows_per_block;
  const int row_end = min(M, row0 + rows_per_block);
#pragma unroll 4
  for (int row = row0 + (int)threadIdx.y; row < row_end; row += TY) {
    const size_t i = (size_t)row * C + c;
    float dy, xhat;
    masked<T, RES>(g, x, r, i, a, b, cc, d, dy, xhat);
    dx[i] = from_f32<T>(__fmul_rn(p, __fsub_rn(__fsub_rn(dy, k1), __fmul_rn(xhat, k2))));
    if (RES) dres[i] = from_f32<T>(dy);
  }
}

// Runs first(dst), the reduce kernel writing its partials to dst, then, with
// more than one row range, the fixed-order sum of the partials into out.
template <typename First>
int reduce_then_sum(First first, int C, int splits, void* partial, void* out,
                    cudaStream_t s) {
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  first(dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  bn_sum_partials_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(dst, splits, 2 * C,
                                                             static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T, bool RES>
int launch_reduce(const void* g, const void* x, const void* r, const void* const* consts,
                  int M, int C, int rows_per_block, int splits, void* partial, void* out,
                  cudaStream_t s) {
  const dim3 grid((C + TX - 1) / TX, splits);
  return reduce_then_sum([&](float* dst) {
    bn_masked_reduce_kernel<T, RES><<<grid, dim3(TX, TY), 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const float*>(consts[0]), static_cast<const float*>(consts[1]),
        static_cast<const float*>(consts[2]), static_cast<const float*>(consts[3]), M, C,
        rows_per_block, dst);
  }, C, splits, partial, out, s);
}

template <typename T>
int launch_dual_reduce(const void* g, const void* x, const void* mu, const void* inv, int M,
                       int C, int rows_per_block, int splits, void* partial, void* out,
                       cudaStream_t s) {
  const dim3 grid((C + TX - 1) / TX, splits);
  return reduce_then_sum([&](float* dst) {
    bn_dual_reduce_kernel<T><<<grid, dim3(TX, TY), 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(mu),
        static_cast<const float*>(inv), M, C, rows_per_block, dst);
  }, C, splits, partial, out, s);
}

template <typename T, bool RES>
int launch_dx(const void* g, const void* x, const void* r, const void* const* consts,
              int M, int C, int rows_per_block, int blocks_y, void* dx, void* dres,
              cudaStream_t s) {
  const dim3 grid((C + TX - 1) / TX, blocks_y);
  bn_masked_dx_kernel<T, RES><<<grid, dim3(TX, TY), 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(consts[0]), static_cast<const float*>(consts[1]),
      static_cast<const float*>(consts[2]), static_cast<const float*>(consts[3]),
      static_cast<const float*>(consts[4]), static_cast<const float*>(consts[5]),
      static_cast<const float*>(consts[6]), M, C, rows_per_block, static_cast<T*>(dx),
      static_cast<T*>(dres));
  return (int)cudaGetLastError();
}

bool bad_grid(int M, int C, int rows_per_block, int blocks_y) {
  return M <= 0 || C <= 0 || rows_per_block <= 0 || blocks_y <= 0 || blocks_y > 65535 ||
         (long long)rows_per_block * blocks_y < M ||
         (long long)rows_per_block * (blocks_y - 1) >= M;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). g, x and r are
// device pointers to row-major (M, C) planes of one dtype (0: float32,
// 1: bf16); r is null without a residual. The per-channel constants are
// contiguous float32 (C,) vectors. Block row y walks rows
// [y * rows_per_block, (y + 1) * rows_per_block) of the M, and blocks_y
// blocks cover the M rows exactly.

// Replaces _masked_reduce_kernel (bn_epilogue.py:54-85, called at :134) and,
// with r, _dual_reduce_res_kernel (:246-271, called at :325). Bound by
// memory: 4 (6 with r) bytes per bf16 element. partial holds blocks_y * 2 * C
// floats (unused when blocks_y == 1); out is (2, C): [sum dy; sum dy*xhat].
int masked_dual_reduce(const void* g, const void* x, const void* r, const void* A,
                       const void* B, const void* C_, const void* D, int M, int C,
                       int dtype, int rows_per_block, int blocks_y, void* partial,
                       void* out, void* stream) {
  if (bad_grid(M, C, rows_per_block, blocks_y) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const void* consts[4] = {A, B, C_, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return r ? launch_reduce<__nv_bfloat16, true>(g, x, r, consts, M, C, rows_per_block,
                                                  blocks_y, partial, out, s)
             : launch_reduce<__nv_bfloat16, false>(g, x, r, consts, M, C, rows_per_block,
                                                   blocks_y, partial, out, s);
  return r ? launch_reduce<float, true>(g, x, r, consts, M, C, rows_per_block, blocks_y,
                                        partial, out, s)
           : launch_reduce<float, false>(g, x, r, consts, M, C, rows_per_block, blocks_y,
                                         partial, out, s);
}

// Replaces _dx_kernel (bn_epilogue.py:93-101, called at :170) and, with r,
// _dx_res_kernel (:274-284, called at :342), which also writes dres = dy.
// Bound by memory: 6 (10 with r) bytes per bf16 element. dx (and dres) are
// (M, C) planes of the inputs' dtype; dres is null without r.
int masked_dx(const void* g, const void* x, const void* r, const void* A, const void* B,
              const void* C_, const void* D, const void* P, const void* k1,
              const void* k2, int M, int C, int dtype, int rows_per_block, int blocks_y,
              void* dx, void* dres, void* stream) {
  if (bad_grid(M, C, rows_per_block, blocks_y) || dtype < 0 || dtype > 1 ||
      (r == nullptr) != (dres == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* consts[7] = {A, B, C_, D, P, k1, k2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return r ? launch_dx<__nv_bfloat16, true>(g, x, r, consts, M, C, rows_per_block,
                                              blocks_y, dx, dres, s)
             : launch_dx<__nv_bfloat16, false>(g, x, r, consts, M, C, rows_per_block,
                                               blocks_y, dx, dres, s);
  return r ? launch_dx<float, true>(g, x, r, consts, M, C, rows_per_block, blocks_y, dx,
                                    dres, s)
           : launch_dx<float, false>(g, x, r, consts, M, C, rows_per_block, blocks_y, dx,
                                     dres, s);
}

// Replaces _dual_reduce_kernel (fused_bn.py:163-180, called at :203), the
// two reduces of the plain BatchNorm backward. Bound by memory: 4 bytes per
// bf16 element. g and x as above; mu and inv are the (C,) batch mean and
// 1/sqrt(var + eps); partial and out as for masked_dual_reduce.
int dual_reduce(const void* g, const void* x, const void* mu, const void* inv, int M, int C,
                int dtype, int rows_per_block, int blocks_y, void* partial, void* out,
                void* stream) {
  if (bad_grid(M, C, rows_per_block, blocks_y) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dual_reduce<__nv_bfloat16>(g, x, mu, inv, M, C, rows_per_block, blocks_y,
                                             partial, out, s);
  return launch_dual_reduce<float>(g, x, mu, inv, M, C, rows_per_block, blocks_y, partial,
                                   out, s);
}

const char* bn_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
