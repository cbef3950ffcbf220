// BatchNorm backward kernels for Hopper (sm_90a), bf16 or float32 planes:
// the fused BatchNorm + ReLU backward, with and without a residual, and the
// two reduces of the plain BatchNorm backward.
//
// Replaces the four Pallas TPU kernels of simhand_tpu/models/bn_epilogue.py:
//   masked_dual_reduce      <- masked_dual_reduce / _masked_reduce_kernel      (#5)
//   masked_dx               <- masked_dx / _dx_kernel                          (#6)
//   masked_dual_reduce_res  <- _bn_add_relu_bwd / _dual_reduce_res_kernel      (#7)
//   masked_dx_res           <- _bn_add_relu_bwd / _dx_res_kernel               (#8)
// and the one of simhand_tpu/models/fused_bn.py:
//   dual_reduce             <- bn_backward_reduces / _dual_reduce_kernel       (#9)
//
// What they compute, per channel c of the row-major (M, C) planes g, x and
// (#7) r, with float32 per-channel constants read from the card:
//   y    = A x + B (+ r)           the forward's pre-activation, in float32
//   dy   = y > 0 ? g : 0           the ReLU mask, recomputed
//   xhat = C x + D
//   #5, #7:  sum_rows dy, sum_rows dy * xhat            -> (2, C) float32
//   #7:      dres = dy in the planes' dtype (dy is g or 0: no rounding)
//   #6:      dx = P (dy - k1 - xhat k2) in the planes' dtype
//   #8:      the same dx with dy read back from dres: no g, r, A or B
// dual_reduce takes no mask: dy = g and xhat = (x - mu) * inv (subtract,
// then multiply, as fused_bn.py does), with mu and inv float32 vectors.
// Every product and sum is a separately rounded float32 operation
// (__fmul_rn / __fadd_rn / __fsub_rn) in the order of the plain PyTorch
// version, so that nvcc contracts nothing into an FMA: the mask, dx and
// dres equal the plain version's bit for bit.
//
// What bounds them on this card: memory. Each element costs a handful of
// float32 operations against 4 to 8 bytes of bf16 traffic, far below the
// card's operations-per-byte balance. The residual pair moves 7 planes, the
// least a two-pass design can: #7 reads g, x and r and writes dres (4
// planes), #8 reads dres and x and writes dx (3). At layer1-bn3 of the
// ResNet-50 step (524,288 x 256, bf16) that is 0.3205 + 0.2404 ms at
// 3.35 TB/s. #5 and #9 read two planes, g and x: 0.1603 ms at the stem
// (2,097,152 x 64, bf16).
//
// #5-#9, designed for Hopper:
// - A persistent grid (two CTAs an SM, from the wrapper) in which each CTA
//   takes one contiguous share of the rows: its bytes of every plane are one
//   span, read once, front to back.
// - A ring of stages in shared memory (8 KB of each plane a stage; 4 stages
//   for #7's three planes, 6 for the two planes of #5, #6, #8 and #9) filled
//   by 1-D bulk copies (cp.async.bulk, no tensor map, so the host encodes
//   nothing). A ninth warp produces: one thread waits for a free stage,
//   posts its bytes on the stage's full barrier and issues one copy a plane.
//   Up to 192 KB an SM is in flight.
// - 256 consumer threads; each owns 8 consecutive channels (one 16-byte
//   vector of bf16, two of float32) at a fixed offset of every row, since C
//   divides 2,048 (every ResNet site, 64-2,048), and so keeps its channels'
//   constants and, in the reduces, its 16 running sums in registers (#6
//   holds the most: seven constants of 8 channels, 56 registers). A warp
//   reads a stage's rows as 512 contiguous bytes and writes dres or dx with
//   16-byte stores: whole 128-byte lines. Stores need no wait, so the ring's
//   next loads overlap them.
// - One reduce kernel serves #5 and #9, templated on its per-element terms
//   (MaskedTerms, CenteredTerms); #7 is its three-plane sibling with dres.
//   One dx kernel serves #6 and #8, templated on how it gets dy (MaskedDy:
//   from g under the mask recomputed from x; StoredDy: read back from dres).
//   A reduce adds the sums of the threads that share channels through
//   shared memory, row lane after row lane, writes one partial per CTA, and
//   a second kernel (bn_sum_ctas_kernel<n>, one instance per reduce #n)
//   adds the CTAs' partials in their order (sixteen row lanes of CTAs, then
//   the lanes in order): a second launch gives the same bits, and no
//   atomics are used. A last-CTA ticket would leave one CTA reading every
//   partial: 264 x 2C floats, 4.3 MB at layer4 (C = 2,048).
// - Any other shape or address (C not dividing 2,048, a row wider than a
//   stage, a base pointer that is not 16-byte aligned) takes a plain
//   per-element walk of the same CTA's rows inside the same kernels: thread
//   t owns channels t, t + 256, ... (bn_ring_fits says which).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- kernels #5-#9: the ring ---------------------------------------

constexpr int RES_THREADS = 256;                 // consumers: 8 warps
constexpr int RES_WARPS = RES_THREADS / 32;
constexpr int SPAN = RES_THREADS * 8;            // channels of one row lane of a CTA
constexpr int STAGE_PLANE = 8192;                // bytes of a plane in a stage
constexpr int SUM_LANES = 16;                    // row lanes of the partials' sum

template <int PLANES, int N>
struct Ring {
  static constexpr int STAGES = N;
  static constexpr int BYTES = STAGES * PLANES * STAGE_PLANE;
  static constexpr int SMEM = BYTES + 2 * 8 * STAGES;   // the stages, full and empty barriers
};
using ResRing = Ring<3, 4>;     // #7: g, x, r
using PairRing = Ring<2, 6>;    // #5 and #9: g, x; #6: g, x; #8: dres, x
static_assert(ResRing::BYTES >= 2 * SPAN * 4 && PairRing::BYTES >= 2 * SPAN * 4,
              "the drained ring holds the reduces' cross-lane sums");

// 8 consecutive values at p (16-byte aligned) as float32, and back
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x, v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Streams the CTA's rows [row0, row0 + rows) of the PLANES row-major (M, C)
// planes src through the ring at smem. The producer warp (the last) returns
// false at once; one of its threads keeps the ring full. Each consumer thread
// calls body(stage, first, n) for every stage in order, with stage[p] the
// stage's rows of plane p, which are rows [first, first + n) of the plane,
// then returns true once every stage has been consumed.
template <typename T, int PLANES, typename R, typename Body>
__device__ __forceinline__ bool ring_rows(uint8_t* smem, const T* const (&src)[PLANES], int C,
                                          int row0, int rows, Body body) {
  constexpr int STAGES = R::STAGES;
  const int stage_rows = STAGE_PLANE / (C * (int)sizeof(T));
  const int n_stages = (rows + stage_rows - 1) / stage_rows;
  const uint32_t full0 = smem_u32(smem + R::BYTES), empty0 = full0 + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, RES_WARPS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= RES_THREADS) {
    if (threadIdx.x == RES_THREADS) {
      for (int k = 0; k < n_stages; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(empty0 + 8 * s, (k / STAGES - 1) & 1);
        const int first = row0 + k * stage_rows;
        const uint32_t bytes = (uint32_t)(min(stage_rows, row0 + rows - first) * C * (int)sizeof(T));
        mbar_expect_tx(full0 + 8 * s, PLANES * bytes);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          bulk_load(smem_u32(smem + (s * PLANES + p) * STAGE_PLANE), src[p] + (size_t)first * C,
                    bytes, full0 + 8 * s);
      }
    }
    return false;
  }
  for (int k = 0; k < n_stages; ++k) {
    const int s = k % STAGES;
    mbar_wait(full0 + 8 * s, (k / STAGES) & 1);
    const T* stage[PLANES];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
      stage[p] = reinterpret_cast<const T*>(smem + (s * PLANES + p) * STAGE_PLANE);
    const int first = row0 + k * stage_rows;
    body(stage, first, min(stage_rows, row0 + rows - first));
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }
  return true;
}

// The consumers' row lanes' sums of each channel, added lane after lane
// through the drained ring (red[q][lane][c], q = 0 for sum dy, 1 for sum
// dy * xhat), written as the CTA's (2, C) partial dst.
__device__ __forceinline__ void lane_sums(uint8_t* smem, int C, int lane, int lanes, int c0,
                                          const float (&sdy)[8], const float (&sdyx)[8],
                                          float* __restrict__ dst) {
  float* red = reinterpret_cast<float*>(smem);
  named_sync(1, RES_THREADS);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[lane * C + c0 + j] = sdy[j];
    red[SPAN + lane * C + c0 + j] = sdyx[j];
  }
  named_sync(1, RES_THREADS);
  for (int i = (int)threadIdx.x; i < 2 * C; i += RES_THREADS) {
    const int q = i / C, c = i - q * C;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, red[q * SPAN + l * C + c]);
    dst[i] = s;
  }
}

// The per-channel float32 constants of a reduce, (C,) vectors
struct Consts {
  const float* v[4];
};

// #5's terms: dy = g where A x + B > 0, else 0; xhat = C x + D; k = {A, B, C, D}
struct MaskedTerms {
  static constexpr int K = 4;
  __device__ static __forceinline__ void of(float g, float x, const float* k, float& dy,
                                            float& xhat) {
    const float y = __fadd_rn(__fmul_rn(x, k[0]), k[1]);
    dy = y > 0.f ? g : 0.f;
    xhat = __fadd_rn(__fmul_rn(x, k[2]), k[3]);
  }
};

// #9's terms: no mask; dy = g, xhat = (x - mu) * inv; k = {mu, inv}
struct CenteredTerms {
  static constexpr int K = 2;
  __device__ static __forceinline__ void of(float g, float x, const float* k, float& dy,
                                            float& xhat) {
    dy = g;
    xhat = __fmul_rn(__fsub_rn(x, k[0]), k[1]);
  }
};

// Kernels #5 and #9: sum dy and sum dy * xhat of the CTA's rows [blockIdx.x
// * rows_per_cta, +rows_per_cta) of g and x, Terms giving each element's
// dy and xhat; writes the CTA's partial, dst = partial + (bx, 2, C).
template <typename T, typename Terms>
__global__ void __launch_bounds__(RES_THREADS + 32, 2)
bn_ring_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x, Consts k, int M, int C,
                      int rows_per_cta, int use_ring, float* __restrict__ partial) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int K = Terms::K;
  const int row0 = (int)blockIdx.x * rows_per_cta;
  const int rows = min(M, row0 + rows_per_cta) - row0;
  float* __restrict__ dst = partial + (size_t)blockIdx.x * 2 * C;

  if (!use_ring) {
    // the plain per-element walk of the same rows
    if (threadIdx.x >= RES_THREADS) return;
    for (int c = (int)threadIdx.x; c < C; c += RES_THREADS) {
      float kc[K];
#pragma unroll
      for (int q = 0; q < K; ++q) kc[q] = k.v[q][c];
      float sdy = 0.f, sdyx = 0.f;
#pragma unroll 4
      for (int row = row0; row < row0 + rows; ++row) {
        const size_t i = (size_t)row * C + c;
        float dy, xhat;
        Terms::of(to_f32(g[i]), to_f32(x[i]), kc, dy, xhat);
        sdy = __fadd_rn(sdy, dy);
        sdyx = __fadd_rn(sdyx, __fmul_rn(dy, xhat));
      }
      dst[c] = sdy;
      dst[C + c] = sdyx;
    }
    return;
  }

  const int groups = C / 8, lanes = RES_THREADS / groups;
  const int lane = (int)threadIdx.x / groups, c0 = ((int)threadIdx.x % groups) * 8;
  float kc[8][K], sdy[8], sdyx[8];
  if (threadIdx.x < RES_THREADS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < K; ++q) kc[j][q] = k.v[q][c0 + j];
      sdy[j] = 0.f, sdyx[j] = 0.f;
    }
  }
  const T* const src[2] = {g, x};
  const bool consumer = ring_rows<T, 2, PairRing>(
      smem, src, C, row0, rows, [&](const T* const* st, int, int n) {
#pragma unroll 2
        for (int row = lane; row < n; row += lanes) {
          const int off = row * C + c0;
          float gv[8], xv[8];
          load8(st[0] + off, gv);
          load8(st[1] + off, xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float dy, xhat;
            Terms::of(gv[j], xv[j], kc[j], dy, xhat);
            sdy[j] = __fadd_rn(sdy[j], dy);
            sdyx[j] = __fadd_rn(sdyx[j], __fmul_rn(dy, xhat));
          }
        }
      });
  if (consumer) lane_sums(smem, C, lane, lanes, c0, sdy, sdyx, dst);
}

// Kernel #7. The CTA's rows are [blockIdx.x * rows_per_cta, +rows_per_cta);
// it writes their dres and its two partial sums, dst = partial + (bx, 2, C).
template <typename T>
__global__ void __launch_bounds__(RES_THREADS + 32, 2)
bn_res_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x, const T* __restrict__ r,
                     const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ Cc, const float* __restrict__ D, int M, int C,
                     int rows_per_cta, int use_ring, T* __restrict__ dres,
                     float* __restrict__ partial) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int row0 = (int)blockIdx.x * rows_per_cta;
  const int rows = min(M, row0 + rows_per_cta) - row0;
  float* __restrict__ dst = partial + (size_t)blockIdx.x * 2 * C;

  if (!use_ring) {
    // the plain per-element walk of the same rows
    if (threadIdx.x >= RES_THREADS) return;
    for (int c = (int)threadIdx.x; c < C; c += RES_THREADS) {
      const float a = A[c], b = B[c], cc = Cc[c], d = D[c];
      float sdy = 0.f, sdyx = 0.f;
#pragma unroll 4
      for (int row = row0; row < row0 + rows; ++row) {
        const size_t i = (size_t)row * C + c;
        const float xv = to_f32(x[i]);
        const float y = __fadd_rn(__fadd_rn(__fmul_rn(xv, a), b), to_f32(r[i]));
        const float dy = y > 0.f ? to_f32(g[i]) : 0.f;
        const float xhat = __fadd_rn(__fmul_rn(xv, cc), d);
        sdy = __fadd_rn(sdy, dy);
        sdyx = __fadd_rn(sdyx, __fmul_rn(dy, xhat));
        dres[i] = from_f32<T>(dy);
      }
      dst[c] = sdy;
      dst[C + c] = sdyx;
    }
    return;
  }

  const int groups = C / 8, lanes = RES_THREADS / groups;
  const int lane = (int)threadIdx.x / groups, c0 = ((int)threadIdx.x % groups) * 8;
  float a[8], b[8], cc[8], d[8], sdy[8], sdyx[8];
  if (threadIdx.x < RES_THREADS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = A[c0 + j], b[j] = B[c0 + j], cc[j] = Cc[c0 + j], d[j] = D[c0 + j];
      sdy[j] = 0.f, sdyx[j] = 0.f;
    }
  }
  const T* const src[3] = {g, x, r};
  const bool consumer = ring_rows<T, 3, ResRing>(
      smem, src, C, row0, rows, [&](const T* const* st, int first, int n) {
#pragma unroll 2
        for (int row = lane; row < n; row += lanes) {
          const int off = row * C + c0;
          float gv[8], xv[8], rv[8], dy[8];
          load8(st[0] + off, gv);
          load8(st[1] + off, xv);
          load8(st[2] + off, rv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float y = __fadd_rn(__fadd_rn(__fmul_rn(xv[j], a[j]), b[j]), rv[j]);
            dy[j] = y > 0.f ? gv[j] : 0.f;
            const float xhat = __fadd_rn(__fmul_rn(xv[j], cc[j]), d[j]);
            sdy[j] = __fadd_rn(sdy[j], dy[j]);
            sdyx[j] = __fadd_rn(sdyx[j], __fmul_rn(dy[j], xhat));
          }
          store8(dres + (size_t)(first + row) * C + c0, dy);
        }
      });
  if (consumer) lane_sums(smem, C, lane, lanes, c0, sdy, sdyx, dst);
}

// The per-channel float32 constants of a dx kernel, (C,) vectors
struct DxConsts {
  const float* v[7];
};

// #6's dy: g where A x + B > 0, else 0; k = {A, B, C, D, P, k1, k2}
struct MaskedDy {
  static constexpr int K = 7, XHAT = 2;   // k[XHAT..] = {C, D, P, k1, k2}
  __device__ static __forceinline__ float of(float g, float x, const float* k) {
    return __fadd_rn(__fmul_rn(x, k[0]), k[1]) > 0.f ? g : 0.f;
  }
};

// #8's dy: read back from dres, which #7 wrote; k = {C, D, P, k1, k2}
struct StoredDy {
  static constexpr int K = 5, XHAT = 0;
  __device__ static __forceinline__ float of(float dres, float, const float*) { return dres; }
};

// dx = P (dy - k1 - xhat k2), xhat = C x + D, from the constants k[XHAT..]
template <typename Dy>
__device__ __forceinline__ float dx_of(float src, float x, const float* k) {
  const float* q = k + Dy::XHAT;
  const float xhat = __fadd_rn(__fmul_rn(x, q[0]), q[1]);
  return __fmul_rn(q[2], __fsub_rn(__fsub_rn(Dy::of(src, x, k), q[3]), __fmul_rn(xhat, q[4])));
}

// Kernels #6 and #8: dx of the CTA's rows [blockIdx.x * rows_per_cta,
// +rows_per_cta) from src (#6: g; #8: dres) and x, Dy giving each element's
// dy.
template <typename T, typename Dy>
__global__ void __launch_bounds__(RES_THREADS + 32, 2)
bn_ring_dx_kernel(const T* __restrict__ src, const T* __restrict__ x, DxConsts k, int M, int C,
                  int rows_per_cta, int use_ring, T* __restrict__ dx) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int K = Dy::K;
  const int row0 = (int)blockIdx.x * rows_per_cta;
  const int rows = min(M, row0 + rows_per_cta) - row0;

  if (!use_ring) {
    // the plain per-element walk of the same rows
    if (threadIdx.x >= RES_THREADS) return;
    for (int c = (int)threadIdx.x; c < C; c += RES_THREADS) {
      float kc[K];
#pragma unroll
      for (int q = 0; q < K; ++q) kc[q] = k.v[q][c];
#pragma unroll 4
      for (int row = row0; row < row0 + rows; ++row) {
        const size_t i = (size_t)row * C + c;
        dx[i] = from_f32<T>(dx_of<Dy>(to_f32(src[i]), to_f32(x[i]), kc));
      }
    }
    return;
  }

  const int groups = C / 8, lanes = RES_THREADS / groups;
  const int lane = (int)threadIdx.x / groups, c0 = ((int)threadIdx.x % groups) * 8;
  float kc[8][K];
  if (threadIdx.x < RES_THREADS) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < K; ++q) kc[j][q] = k.v[q][c0 + j];
  }
  const T* const planes[2] = {src, x};
  ring_rows<T, 2, PairRing>(smem, planes, C, row0, rows,
                            [&](const T* const* st, int first, int n) {
#pragma unroll 2
    for (int row = lane; row < n; row += lanes) {
      const int off = row * C + c0;
      float sv[8], xv[8], out[8];
      load8(st[0] + off, sv);
      load8(st[1] + off, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = dx_of<Dy>(sv[j], xv[j], kc[j]);
      store8(dx + (size_t)(first + row) * C + c0, out);
    }
  });
}

// out[i] = sum over the splits s of partial[s * count + i] in a fixed order:
// row lane ly of a block adds splits ly, ly + SUM_LANES, ... in order, then
// lane 0 adds the lanes' sums in order. One instance per reduce #N, so that
// a profile tells the three sum passes apart.
template <int N>
__global__ void __launch_bounds__(32 * SUM_LANES)
bn_sum_ctas_kernel(const float* __restrict__ partial, int splits, int count,
                   float* __restrict__ out) {
  __shared__ float part[SUM_LANES][32];
  const int i = (int)(blockIdx.x * 32 + threadIdx.x);
  float s = 0.f;
  if (i < count) {
#pragma unroll 4
    for (int k = (int)threadIdx.y; k < splits; k += SUM_LANES)
      s = __fadd_rn(s, partial[(size_t)k * count + i]);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < count) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < SUM_LANES; ++l) t = __fadd_rn(t, part[l][threadIdx.x]);
    out[i] = t;
  }
}

// After a reduce's launch into dst: with more than one CTA, #N's sum pass
// of the CTAs' partials into out
template <int N>
int sum_ctas(float* dst, int ctas, int C, void* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ctas == 1) return (int)err;
  bn_sum_ctas_kernel<N><<<(2 * C + 31) / 32, dim3(32, SUM_LANES), 0, s>>>(
      dst, ctas, 2 * C, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// the ring's shapes: 8 channels a thread at a fixed offset of every row,
// 16-byte aligned rows and bases
template <typename T>
bool ring_fits(int C, std::initializer_list<const void*> ptrs) {
  if (C % 8 != 0 || SPAN % C != 0 || C * (int)sizeof(T) > STAGE_PLANE) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// raises the kernel's dynamic shared memory to smem and asks for the largest
// carve-out, once per device
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// #5 (MaskedTerms) or #9 (CenteredTerms), then its sum pass #N
template <typename T, typename Terms, int N>
int launch_ring_reduce(const void* g, const void* x, Consts k, int M, int C, int rows_per_cta,
                       int ctas, void* partial, void* out, cudaStream_t s) {
  static bool done[64] = {};
  const auto kernel = bn_ring_reduce_kernel<T, Terms>;
  const bool ring = ring_fits<T>(C, {g, x});
  if (ring) {
    const cudaError_t err = prepare(kernel, PairRing::SMEM, done);
    if (err != cudaSuccess) return (int)err;
  }
  float* dst = static_cast<float*>(ctas == 1 ? out : partial);
  kernel<<<ctas, RES_THREADS + 32, ring ? PairRing::SMEM : 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), k, M, C, rows_per_cta, ring ? 1 : 0,
      dst);
  return sum_ctas<N>(dst, ctas, C, out, s);
}

template <typename T>
int launch_res_reduce(const void* g, const void* x, const void* r, const void* const* consts,
                      int M, int C, int rows_per_cta, int ctas, void* partial, void* out,
                      void* dres, cudaStream_t s) {
  static bool done[64] = {};
  const auto kernel = bn_res_reduce_kernel<T>;
  const bool ring = ring_fits<T>(C, {g, x, r, dres});
  if (ring) {
    const cudaError_t err = prepare(kernel, ResRing::SMEM, done);
    if (err != cudaSuccess) return (int)err;
  }
  float* dst = static_cast<float*>(ctas == 1 ? out : partial);
  kernel<<<ctas, RES_THREADS + 32, ring ? ResRing::SMEM : 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const float*>(consts[0]), static_cast<const float*>(consts[1]),
      static_cast<const float*>(consts[2]), static_cast<const float*>(consts[3]), M, C,
      rows_per_cta, ring ? 1 : 0, static_cast<T*>(dres), dst);
  return sum_ctas<7>(dst, ctas, C, out, s);
}

// #6 (MaskedDy, src = g) or #8 (StoredDy, src = dres)
template <typename T, typename Dy>
int launch_ring_dx(const void* src, const void* x, const void* const* consts, int M, int C,
                   int rows_per_cta, int ctas, void* dx, cudaStream_t s) {
  static bool done[64] = {};
  const auto kernel = bn_ring_dx_kernel<T, Dy>;
  const bool ring = ring_fits<T>(C, {src, x, dx});
  if (ring) {
    const cudaError_t err = prepare(kernel, PairRing::SMEM, done);
    if (err != cudaSuccess) return (int)err;
  }
  DxConsts k = {};
  for (int q = 0; q < Dy::K; ++q) k.v[q] = static_cast<const float*>(consts[q]);
  kernel<<<ctas, RES_THREADS + 32, ring ? PairRing::SMEM : 0, s>>>(
      static_cast<const T*>(src), static_cast<const T*>(x), k, M, C, rows_per_cta,
      ring ? 1 : 0, static_cast<T*>(dx));
  return (int)cudaGetLastError();
}

// a persistent grid of `ctas` contiguous row shares covering the M rows
bool bad_persistent_grid(int M, int C, int rows_per_cta, int ctas) {
  return M <= 0 || C <= 0 || rows_per_cta <= 0 || ctas <= 0 ||
         (long long)rows_per_cta * ctas < M || (long long)rows_per_cta * (ctas - 1) >= M;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). g, x, r, dres and
// dx are device pointers to row-major (M, C) planes of one dtype (0:
// float32, 1: bf16). The per-channel constants are contiguous float32 (C,)
// vectors. CTA i walks rows [i * rows_per_cta, (i + 1) * rows_per_cta),
// and ctas CTAs cover the M rows exactly. partial holds ctas * 2 *
// C floats (unused when ctas is 1); out is (2, C): [sum dy; sum dy*xhat].

// Kernel #5. Replaces _masked_reduce_kernel (bn_epilogue.py:54-85, called
// at :134). Bound by memory: 4 bytes per bf16 element (g, x).
int masked_dual_reduce(const void* g, const void* x, const void* A, const void* B,
                       const void* C_, const void* D, int M, int C, int dtype,
                       int rows_per_cta, int ctas, void* partial, void* out, void* stream) {
  if (bad_persistent_grid(M, C, rows_per_cta, ctas) || dtype < 0 || dtype > 1 || !g || !x)
    return (int)cudaErrorInvalidValue;
  const Consts k = {{static_cast<const float*>(A), static_cast<const float*>(B),
                     static_cast<const float*>(C_), static_cast<const float*>(D)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ring_reduce<__nv_bfloat16, MaskedTerms, 5>(g, x, k, M, C, rows_per_cta, ctas,
                                                             partial, out, s);
  return launch_ring_reduce<float, MaskedTerms, 5>(g, x, k, M, C, rows_per_cta, ctas, partial,
                                                   out, s);
}

// Kernel #6. Replaces _dx_kernel (bn_epilogue.py:93-101, called at :170).
// Bound by memory: 6 bytes per bf16 element (g, x; dx).
int masked_dx(const void* g, const void* x, const void* A, const void* B, const void* C_,
              const void* D, const void* P, const void* k1, const void* k2, int M, int C,
              int dtype, int rows_per_cta, int ctas, void* dx, void* stream) {
  if (bad_persistent_grid(M, C, rows_per_cta, ctas) || dtype < 0 || dtype > 1 || !g || !x ||
      !dx)
    return (int)cudaErrorInvalidValue;
  const void* consts[7] = {A, B, C_, D, P, k1, k2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ring_dx<__nv_bfloat16, MaskedDy>(g, x, consts, M, C, rows_per_cta, ctas, dx,
                                                   s);
  return launch_ring_dx<float, MaskedDy>(g, x, consts, M, C, rows_per_cta, ctas, dx, s);
}

// Kernel #7. Replaces _dual_reduce_res_kernel (bn_epilogue.py:246-271,
// called at :325) and writes dres = dy, which _dx_res_kernel (:274-284)
// recomputed. Bound by memory: 8 bytes per bf16 element (g, x, r; dres).
int masked_dual_reduce_res(const void* g, const void* x, const void* r, const void* A,
                           const void* B, const void* C_, const void* D, int M, int C,
                           int dtype, int rows_per_cta, int ctas, void* partial, void* out,
                           void* dres, void* stream) {
  if (bad_persistent_grid(M, C, rows_per_cta, ctas) || dtype < 0 || dtype > 1 || !g || !x ||
      !r || !dres)
    return (int)cudaErrorInvalidValue;
  const void* consts[4] = {A, B, C_, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_res_reduce<__nv_bfloat16>(g, x, r, consts, M, C, rows_per_cta, ctas,
                                            partial, out, dres, s);
  return launch_res_reduce<float>(g, x, r, consts, M, C, rows_per_cta, ctas, partial, out,
                                  dres, s);
}

// Kernel #8. Replaces _dx_res_kernel (bn_epilogue.py:274-284, called at
// :342), less the dres that #7 wrote: dx from dres and x alone. Bound by
// memory: 6 bytes per bf16 element (dres, x; dx).
int masked_dx_res(const void* dres, const void* x, const void* C_, const void* D,
                  const void* P, const void* k1, const void* k2, int M, int C, int dtype,
                  int rows_per_cta, int ctas, void* dx, void* stream) {
  if (bad_persistent_grid(M, C, rows_per_cta, ctas) || dtype < 0 || dtype > 1 || !dres ||
      !x || !dx)
    return (int)cudaErrorInvalidValue;
  const void* consts[5] = {C_, D, P, k1, k2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ring_dx<__nv_bfloat16, StoredDy>(dres, x, consts, M, C, rows_per_cta, ctas,
                                                   dx, s);
  return launch_ring_dx<float, StoredDy>(dres, x, consts, M, C, rows_per_cta, ctas, dx, s);
}

// Kernel #9. Replaces _dual_reduce_kernel (fused_bn.py:163-180, called at
// :203), the two reduces of the plain BatchNorm backward. Bound by memory:
// 4 bytes per bf16 element (g, x). g and x as above; mu and inv are the
// (C,) batch mean and 1/sqrt(var + eps); partial and out as for
// masked_dual_reduce.
int dual_reduce(const void* g, const void* x, const void* mu, const void* inv, int M, int C,
                int dtype, int rows_per_cta, int ctas, void* partial, void* out,
                void* stream) {
  if (bad_persistent_grid(M, C, rows_per_cta, ctas) || dtype < 0 || dtype > 1 || !g || !x)
    return (int)cudaErrorInvalidValue;
  const Consts k = {{static_cast<const float*>(mu), static_cast<const float*>(inv), nullptr,
                     nullptr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ring_reduce<__nv_bfloat16, CenteredTerms, 9>(g, x, k, M, C, rows_per_cta,
                                                               ctas, partial, out, s);
  return launch_ring_reduce<float, CenteredTerms, 9>(g, x, k, M, C, rows_per_cta, ctas,
                                                     partial, out, s);
}

// 1 when #5-#9 take the bulk-copy ring for C channels of the
// dtype with the n planes at ptrs (their bases), 0 when they take the
// per-element walk
int bn_ring_fits(int C, int dtype, const void* const* ptrs, int n) {
  bool fits = dtype == 1 ? ring_fits<__nv_bfloat16>(C, {}) : ring_fits<float>(C, {});
  for (int i = 0; i < n; ++i) fits = fits && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return fits ? 1 : 0;
}

const char* bn_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
