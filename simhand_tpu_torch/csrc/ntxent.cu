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
// What bounds them on this card: float32 arithmetic on the CUDA cores. At
// M = N = 16384 the plain pair does 2*M*N*128 = 68.7 GFLOP of dot products
// (the gradient twice that), the weighted pair adds 21 distance terms with
// a square root for every (i, j); the bytes (inputs read once) are a few
// MB. At the training step's M = N = 512 the work is 67 MFLOP and launch
// latency sets the pace.
//
// Design. The Pallas grid walked its column axis in order and carried the
// row sums in VMEM scratch. Here a block owns BM = 64 rows, keeps them in
// shared memory, and loops over column tiles of BN = 64 itself: the
// (64 x 64) similarity tile is computed by 256 threads, 4 x 4 pairs each,
// from z tiles (and joint tiles) staged in shared memory; row sums (or the
// 64 x 128 gradient accumulator) stay in registers, and each output row is
// written once. No (M, N) plane ever reaches device memory. When the row
// blocks alone would leave SMs idle, the columns are split over gridDim.y;
// each split writes its own partial and a second small kernel adds the
// partials in a fixed order, so every sum is deterministic (no atomics).
// Arithmetic follows the Pallas kernels: float32 throughout, the distance
// sum before the *(1/21), cov * w / T, the self mask by global id. The
// distance and weight arithmetic uses the _rn intrinsics so that nvcc does
// not contract it into FMAs that the plain PyTorch version does not do.
// Ragged edges are masked, so any M and N work. A simple design: making it
// fast (tensor cores, TMA, bf16 operands) is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int D = 128;           // projection width
constexpr int BM = 64;           // rows a block owns
constexpr int BN = 64;           // columns of one tile
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 pairs each
constexpr int ZS = D + 1;        // padded shared-memory row stride of a z tile
constexpr int NJ = 21;           // joints
constexpr int JW = 2 * NJ;       // interleaved [x0, y0, x1, y1, ...]
constexpr int JS = JW + 1;       // padded stride of a joint tile
constexpr int PS = BN + 1;       // padded stride of the gradient weight tile

template <bool WEIGHTED, bool GRAD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * ZS + BN * ZS
                                  + (WEIGHTED ? (BM + BN) * JS : 0)
                                  + (GRAD ? BM * PS : 0));
}

// (BM or BN) x 128 floats from rows [start, limit) of src into a padded tile;
// rows past limit are zero.
template <int ROWS>
__device__ void load_z(float* dst, const float* __restrict__ src, int start,
                       int limit) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, c4 = idx % V;
    const int g = start + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < limit) v = reinterpret_cast<const float4*>(src + (size_t)g * D)[c4];
    float* d = dst + r * ZS + 4 * c4;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

template <int ROWS>
__device__ void load_joints(float* dst, const float* __restrict__ src,
                            int start, int limit) {
  for (int idx = threadIdx.x; idx < ROWS * JW; idx += THREADS) {
    const int r = idx / JW, q = idx % JW;
    const int g = start + r;
    dst[r * JS + q] = g < limit ? src[(size_t)g * JW + q] : 0.f;
  }
}

// One block: rows [blockIdx.x*BM, +BM) against the columns of split
// blockIdx.y. dst is (splits, M) for the denominators and (splits, M, D)
// for the gradients.
template <bool WEIGHTED, bool GRAD>
__global__ void __launch_bounds__(THREADS)
ntxent_tile_kernel(const float* __restrict__ z_rows,
                   const float* __restrict__ z_cols,
                   const float* __restrict__ j_rows,
                   const float* __restrict__ j_cols,
                   const float* __restrict__ inv_rows,
                   const float* __restrict__ inv_cols,
                   const int* __restrict__ row_ids,
                   const float* __restrict__ minmax,
                   int M, int N, float temperature, int cols_per_split,
                   float* __restrict__ dst) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zc = zr + BM * ZS;
  float* jr = zc + BN * ZS;
  float* jc = jr + (WEIGHTED ? BM * JS : 0);
  float* pt = jc + (WEIGHTED ? BN * JS : 0);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;
  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(N, col_begin + cols_per_split);

  load_z<BM>(zr, z_rows, row0, M);
  if (WEIGHTED) load_joints<BM>(jr, j_rows, row0, M);

  float d_max = 0.f, d_range = 1.f;
  if (WEIGHTED) {
    d_max = minmax[0];
    d_range = __fsub_rn(d_max, minmax[1]);
  }
  int rid[4];
  float inv_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    rid[i] = r < M ? row_ids[r] : -1;       // global ids are >= 0
    inv_r[i] = (GRAD && r < M) ? inv_rows[r] : 0.f;
  }

  float rowsum[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = col_begin; c0 < col_end; c0 += BN) {
    __syncthreads();                         // the previous tile is consumed
    load_z<BN>(zc, z_cols, c0, col_end);
    if (WEIGHTED) load_joints<BN>(jc, j_cols, c0, col_end);
    __syncthreads();

    float cov[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cov[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < D; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = zr[(ty + 16 * i) * ZS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = zc[(tx + 16 * j) * ZS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cov[i][j] = fmaf(a[i], b[j], cov[i][j]);
    }

    float w[4][4];
    if (WEIGHTED) {
      float dist[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dist[i][j] = 0.f;
      for (int k = 0; k < NJ; ++k) {
        float ax[4], ay[4], bx[4], by[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ax[i] = jr[(ty + 16 * i) * JS + 2 * k];
          ay[i] = jr[(ty + 16 * i) * JS + 2 * k + 1];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bx[j] = jc[(tx + 16 * j) * JS + 2 * k];
          by[j] = jc[(tx + 16 * j) * JS + 2 * k + 1];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dx = __fsub_rn(ax[i], bx[j]);
            const float dy = __fsub_rn(ay[i], by[j]);
            const float sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            dist[i][j] = __fadd_rn(dist[i][j], __fsqrt_rn(sq));
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[i][j] = __fdiv_rn(
              __fsub_rn(d_max, __fmul_rn(dist[i][j], 1.0f / 21.0f)), d_range);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      const bool valid = c < col_end;
      const float inv_c = (GRAD && valid) ? inv_cols[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.f;
        if (valid && c != rid[i]) {
          if (WEIGHTED) {
            const float e = expf(__fdiv_rn(__fmul_rn(cov[i][j], w[i][j]), temperature));
            v = GRAD ? __fmul_rn(__fmul_rn(e, w[i][j]), __fadd_rn(inv_r[i], inv_c)) : e;
          } else {
            const float e = expf(__fdiv_rn(cov[i][j], temperature));
            v = GRAD ? __fmul_rn(e, __fadd_rn(inv_r[i], inv_c)) : e;
          }
        }
        if (GRAD) pt[(ty + 16 * i) * PS + tx + 16 * j] = v;
        else rowsum[i] += v;
      }
    }

    if (GRAD) {
      __syncthreads();                       // the weight tile is complete
      const int ncols = min(BN, col_end - c0);
      for (int c = 0; c < ncols; ++c) {
        float p[4], zv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = pt[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) zv[j] = zc[c * ZS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], zv[j], acc[i][j]);
      }
    }
  }

  if (GRAD) {
    float* out = dst + (size_t)blockIdx.y * M * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r < M) {
#pragma unroll
        for (int j = 0; j < 8; ++j) out[(size_t)r * D + tx + 16 * j] = acc[i][j];
      }
    }
  } else {
    // the 16 threads that share a row are 16 neighbouring lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], off);
    if (tx == 0) {
      float* out = dst + (size_t)blockIdx.y * M;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty + 16 * i;
        if (r < M) out[r] = rowsum[i];
      }
    }
  }
}

// out[i] = sum over splits s, in order, of partial[s * count + i]
__global__ void sum_splits_kernel(const float* __restrict__ partial, int splits,
                                  int64_t count, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * count + i];
  out[i] = s;
}

template <bool WEIGHTED, bool GRAD>
int launch(const void* z_rows, const void* z_cols, const void* j_rows,
           const void* j_cols, const void* inv_rows, const void* inv_cols,
           const void* row_ids, const void* minmax, int M, int N,
           float temperature, int splits, void* partial, void* out,
           void* stream) {
  if (M <= 0 || N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = smem_bytes<WEIGHTED, GRAD>();
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_tile_kernel<WEIGHTED, GRAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const int tiles = (N + BN - 1) / BN;
  const int cols_per_split = (tiles + splits - 1) / splits * BN;
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  const dim3 grid((M + BM - 1) / BM, splits);
  ntxent_tile_kernel<WEIGHTED, GRAD><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(z_rows), static_cast<const float*>(z_cols),
      static_cast<const float*>(j_rows), static_cast<const float*>(j_cols),
      static_cast<const float*>(inv_rows), static_cast<const float*>(inv_cols),
      static_cast<const int*>(row_ids), static_cast<const float*>(minmax),
      M, N, temperature, cols_per_split, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  const int64_t count = GRAD ? (int64_t)M * D : (int64_t)M;
  sum_splits_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      dst, splits, count, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success). Pointers are
// device pointers to contiguous float32 (row_ids: int32) tensors; z tensors
// are 16-byte aligned with 128 columns; joints are (rows, 42); minmax is
// [d_max, d_min]; partial holds splits * M (denominators) or
// splits * M * 128 (gradients) floats and is unused when splits == 1.

// Replaces _ntxent_denom_kernel (pallas_ntxent.py:46-72, called at :88).
// float32 FMA-bound at large N (2*128 flops per pair). At the step's
// 512 x 512 the column split gives 8 x 8 = 64 blocks, fewer than the SMs.
int ntxent_denominator(const void* z_rows, const void* z_cols,
                       const void* row_ids, int M, int N, float temperature,
                       int splits, void* partial, void* out, void* stream) {
  return launch<false, false>(z_rows, z_cols, nullptr, nullptr, nullptr,
                              nullptr, row_ids, nullptr, M, N, temperature,
                              splits, partial, out, stream);
}

// Replaces _weighted_denom_kernel (pallas_ntxent.py:109-150, called at
// :177). Bound by float32 issue: the 21 joint distances per pair with a
// correctly rounded sqrt cost more than the dot product; the weights are
// recomputed per tile and never stored.
int weighted_ntxent_denominator(const void* z_rows, const void* z_cols,
                                const void* j_rows, const void* j_cols,
                                const void* row_ids, const void* minmax,
                                int M, int N, float temperature, int splits,
                                void* partial, void* out, void* stream) {
  return launch<true, false>(z_rows, z_cols, j_rows, j_cols, nullptr, nullptr,
                             row_ids, minmax, M, N, temperature, splits,
                             partial, out, stream);
}

// Replaces _ntxent_grad_kernel (pallas_ntxent.py:204-232, called at :244).
// Twice #1's float32 work (similarity, then P @ Z); the (64 x 128)
// accumulator stays in registers and P in shared memory, one tile at a time.
int ntxent_grad(const void* z_rows, const void* z_cols, const void* inv_rows,
                const void* inv_cols, const void* row_ids, int M, int N,
                float temperature, int splits, void* partial, void* out,
                void* stream) {
  return launch<false, true>(z_rows, z_cols, nullptr, nullptr, inv_rows,
                             inv_cols, row_ids, nullptr, M, N, temperature,
                             splits, partial, out, stream);
}

// Replaces _weighted_grad_kernel (pallas_ntxent.py:316-360, called at :608).
// #3's work plus #2's weight recomputation; same bound as #2 plus the second
// product.
int weighted_grad_rows(const void* z_rows, const void* z_cols,
                       const void* j_rows, const void* j_cols,
                       const void* inv_rows, const void* inv_cols,
                       const void* row_ids, const void* minmax, int M, int N,
                       float temperature, int splits, void* partial,
                       void* out, void* stream) {
  return launch<true, true>(z_rows, z_cols, j_rows, j_cols, inv_rows,
                            inv_cols, row_ids, minmax, M, N, temperature,
                            splits, partial, out, stream);
}

const char* ntxent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
