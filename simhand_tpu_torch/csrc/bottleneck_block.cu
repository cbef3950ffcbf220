// One whole frozen (BatchNorm-folded) ResNet identity bottleneck block in one
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of simhand_tpu/ops/bottleneck_block.py:
//   bottleneck_block  <- bottleneck_block (:92, pallas_call :131,
//                        body _block_kernel :46-89)
//
// What it computes, for x the row-major (M, C) bf16 plane of a channels-last
// activation, M = B*H*W image-major, and the weights K-contiguous (each row
// of a weight holds one output channel):
//   h1 = bf16(relu(x @ w1^T + b1))                                 (M, Cm)
//   h2 = bf16(relu(sum_t mask_t(shift_t(h1)) @ w2[:, t, :]^T + b2))  (M, Cm)
//   y  = bf16(relu((h2 @ w3^T + b3) + float(x)))                  (M, C)
// w1 is (Cm, C), w2 (Cm, 9, Cm) over the taps t = (dy + 1) * 3 + (dx + 1),
// dy and dx in {-1, 0, 1}, w3 (C, Cm); the biases are float32. Tap t of row
// r reads h1's row r + dy*W + dx where (py + dy, px + dx) lies inside r's
// image ((py, px) = divmod(r % (H*W), W)) and zeros elsewhere: the 3x3
// convolution's 'SAME' zero padding. Products are float32 sums of bf16
// values; h1 and h2 are rounded once, after the bias and the ReLU, and y
// after (h3 + b3) + x, as the reference does (bottleneck_block.py:53-54, 84,
// 87-89).
//
// What bounds it on this card: at layer4 of ResNet-50 at 128x128 and 256
// images (M = 4,096, C = 2,048, Cm = 512) it does 2*M*(C*Cm + 9*Cm^2 + Cm*C)
// = 36.5 GFLOP (0.0369 ms at 989 TFLOP/s bf16) and must move x, y and the
// weights, 42.5 MB (0.0127 ms at 3.35 TB/s): it is operation-bound.
//
// Design: h1 and h2 never leave shared memory, as the TPU kernel keeps them
// in VMEM; device memory sees x (read again for the shortcut), the weights
// and y. A block owns a whole number of images (rows of one image never
// straddle two blocks, so every tap it reads is its own), padded to a
// multiple of 32 rows, and runs three GEMMs in turn with one tensor-core
// tile: 8 warps on a 32- or 64-row x 128-column output tile, mma.sync
// m16n8k16 (bf16 in, float32 accumulators), K steps of 64 through a
// three-stage cp.async ring of the weight tile (and of the x tile in the
// first GEMM), rows padded by 16 bytes so that ldmatrix reads no bank twice.
// The 3x3 GEMM reads its A operand straight from h1: each lane hands
// ldmatrix the row of its shifted tap, or a zero row where the tap is
// masked, so the taps cost no copies. Its K runs tap-major (K = 9*Cm), so
// one K step lies inside one tap. Known limit, for the redesign: every
// block reads all the weights (8.9 MB at layer4) through L2, about 1.1 GB
// of L2 reads a launch at 128 blocks; wgmma, TMA multicast across a cluster
// and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 128, BK = 64, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;     // 256
constexpr int WN = BN / WARPS_N, NI = WN / 8;       // a warp's 32 columns: 4 mma tiles
constexpr int LDS = BK + 8;                         // row pitch of a staged tile: 144 bytes
constexpr int W_CHUNKS = BN * BK / 8 / THREADS;     // 16-byte copies per thread per weight tile
constexpr size_t SMEM_LIMIT = 232448;               // 227 KB, the most a block may use

__host__ __device__ constexpr int padded_rows(int rows) { return (rows + 31) / 32 * 32; }
__host__ __device__ constexpr int row_chunk(int padded) { return padded % 64 == 0 ? 64 : 32; }

// zero row, h1, h2, the weight ring, the x ring (the first GEMM's A)
size_t smem_bytes(int rows, int cm) {
  const int rp = padded_rows(rows), mt = row_chunk(rp);
  return 2 * (size_t)BK + 2 * 2 * (size_t)rp * (cm + 8) + 2 * (size_t)STAGES * (BN + mt) * LDS;
}

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

// relu(v + b), the bias added first, as one float32 operation each
__device__ __forceinline__ float bias_relu(float v, float b) { return fmaxf(__fadd_rn(v, b), 0.f); }

struct Args {
  const bf16 *x, *w1, *w2, *w3;
  const float *b1, *b2, *b3;
  bf16* y;
  int M, C, CM, H, W, rows;   // rows: a block's rows, a multiple of H*W
};

// Block b owns rows [b * rows, b * rows + rows) of x and y. MT is the row
// chunk of one GEMM pass (a block's padded rows are a multiple of it).
template <int MT>
__global__ void __launch_bounds__(THREADS) bottleneck_block_kernel(const Args a) {
  constexpr int WM = MT / WARPS_M, MI = WM / 16;     // a warp's rows: 1 or 2 mma tiles
  constexpr int X_CHUNKS = MT * BK / 8 / THREADS;    // 16-byte copies per thread per x tile
  static_assert(X_CHUNKS * THREADS * 8 == MT * BK && W_CHUNKS * THREADS * 8 == BN * BK,
                "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int ldh = a.CM + 8;                          // row pitch of h1 and h2
  const int row0 = (int)blockIdx.x * a.rows;
  const int valid = min(a.rows, a.M - row0);         // a whole number of images
  const int rp = padded_rows(a.rows);
  const int hw = a.H * a.W;

  bf16* zero = reinterpret_cast<bf16*>(smem_raw);    // BK zeros: a masked tap's row
  bf16* h1 = zero + BK;
  bf16* h2 = h1 + (size_t)rp * ldh;
  bf16* ws = h2 + (size_t)rp * ldh;                  // STAGES x (BN x LDS)
  bf16* xs = ws + STAGES * BN * LDS;                 // STAGES x (MT x LDS)
  if (tid < BK / 8) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);

  float acc[MI][NI][4];

  // acc = A[m_base + (0..MT), 0..K) @ wg[n0 + (0..BN), 0..K)^T, wg row-major
  // (N, K), rows past N read as zeros. With STAGE_X the A tile is x's,
  // staged with the weight tile; otherwise A lies in shared memory already.
  // a_base(stage, step, i) is the lane's ldmatrix address of A fragment i at
  // the step's first column.
  auto gemm = [&](auto stage_x, const bf16* wg, int N, int K, int n0, int m_base, auto a_base) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const int ksteps = K / BK;
    auto load = [&](int step) {
      const int s = step % STAGES, k0 = step * BK;
      bf16* wdst = ws + s * BN * LDS;
#pragma unroll
      for (int c = 0; c < W_CHUNKS; ++c) {
        const int q = tid + c * THREADS, r = q / (BK / 8), k = (q % (BK / 8)) * 8;
        const bool ok = n0 + r < N;
        cp_async16(wdst + r * LDS + k, ok ? wg + (size_t)(n0 + r) * K + k0 + k : wg, ok);
      }
      if constexpr (decltype(stage_x)::value) {
        bf16* xdst = xs + s * MT * LDS;
#pragma unroll
        for (int c = 0; c < X_CHUNKS; ++c) {
          const int q = tid + c * THREADS, r = q / (BK / 8), k = (q % (BK / 8)) * 8;
          const bool ok = m_base + r < valid;
          cp_async16(xdst + r * LDS + k,
                     ok ? a.x + (size_t)(row0 + m_base + r) * a.C + k0 + k : a.x, ok);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ksteps) load(s);
      cp_async_commit();
    }
    for (int step = 0; step < ksteps; ++step) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();              // the step's tiles are in; the stage refilled below is free
      if (step + STAGES - 1 < ksteps) load(step + STAGES - 1);
      cp_async_commit();
      const int s = step % STAGES;
      const bf16* wsb = ws + s * BN * LDS;
      const bf16* ab[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) ab[i] = a_base(s, step, i);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[MI][4], bfr[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], ab[i] + kk);
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          unsigned r[4];
          ldmatrix_x4(r, wsb + (wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                             ((lane >> 3) & 1) * 8);
          bfr[j][0] = r[0], bfr[j][1] = r[1], bfr[j + 1][0] = r[2], bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                // every warp is done with the ring
  };

  // h[m_base + r, n0 + c] = bf16(relu(acc + bias)) for the tile's columns < N
  auto store_h = [&](bf16* h, const float* __restrict__ bias, int N, int n0, int m_base) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = n0 + wn * WN + j * 8 + 2 * t4;
      if (c >= N) continue;
      const float bb0 = bias[c], bb1 = bias[c + 1];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = m_base + wm * WM + i * 16 + g;
        *reinterpret_cast<__nv_bfloat162*>(h + (size_t)r * ldh + c) =
            __floats2bfloat162_rn(bias_relu(acc[i][j][0], bb0), bias_relu(acc[i][j][1], bb1));
        *reinterpret_cast<__nv_bfloat162*>(h + (size_t)(r + 8) * ldh + c) =
            __floats2bfloat162_rn(bias_relu(acc[i][j][2], bb0), bias_relu(acc[i][j][3], bb1));
      }
    }
  };

  const int lane_row = (lane & 15), lane_col = (lane >> 4) * 8;   // the lane's ldmatrix A row
  const std::integral_constant<bool, true> staged{};
  const std::integral_constant<bool, false> in_smem{};

  // 1x1, C -> Cm: h1 = bf16(relu(x @ w1^T + b1))
  for (int m_base = 0; m_base < rp; m_base += MT)
    for (int n0 = 0; n0 < a.CM; n0 += BN) {
      gemm(staged, a.w1, a.CM, a.C, n0, m_base, [&](int s, int, int i) -> const bf16* {
        return xs + s * MT * LDS + (wm * WM + i * 16 + lane_row) * LDS + lane_col;
      });
      store_h(h1, a.b1, a.CM, n0, m_base);
    }
  __syncthreads();

  // 3x3 'SAME', Cm -> Cm, as nine shifted taps of h1: K = 9 * Cm, tap-major
  for (int m_base = 0; m_base < rp; m_base += MT) {
    int lr[MI], py[MI], px[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      lr[i] = m_base + wm * WM + i * 16 + lane_row;
      const int pos = lr[i] % hw;
      py[i] = pos / a.W, px[i] = pos % a.W;
    }
    for (int n0 = 0; n0 < a.CM; n0 += BN) {
      gemm(in_smem, a.w2, a.CM, 9 * a.CM, n0, m_base, [&](int, int step, int i) -> const bf16* {
        const int k0 = step * BK, tap = k0 / a.CM, dy = tap / 3 - 1, dx = tap % 3 - 1;
        const int sy = py[i] + dy, sx = px[i] + dx;
        const bool ok = lr[i] < valid && sy >= 0 && sy < a.H && sx >= 0 && sx < a.W;
        return ok ? h1 + (size_t)(lr[i] + dy * a.W + dx) * ldh + (k0 - tap * a.CM) + lane_col
                  : zero + lane_col;
      });
      store_h(h2, a.b2, a.CM, n0, m_base);
    }
  }
  __syncthreads();

  // 1x1, Cm -> C, with the shortcut: y = bf16(relu((h2 @ w3^T + b3) + x))
  for (int m_base = 0; m_base < rp; m_base += MT)
    for (int n0 = 0; n0 < a.C; n0 += BN) {
      gemm(in_smem, a.w3, a.C, a.CM, n0, m_base, [&](int, int step, int i) -> const bf16* {
        return h2 + (size_t)(m_base + wm * WM + i * 16 + lane_row) * ldh + step * BK + lane_col;
      });
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = n0 + wn * WN + j * 8 + 2 * t4;
        if (c >= a.C) continue;
        const float bb0 = a.b3[c], bb1 = a.b3[c + 1];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = m_base + wm * WM + i * 16 + g + 8 * half;
            if (r >= valid) continue;
            const size_t off = (size_t)(row0 + r) * a.C + c;
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off));
            const float v0 = fmaxf(__fadd_rn(__fadd_rn(acc[i][j][2 * half], bb0), xv.x), 0.f);
            const float v1 = fmaxf(__fadd_rn(__fadd_rn(acc[i][j][2 * half + 1], bb1), xv.y), 0.f);
            *reinterpret_cast<__nv_bfloat162*>(a.y + off) = __floats2bfloat162_rn(v0, v1);
          }
      }
    }
}

template <int MT>
int launch(const Args& a, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(bottleneck_block_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.M + a.rows - 1) / a.rows;
  bottleneck_block_kernel<MT><<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block of `rows` rows needs at width cm, in bytes.
size_t bottleneck_block_smem_bytes(int rows, int cm) { return smem_bytes(rows, cm); }

// The most shared memory a block may take (bottleneck_block refuses more).
size_t bottleneck_block_smem_limit() { return SMEM_LIMIT; }

// Returns a cudaError_t (0 on success). x and y are device pointers to
// row-major (M, C) bf16 planes, w1 to (CM, C), w2 to (CM, 9, CM) and w3 to
// (C, CM) bf16 weights, b1 and b2 to (CM,) and b3 to (C,) float32 biases;
// all 16-byte aligned. C and CM are multiples of 64; M and rows (a block's
// rows) are multiples of H*W, and the block's shared memory
// (bottleneck_block_smem_bytes) is at most 227 KB.
// Replaces bottleneck_block (simhand_tpu/ops/bottleneck_block.py:92, its
// pallas_call :131, _block_kernel :46-89).
int bottleneck_block(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* w3, const void* b3, int M, int C, int CM, int H,
                     int W, int rows, void* y, void* stream) {
  if (M <= 0 || C <= 0 || CM <= 0 || H <= 0 || W <= 0 || rows <= 0 || C % 64 || CM % 64 ||
      M % (H * W) || rows % (H * W))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rows, CM);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x),  static_cast<const bf16*>(w1),
               static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
               static_cast<const float*>(b1), static_cast<const float*>(b2),
               static_cast<const float*>(b3), static_cast<bf16*>(y),
               M, C, CM, H, W, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return row_chunk(padded_rows(rows)) == 64 ? launch<64>(a, smem, s) : launch<32>(a, smem, s);
}

const char* bottleneck_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
