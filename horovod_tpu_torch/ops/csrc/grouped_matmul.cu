// G1: grouped (ragged) matrix product for Hopper (sm_90a), plain C ABI.
//
// No Pallas original: the counterpart of the XLA op `lax.ragged_dot(xs,
// W, counts)`, which the JAX package's dropless mixture-of-experts
// dispatch (horovod_tpu/ops/moe.py `dropless_moe`) runs three times a
// layer, the gate, up and down products of the experts.  Same function:
//
//   out[t, :] = xs[t, :] @ W[g(t)],   g(t) = the e with off[e] <= t < off[e+1]
//
// with xs (T, K) sorted by group, W (E, K, N), out (T, N) in the input
// dtype, f32 accumulation.  `offsets` (E + 1 int32, the cumsum of the
// group sizes with a leading 0) is READ FROM DEVICE MEMORY by every CTA:
// the serving engine captures each admission shape once as a CUDA graph,
// which bakes the launch's arguments, while the group sizes change with
// every prompt.  So the grid depends on T, N and E only: ceil(T / BM) + E
// row tiles (each group starts its own tiles, so it adds at most one
// partial tile) by ceil(N / BN) column tiles.  A CTA walks the offsets
// (E <= 64) to find its (group, tile) and exits if it has none.
//
// Row invariance, which the serving gates rest on (a bucket-padded
// admission against the single-request oracle): a row's output bits
// depend only on that row and its group's weights.  Every CTA runs the
// same K loop in one order, with no split-K, and the tile a row falls in
// changes only which registers hold it.  So neither T, nor the other
// groups' sizes, nor the row's place in its tile changes its bits.
//
// Rows, K columns and N columns past their edge load as zeros (K and N
// are multiples of 8, so a 16-byte chunk is wholly inside or outside)
// and are never stored; an empty group owns no tile.
//
// Bound on an H100: at the MoE prefill's gate product (T = 8192, K =
// 1024, N = 2048, E = 8, bf16) the work is 34 GFLOP against ~84 MB of
// inputs and outputs, so the tensor-core rate bounds it (989 TFLOP/s,
// ~35 us), not HBM (~25 us).
//
// Two instantiations, chosen by dtype in the C entry point (not a
// fallback: each dtype has exactly one kernel):
//
// * bf16 (`grouped_mm_kernel_mma`): mma.sync.m16n8k16 on the tensor
//   cores (mma_bf16.cuh).  A CTA of 4 warps (2 x 2) computes a 64 x 128
//   output tile, 32 x 64 a warp; 64 x 32 tiles of xs and 32 x 128 tiles
//   of W[g] are staged in shared memory (rows padded by 8 for
//   conflict-free ldmatrix), double buffered with cp.async so the next
//   K step lands while this one computes; W's tile is k-major, read as B
//   fragments with ldmatrix.trans.  mma.sync, not wgmma + TMA: the first
//   design; the warpgroup version is later work (ROADMAP).
// * f32 (`grouped_mm_kernel`): scalar FMAs, 256 threads on a 64 x 64
//   tile, 4 x 4 outputs a thread, each a sequential fmaf over k (TF32
//   tensor cores would miss the f32 contract, as for K1-K3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using hvd_mma::bf16;

constexpr int MAX_GROUPS = 64;

// This CTA's tile: the group `e` whose tiles hold tile index `tile`
// (tiles numbered group after group), its first row and the group's
// end.  Offsets are clamped to [0, T] so a corrupt table cannot send a
// CTA out of bounds.  False: no tile (the grid's spare CTAs).
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets,
                                          int E, int T, int BMv, int tile,
                                          int& e_out, int& row0,
                                          int& row_end) {
  int lo = min(max(offsets[0], 0), T);
  for (int e = 0; e < E; ++e) {
    const int hi = min(max(offsets[e + 1], lo), T);
    const int n = (hi - lo + BMv - 1) / BMv;
    if (tile < n) {
      e_out = e;
      row0 = lo + tile * BMv;
      row_end = hi;
      return true;
    }
    tile -= n;
    lo = hi;
  }
  return false;
}

// --- bf16: tensor cores -------------------------------------------------------

constexpr int BM = 64;    // rows a CTA
constexpr int BN = 128;   // output columns a CTA
constexpr int BK = 32;    // K a pipeline stage
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ xs,
                                           const bf16* __restrict__ w,
                                           int row0, int row_end, int n0,
                                           int k0, int K, int N) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += MMA_THREADS) {
    const int r = i / (BK / 8), c = i % (BK / 8);
    const int row = row0 + r, k = k0 + c * 8;
    const bool ok = row < row_end && k < K;
    hvd_mma::cp_async16(As + r * LDA + c * 8,
                        xs + (ok ? (size_t)row * K + k : 0), ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += MMA_THREADS) {
    const int r = i / (BN / 8), c = i % (BN / 8);
    const int k = k0 + r, n = n0 + c * 8;
    const bool ok = k < K && n < N;
    hvd_mma::cp_async16(Bs + r * LDB + c * 8,
                        w + (ok ? (size_t)k * N + n : 0), ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(MMA_THREADS) grouped_mm_kernel_mma(
    const bf16* __restrict__ xs, const bf16* __restrict__ w,
    const int* __restrict__ offsets, bf16* __restrict__ out, int T, int K,
    int N, int E) {
  int e, row0, row_end;
  if (!find_tile(offsets, E, T, BM, blockIdx.x, e, row0, row_end)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [2][BM][LDA]
  bf16* Bs = As + 2 * BM * LDA;                   // [2][BK][LDB]
  const bf16* we = w + (size_t)e * K * N;
  const int n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_stage(As, Bs, xs, we, row0, row_end, n0, 0, K, N);
  hvd_mma::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk)
      load_stage(As + (s ^ 1) * BM * LDA, Bs + (s ^ 1) * BK * LDB, xs, we,
                 row0, row_end, n0, (kt + 1) * BK, K, N);
    hvd_mma::cp_async_commit();
    hvd_mma::cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const bf16* At = As + s * BM * LDA;
    const bf16* Bt = Bs + s * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        hvd_mma::ldsm_x4(af[mi],
                         hvd_mma::frag_a<LDA>(At, wm + mi * 16, kk, lane));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        hvd_mma::ldsm_x4_trans(
            bfr, hvd_mma::frag_a<LDB>(Bt, kk, wn + nj * 16, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          hvd_mma::mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          hvd_mma::mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this stage
  }

  // C fragments: (g, 2t..2t+1) and (g + 8, 2t..2t+1) of each 16 x 8 tile.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + mi * 16 + g + 8 * h;
        if (row >= row_end) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// --- f32: scalar FMAs ---------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int F_THREADS = 256;  // 16 x 16, 4 x 4 outputs a thread

__global__ void __launch_bounds__(F_THREADS) grouped_mm_kernel(
    const float* __restrict__ xs, const float* __restrict__ w,
    const int* __restrict__ offsets, float* __restrict__ out, int T, int K,
    int N, int E) {
  int e, row0, row_end;
  if (!find_tile(offsets, E, T, FBM, blockIdx.x, e, row0, row_end)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [FBM][FBK + 1]
  float* Bs = As + FBM * (FBK + 1);                 // [FBK][FBN]
  const float* we = w + (size_t)e * K * N;
  const int n0 = blockIdx.y * FBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int i = threadIdx.x; i < FBM * FBK; i += F_THREADS) {
      const int r = i / FBK, c = i % FBK;
      const int row = row0 + r, k = k0 + c;
      As[r * (FBK + 1) + c] =
          row < row_end && k < K ? xs[(size_t)row * K + k] : 0.f;
    }
    for (int i = threadIdx.x; i < FBK * FBN; i += F_THREADS) {
      const int r = i / FBN, c = i % FBN;
      const int k = k0 + r, n = n0 + c;
      Bs[r * FBN + c] = k < K && n < N ? we[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * (FBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * FBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= row_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// out (T, N) = xs (T, K) @ W[group] (E, K, N), groups by `offsets` (E + 1
// int32 on the device).  bf16 runs the tensor-core kernel, f32 the
// scalar one.  Pointers must be 16-byte aligned (the wrapper checks).
extern "C" int grouped_matmul(const void* xs, const void* w,
                              const void* offsets, void* out, int T, int K,
                              int N, int E, int is_bf16, void* stream) {
  if (T < 1 || E < 1 || E > MAX_GROUPS || K < 8 || N < 8 || K % 8 ||
      N % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (is_bf16) {
    const size_t smem = sizeof(bf16) * 2 * (BM * LDA + BK * LDB);
    auto kern = grouped_mm_kernel_mma;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + BM - 1) / BM + E, (N + BN - 1) / BN);
    kern<<<grid, MMA_THREADS, smem, st>>>(
        static_cast<const bf16*>(xs), static_cast<const bf16*>(w), off,
        static_cast<bf16*>(out), T, K, N, E);
  } else {
    const size_t smem = sizeof(float) * (FBM * (FBK + 1) + FBK * FBN);
    auto kern = grouped_mm_kernel;
    dim3 grid((T + FBM - 1) / FBM + E, (N + FBN - 1) / FBN);
    kern<<<grid, F_THREADS, smem, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w), off,
        static_cast<float*>(out), T, K, N, E);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
