// K2 and K3: flash-attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernels horovod_tpu/ops/attention.py
// `_flash_bwd_dkdv_kernel` (K2) and `_flash_bwd_dq_kernel` (K3), both
// launched by `_flash_bwd_pallas`.  Same function, from the forward's
// saved logsumexp and delta = rowsum(do * o) - dlse (computed by the
// caller in f32):
//
//   p    = exp(q k^T * scale - lse)      (0 where masked)
//   dv_j = sum_i p^T do                  (K2)
//   dp   = do v^T
//   ds   = p * (dp - delta) * scale
//   dk_j = sum_i ds^T q                  (K2)
//   dq_i = sum_j ds k                    (K3)
//
// Mask: position (row, col) attends iff col + shift <= row when `masked`
// (shift 0 is causal); blocks wholly past the shifted diagonal are
// skipped.  Rounding points mirror the JAX kernels: p rounded to do's
// dtype (= q's) before p^T do, ds rounded to q's dtype before ds^T q
// and to k's before ds k, every product accumulated in f32, outputs cast
// to the input dtype.  The scalar kernels stage tiles in shared memory
// as f32 values already rounded to the input dtype, so each product is
// an exact f32 FMA of the rounded operands; the tensor-core kernel
// multiplies the bf16 operands exactly and accumulates in f32.
//
// The TPU's sequential grid axis becomes a loop inside the CTA:
//   K2: one CTA per (batch, kv head, 64-row K block) loops over the G
//       query heads of its group and over the Q blocks, so dk/dv of a
//       GQA group are summed inside the CTA: deterministic, no atomics,
//       no expanded dk/dv.
//   K3: one CTA per (batch, head, 64-row Q block) loops over K blocks,
//       reading kv head h / G.
//
// Bound on an H100: at the training shape (B=8, H=16, S=T=2048, D=64,
// bf16, causal) K2 does 8*D FLOPs and K3 6*D per visible (row, col)
// pair, ~137 and ~103 GFLOP against ~50 MB of inputs and outputs, so the
// tensor-core rate bounds both (0.14 and 0.10 ms), not HBM.
//
// K2 has two instantiations, chosen by dtype in the C entry point (not a
// fallback: each dtype has exactly one kernel):
//
// * bf16 (`flash_bwd_dkdv_kernel_mma`): the four products on the tensor
//   cores with mma.sync.m16n8k16 (mma_bf16.cuh), computed TRANSPOSED so
//   that no tile is ever transposed in memory.  A CTA of 4 warps keeps
//   its 64-row K and V block in shared memory (bf16) for its life, 16
//   K rows a warp.  Q and dO tiles (bf16) with their lse and delta rows
//   stream through a two-stage cp.async ring.  Per (K block, Q tile):
//     S^T  = K Q^T             (A: K rows, B: Q rows, ldmatrix)
//     P^T  = exp(S^T * scale - lse)   0 where masked
//     dP^T = V dO^T            (A: V rows, B: dO rows)
//     dS^T = P^T * (dP^T - delta) * scale
//     dV  += P^T dO,  dK += dS^T Q   (B: dO, Q via ldmatrix.trans)
//   P^T and dS^T are f32 C fragments; rounded to bf16 in registers they
//   are the A fragments of the last two products.  dK and dV (16 x D a
//   warp, f32) stay in registers until the one write at the end.  At
//   D = 128 that is 128 accumulator registers a thread; K and V
//   fragments are therefore re-read from shared memory for each Q tile
//   rather than held in registers.  mma.sync, not wgmma + TMA: the first
//   tensor-core design; wgmma is later work.
// * f32 (`flash_bwd_dkdv_kernel`): the scalar kernel of the first port
//   (see K3 below): TF32 tensor cores would miss the f32 contract.
//
// K3 (`flash_bwd_dq_kernel`, both dtypes) is still the scalar kernel:
// 256 threads as a 16 x 16 grid, each owning a 4 x 4 block of the
// 64 x 64 score tile and a 4 x D/16 block of its output tile, every
// product a scalar f32 FMA from shared memory, at CUDA-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int TS = 16;       // thread grid side: THREADS = TS * TS
constexpr int THREADS = TS * TS;
constexpr int RA = BQ / TS;  // score rows per thread
constexpr int RB = BK / TS;  // score columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Shared-memory layout, all f32; rows padded by one word so that a
// column walk hits 32 different banks.
template <int D> struct Smem {
  static constexpr int LD = D + 1;
  static constexpr int LP = BK + 1;
  static constexpr size_t floats =
      2 * BQ * LD + 2 * BK * LD + 2 * BQ * LP + 2 * BQ;
  float* q;      // [BQ][LD]
  float* dout;   // [BQ][LD]
  float* k;      // [BK][LD]
  float* v;      // [BK][LD]
  float* p;      // [BQ][LP]  p in do's dtype
  float* ds;     // [BQ][LP]  ds in q's (= k's) dtype
  float* lse;    // [BQ]
  float* delta;  // [BQ]
  __device__ explicit Smem(float* base) {
    q = base;
    dout = q + BQ * LD;
    k = dout + BQ * LD;
    v = k + BK * LD;
    p = v + BK * LD;
    ds = p + BQ * LP;
    lse = ds + BQ * LP;
    delta = lse + BQ;
  }
};

// Rows [r0, r0 + n) of a (rows, D) matrix into a padded f32 tile; rows
// past `rows` read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int n) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < rows ? to_f(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows) {
  for (int r = threadIdx.x; r < BQ; r += THREADS)
    dst[r] = r0 + r < rows ? src[r0 + r] : 0.f;
}

// p and ds of one (Q tile, K tile) pair into shared memory.  Thread
// (ty, tx) computes rows ty + TS*a and columns tx + TS*b of the tile.
template <typename T, int D>
__device__ __forceinline__ void probs(const Smem<D>& sm, int q0, int k0,
                                      int S, int Tn, int masked, int shift,
                                      float scale) {
  constexpr int LD = D + 1, LP = BK + 1;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  float s[RA][RB], dp[RA][RB];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[RA], oa[RA], kb[RB], vb[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      qa[a] = sm.q[(ty + TS * a) * LD + d];
      oa[a] = sm.dout[(ty + TS * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      kb[b] = sm.k[(tx + TS * b) * LD + d];
      vb[b] = sm.v[(tx + TS * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + TS * a, row = q0 + r;
    const float lse = sm.lse[r], delta = sm.delta[r];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int c = tx + TS * b, col = k0 + c;
      const bool ok =
          row < S && col < Tn && (!masked || col + shift <= row);
      // Masked scores are NEG_INF (-1e30) in the JAX kernels, whose p is
      // then exactly 0; fully masked rows (lse = NEG_INF) get p = 0 too.
      const float p = ok ? expf(s[a][b] * scale - lse) : 0.f;
      const float ds = p * (dp[a][b] - delta) * scale;
      sm.p[r * LP + c] = round_to<T>(p);
      sm.ds[r * LP + c] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S, int Tn,
    int masked, int shift, float scale) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  constexpr int LD = D + 1, LP = BK + 1, NC = D / TS;
  const int bk = blockIdx.y;  // b * Hkv + hk
  const int b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;

  const size_t kv_off = (size_t)bk * Tn * D;
  load_tile<T, D>(sm.k, k + kv_off, k0, Tn, BK);
  load_tile<T, D>(sm.v, v + kv_off, k0, Tn, BK);

  // This thread's share of dk / dv: rows ty + TS*a, columns tx + TS*c.
  float acc_k[RB][NC], acc_v[RB][NC];
#pragma unroll
  for (int a = 0; a < RB; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  // Q blocks wholly above the shifted diagonal contribute nothing: the
  // first that does has q0 + BQ - 1 >= k0 + shift.
  int qb_begin = 0;
  if (masked) {
    const int lo = k0 + shift - (BQ - 1);
    if (lo > 0) qb_begin = (lo + BQ - 1) / BQ;
  }
  const int nqb = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + hk * G + g;
    const T* qh = q + (size_t)bh * S * D;
    const T* oh = dout + (size_t)bh * S * D;
    for (int qb = qb_begin; qb < nqb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous step's reads of the tiles are done
      load_tile<T, D>(sm.q, qh, q0, S, BQ);
      load_tile<T, D>(sm.dout, oh, q0, S, BQ);
      load_rows(sm.lse, lse + (size_t)bh * S, q0, S);
      load_rows(sm.delta, delta + (size_t)bh * S, q0, S);
      __syncthreads();
      probs<T, D>(sm, q0, k0, S, Tn, masked, shift, scale);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pa[RB], da[RB];
#pragma unroll
        for (int a = 0; a < RB; ++a) {
          pa[a] = sm.p[i * LP + ty + TS * a];
          da[a] = sm.ds[i * LP + ty + TS * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float o = sm.dout[i * LD + tx + TS * c];
          const float qq = sm.q[i * LD + tx + TS * c];
#pragma unroll
          for (int a = 0; a < RB; ++a) {
            acc_v[a][c] = fmaf(pa[a], o, acc_v[a][c]);
            acc_k[a][c] = fmaf(da[a], qq, acc_k[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RB; ++a) {
    const int row = k0 + ty + TS * a;
    if (row >= Tn) continue;
    T* dkr = dk + kv_off + (size_t)row * D;
    T* dvr = dv + kv_off + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[tx + TS * c] = from_f<T>(acc_k[a][c]);
      dvr[tx + TS * c] = from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Hkv, int S, int Tn, int masked,
    int shift, float scale) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  constexpr int LD = D + 1, LP = BK + 1, NC = D / TS;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;

  const size_t q_off = (size_t)bh * S * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  load_tile<T, D>(sm.q, q + q_off, q0, S, BQ);
  load_tile<T, D>(sm.dout, dout + q_off, q0, S, BQ);
  load_rows(sm.lse, lse + (size_t)bh * S, q0, S);
  load_rows(sm.delta, delta + (size_t)bh * S, q0, S);

  float acc[RA][NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  // K blocks starting past the shifted diagonal of this CTA's last row
  // contribute nothing: k0 + shift <= q0 + BQ - 1 is needed.
  const int k_end = masked ? min(Tn, max(0, q0 + BQ - shift)) : Tn;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step's reads of the tiles are done
    load_tile<T, D>(sm.k, k + kv_off, k0, Tn, BK);
    load_tile<T, D>(sm.v, v + kv_off, k0, Tn, BK);
    __syncthreads();
    probs<T, D>(sm, q0, k0, S, Tn, masked, shift, scale);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float da[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) da[a] = sm.ds[(ty + TS * a) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = sm.k[j * LD + tx + TS * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(da[a], kk, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = q0 + ty + TS * a;
    if (row >= S) continue;
    T* dqr = dq + q_off + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqr[tx + TS * c] = from_f<T>(acc[a][c]);
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Hkv, int S,
                        int Tn, int masked, int shift, float scale,
                        cudaStream_t st) {
  const size_t smem = sizeof(float) * Smem<D>::floats;
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + BK - 1) / BK, B * Hkv);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, Tn, masked, shift,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, int Tn,
                      int masked, int shift, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Smem<D>::floats;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Hkv, S, Tn, masked, shift, scale);
  return cudaGetLastError();
}

// --- K2 in bf16: tensor cores ------------------------------------------------

using hvd_mma::bf16;

constexpr int MMA_WARPS = 4;                 // 16 K rows a warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkdv_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int S,
    int Tn, int masked, int shift, float scale) {
  using namespace hvd_mma;
  constexpr int LD = D + 8;   // padded row stride of every tile
  constexpr int KS = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NT = BQ / 8;  // n-tiles of a warp's 16 x BQ tile
  constexpr int ND = D / 8;   // n-tiles of a warp's 16 x D dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD], resident
  bf16* Vs = Ks + BK * LD;                       // [BK][LD], resident
  bf16* Qs = Vs + BK * LD;                       // [2][BQ][LD]
  bf16* Os = Qs + 2 * BQ * LD;                   // [2][BQ][LD]  dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                 // [2][BQ]

  const int bk = blockIdx.x;  // b * Hkv + hk
  const int b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * BK;  // block 0, the longest under a causal
                                   // mask, launches first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk0 = k0 + warp * 16;                     // the warp's K rows
  const int j0 = wk0 + (lane >> 2), j1 = j0 + 8;      // this lane's
  const size_t kv_off = (size_t)bk * Tn * D;

  // Q blocks wholly above the shifted diagonal contribute nothing: the
  // first that does has q0 + BQ - 1 >= k0 + shift.
  int qb_begin = 0;
  if (masked) {
    const int lo = k0 + shift - (BQ - 1);
    if (lo > 0) qb_begin = (lo + BQ - 1) / BQ;
  }
  const int nq = max(0, (S + BQ - 1) / BQ - qb_begin);
  const int steps = G * nq;  // (query head of the group, Q block) pairs

  auto stage = [&](int st, int i) {
    const int bh = b * H + hk * G + i / nq;
    const int q0 = (qb_begin + i % nq) * BQ;
    load_rows_async<BQ, D, MMA_THREADS>(Qs + st * BQ * LD,
                                        q + (size_t)bh * S * D, q0, S);
    load_rows_async<BQ, D, MMA_THREADS>(Os + st * BQ * LD,
                                        dout + (size_t)bh * S * D, q0, S);
    load_vec_async<BQ>(Ls + st * BQ, lse + (size_t)bh * S, q0, S, 0);
    load_vec_async<BQ>(Ds + st * BQ, delta + (size_t)bh * S, q0, S, BQ);
  };

  // cp.async groups: K, V and step 0, then one per step (empty past the
  // last), so "all but the newest group landed" is the step about to run.
  load_rows_async<BK, D, MMA_THREADS>(Ks, k + kv_off, k0, Tn);
  load_rows_async<BK, D, MMA_THREADS>(Vs, v + kv_off, k0, Tn);
  if (steps > 0) stage(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    const int q0 = (qb_begin + i % nq) * BQ;
    if (i + 1 < steps) stage(st ^ 1, i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* Ot = Os + st * BQ * LD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;

    // Nothing to add for a warp whose K rows lie past T, or whose tile
    // lies wholly above the diagonal (its first row's first visible
    // query row is past the tile).
    if (wk0 < Tn && !(masked && wk0 + shift > q0 + BQ - 1)) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, frag_a<LD>(Ks, warp * 16, ks * 16, lane));
        ldsm_x4(va, frag_a<LD>(Vs, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, frag_b<LD>(Qt, np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], ka, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], ka, bf[2], bf[3]);
          ldsm_x4(bf, frag_b<LD>(Ot, np * 16, ks * 16, lane));
          mma_bf16(dp[2 * np], va, bf[0], bf[1]);
          mma_bf16(dp[2 * np + 1], va, bf[2], bf[3]);
        }
      }

      // Element (K row j, query row i): p = exp(s * scale - lse_i), 0
      // where masked (so fully masked rows, lse = NEG_INF, give 0);
      // ds = p * (dp - delta_i) * scale.  Only tiles crossing the
      // diagonal or the S edge test elements.
      const bool edge =
          q0 + BQ > S || (masked && wk0 + 15 + shift > q0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = n * 8 + 2 * (lane & 3) + (e & 1);
          const int qi = q0 + il, j = e < 2 ? j0 : j1;
          const bool ok =
              !edge || (qi < S && (!masked || j + shift <= qi));
          const float p =
              ok ? exp2f((s[n][e] * scale - Lt[il]) * LOG2E) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dt[il]) * scale;
        }

      // dV += P^T dO and dK += dS^T Q over k = the tile's query rows; P^T
      // rounded to dO's dtype and dS^T to Q's, in registers.
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kt][0], dp[2 * kt][1]),
            pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
            pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
            pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, frag_a<LD>(Ot, kt * 16, dn * 16, lane));
          mma_bf16(dva[2 * dn], pa, bf[0], bf[1]);
          mma_bf16(dva[2 * dn + 1], pa, bf[2], bf[3]);
          ldsm_x4_trans(bf, frag_a<LD>(Qt, kt * 16, dn * 16, lane));
          mma_bf16(dka[2 * dn], da, bf[0], bf[1]);
          mma_bf16(dka[2 * dn + 1], da, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // before the next stage overwrites this half
  }
  cp_async_wait<0>();  // no copy outlives the CTA (steps == 0 left K, V)

  // Row j0 holds fragment entries 0, 1 and row j1 entries 2, 3; each
  // lane writes two neighbouring columns of every n-tile.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? j1 : j0;
    if (j >= Tn) continue;
    const size_t at = kv_off + (size_t)j * D + 2 * (lane & 3);
    uint32_t* dkr = reinterpret_cast<uint32_t*>(dk + at);
    uint32_t* dvr = reinterpret_cast<uint32_t*>(dv + at);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      dkr[n * 4] = pack_bf16(dka[n][2 * half], dka[n][2 * half + 1]);
      dvr[n * 4] = pack_bf16(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkdv_mma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Hkv, int S, int Tn, int masked,
                            int shift, float scale, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (2 * BK + 4 * BQ) * (D + 8) +
                      sizeof(float) * 4 * BQ;
  auto kern = flash_bwd_dkdv_kernel_mma<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Tn + BK - 1) / BK);
  kern<<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, S, Tn, masked,
      shift, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S, int T) {
  return B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
         B * H > 65535;
}

}  // namespace

#define HVD_DISPATCH(FN, ...)                                          \
  if (is_bf16 && D == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__); \
  if (is_bf16 && D == 128)                                             \
    return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
  if (!is_bf16 && D == 64) return (int)FN<float, 64>(__VA_ARGS__);     \
  if (!is_bf16 && D == 128) return (int)FN<float, 128>(__VA_ARGS__);   \
  return (int)cudaErrorInvalidValue;

// dk, dv (B, H_kv, T, D) in the input dtype.  lse and delta are f32
// (B, H, S); q and dout (B, H, S, D); k and v (B, H_kv, T, D).  bf16
// runs the tensor-core kernel, f32 the scalar one; pointers must be
// 16-byte aligned (the wrapper checks).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Hkv, int S, int T, int D,
                              int is_bf16, int masked, int shift,
                              float scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64)
    return (int)launch_dkdv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Hkv, S, T, masked, shift, scale, st);
  if (is_bf16 && D == 128)
    return (int)launch_dkdv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B,
                                     H, Hkv, S, T, masked, shift, scale, st);
  if (!is_bf16 && D == 64)
    return (int)launch_dkdv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Hkv, S, T, masked, shift, scale,
                                       st);
  if (!is_bf16 && D == 128)
    return (int)launch_dkdv<float, 128>(q, k, v, dout, lse, delta, dk, dv,
                                        B, H, Hkv, S, T, masked, shift,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, S, D) in the input dtype.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int Hkv, int S, int T, int D, int is_bf16,
                            int masked, int shift, float scale,
                            void* stream) {
  if (bad_shape(B, H, Hkv, S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HVD_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, H, Hkv, S, T,
               masked, shift, scale, st)
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
