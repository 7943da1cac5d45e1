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
// to the input dtype.  The tensor-core kernels (bf16) multiply the bf16
// operands exactly and accumulate in f32; the scalar kernels (f32) use
// f32 FMAs throughout.
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
// K2 and K3 each have two instantiations, chosen by dtype in the C entry
// points (not a fallback: each dtype has exactly one kernel).  K2:
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
//   (see below): TF32 tensor cores would miss the f32 contract.
//
// K3:
//
// * bf16 (`flash_bwd_dq_kernel_mma`): the forward kernel's tiling turned
//   into dq.  Grid (B*H, Q blocks), longest causal tiles first; 4 warps,
//   16 Q rows a warp.  The warp's Q and dO rows are A fragments, held in
//   registers for the whole K loop at D = 64 (re-read from the resident
//   shared tiles each K tile at D = 128, where holding them beside dQ's
//   64 and S/dP's 64 accumulators would press on 255 registers); lse and
//   delta of the lane's two rows sit in registers.  64-row K and V tiles
//   of kv head h / G stream through a two-stage cp.async ring.  Per tile:
//     S  = Q K^T,  dP = dO V^T   (B: K, V rows by ldmatrix, no transpose)
//     P  = exp(S * scale - lse)  0 where masked (element tests only on
//                                tiles crossing the diagonal or T edge)
//     dS = P * (dP - delta) * scale
//     dQ += dS K                 (dS rounded to bf16 in registers as the
//                                A fragment; K by ldmatrix.trans)
//   dQ (16 x D a warp, f32) stays in registers and is written once.  No
//   group sum: that is K2's.
// * f32 (`flash_bwd_dq_kernel`): the scalar kernel of the first port.
//
// The scalar kernels (f32 only since the tensor-core kernels took bf16):
// 256 threads as a 16 x 16 grid, each owning a 4 x 4 block of the
// 64 x 64 score tile and a 4 x D/16 block of its output tile, every
// product a scalar f32 FMA from shared memory (`Smem`, `load_tile`,
// `probs`), at CUDA-core rate.

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
  float* p;      // [BQ][LP]
  float* ds;     // [BQ][LP]
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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int n) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r0 + r < rows ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows) {
  for (int r = threadIdx.x; r < BQ; r += THREADS)
    dst[r] = r0 + r < rows ? src[r0 + r] : 0.f;
}

// p and ds of one (Q tile, K tile) pair into shared memory.  Thread
// (ty, tx) computes rows ty + TS*a and columns tx + TS*b of the tile.
template <int D>
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
      sm.p[r * LP + c] = p;
      sm.ds[r * LP + c] = ds;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int S, int Tn,
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
  load_tile<D>(sm.k, k + kv_off, k0, Tn, BK);
  load_tile<D>(sm.v, v + kv_off, k0, Tn, BK);

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
    const float* qh = q + (size_t)bh * S * D;
    const float* oh = dout + (size_t)bh * S * D;
    for (int qb = qb_begin; qb < nqb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous step's reads of the tiles are done
      load_tile<D>(sm.q, qh, q0, S, BQ);
      load_tile<D>(sm.dout, oh, q0, S, BQ);
      load_rows(sm.lse, lse + (size_t)bh * S, q0, S);
      load_rows(sm.delta, delta + (size_t)bh * S, q0, S);
      __syncthreads();
      probs<D>(sm, q0, k0, S, Tn, masked, shift, scale);
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
    float* dkr = dk + kv_off + (size_t)row * D;
    float* dvr = dv + kv_off + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[tx + TS * c] = acc_k[a][c];
      dvr[tx + TS * c] = acc_v[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int S, int Tn, int masked,
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
  load_tile<D>(sm.q, q + q_off, q0, S, BQ);
  load_tile<D>(sm.dout, dout + q_off, q0, S, BQ);
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
    load_tile<D>(sm.k, k + kv_off, k0, Tn, BK);
    load_tile<D>(sm.v, v + kv_off, k0, Tn, BK);
    __syncthreads();
    probs<D>(sm, q0, k0, S, Tn, masked, shift, scale);
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
    float* dqr = dq + q_off + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqr[tx + TS * c] = acc[a][c];
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Hkv, int S,
                        int Tn, int masked, int shift, float scale,
                        cudaStream_t st) {
  const size_t smem = sizeof(float) * Smem<D>::floats;
  auto kern = flash_bwd_dkdv_kernel<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tn + BK - 1) / BK, B * Hkv);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, S, Tn, masked,
      shift, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int S, int Tn,
                      int masked, int shift, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Smem<D>::floats;
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, S, Tn, masked, shift, scale);
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

// --- K3 in bf16: tensor cores ------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int Hkv, int S, int Tn, int masked,
    int shift, float scale) {
  using namespace hvd_mma;
  constexpr int LD = D + 8;   // padded row stride of every tile
  constexpr int KS = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int NT = BK / 8;  // n-tiles of a warp's 16 x BK tile
  constexpr int ND = D / 8;   // n-tiles of a warp's 16 x D dQ
  // Q and dO fragments held in registers for the whole K loop at D = 64;
  // at D = 128 they would be 64 more registers beside dQ's 64 and S/dP's
  // 64, so they are re-read from shared memory for each tile instead.
  constexpr bool HOLD = D <= 64;
  constexpr int KH = HOLD ? KS : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD], resident
  bf16* Os = Qs + BQ * LD;                       // [BQ][LD]  dO, resident
  bf16* Ks = Os + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq0 = q0 + warp * 16;                       // the warp's rows
  const int row0 = wq0 + (lane >> 2), row1 = row0 + 8;  // this lane's
  const size_t q_off = (size_t)bh * S * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  // K tiles starting past the shifted diagonal of this CTA's last row
  // contribute nothing: k0 + shift <= q0 + BQ - 1 is needed.
  const int k_end = masked ? min(Tn, max(0, q0 + BQ - shift)) : Tn;
  const int n_tiles = (k_end + BK - 1) / BK;

  // cp.async groups: Q and dO, then one per K/V tile (empty past the
  // last), so "all but the newest group landed" is the tile about to run.
  load_rows_async<BQ, D, MMA_THREADS>(Qs, q + q_off, q0, S);
  load_rows_async<BQ, D, MMA_THREADS>(Os, dout + q_off, q0, S);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async<BK, D, MMA_THREADS>(Ks, kb, 0, Tn);
    load_rows_async<BK, D, MMA_THREADS>(Vs, vb, 0, Tn);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[KH][4], of[KH][4];  // Q and dO rows as A fragments
  if constexpr (HOLD) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(qf[ks], frag_a<LD>(Qs, warp * 16, ks * 16, lane));
      ldsm_x4(of[ks], frag_a<LD>(Os, warp * 16, ks * 16, lane));
    }
  }
  // lse and delta of rows row0 and row1 (rows past S: 0, never written).
  const size_t r_off = (size_t)bh * S;
  const float ls0 = row0 < S ? lse[r_off + row0] * LOG2E : 0.f;
  const float ls1 = row1 < S ? lse[r_off + row1] * LOG2E : 0.f;
  const float dl0 = row0 < S ? delta[r_off + row0] : 0.f;
  const float dl1 = row1 < S ? delta[r_off + row1] : 0.f;
  const float sl = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    const bf16* Kt = Ks + (it & 1) * BK * LD;
    const bf16* Vt = Vs + (it & 1) * BK * LD;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other half
      load_rows_async<BK, D, MMA_THREADS>(Ks + ((it + 1) & 1) * BK * LD, kb,
                                          t0 + BK, Tn);
      load_rows_async<BK, D, MMA_THREADS>(Vs + ((it + 1) & 1) * BK * LD, vb,
                                          t0 + BK, Tn);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // A tile wholly past the diagonal of the warp's last row adds nothing.
    if (!(masked && t0 + shift > wq0 + 15)) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int kq = HOLD ? ks : 0;
        if constexpr (!HOLD) {
          ldsm_x4(qf[0], frag_a<LD>(Qs, warp * 16, ks * 16, lane));
          ldsm_x4(of[0], frag_a<LD>(Os, warp * 16, ks * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, frag_b<LD>(Kt, np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], qf[kq], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[kq], bf[2], bf[3]);
          ldsm_x4(bf, frag_b<LD>(Vt, np * 16, ks * 16, lane));
          mma_bf16(dp[2 * np], of[kq], bf[0], bf[1]);
          mma_bf16(dp[2 * np + 1], of[kq], bf[2], bf[3]);
        }
      }

      // p = exp(s * scale - lse), 0 where masked (so fully masked rows,
      // lse = NEG_INF, give 0); ds = p * (dp - delta) * scale, kept in
      // s.  Only tiles crossing the diagonal or the T edge test elements.
      const bool edge =
          t0 + BK > Tn || (masked && t0 + BK - 1 + shift > wq0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok =
              !edge || (col < Tn && (!masked || col + shift <= row));
          const float p =
              ok ? exp2f(s[n][e] * sl - (e < 2 ? ls0 : ls1)) : 0.f;
          s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * scale;
        }

      // dQ += dS K over k = the tile's key rows: dS rounded to K's dtype
      // in registers as the A fragment, K's B fragments by ldmatrix.trans.
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        const uint32_t da[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, frag_a<LD>(Kt, kt * 16, dn * 16, lane));
          mma_bf16(acc[2 * dn], da, bf[0], bf[1]);
          mma_bf16(acc[2 * dn + 1], da, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this half
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // Row row0 holds fragment entries 0, 1 and row row1 entries 2, 3; each
  // lane writes two neighbouring columns of every n-tile.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= S) continue;
    uint32_t* dqr = reinterpret_cast<uint32_t*>(dq + q_off + (size_t)row * D +
                                                2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < ND; ++n)
      dqr[n * 4] = pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int H, int Hkv,
                          int S, int Tn, int masked, int shift, float scale,
                          cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (2 * BQ + 4 * BK) * (D + 8);
  auto kern = flash_bwd_dq_kernel_mma<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hkv, S, Tn, masked, shift, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S, int T) {
  return B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
         B * H > 65535;
}

}  // namespace

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
    return (int)launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                Hkv, S, T, masked, shift, scale, st);
  if (!is_bf16 && D == 128)
    return (int)launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                 Hkv, S, T, masked, shift, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, S, D) in the input dtype; bf16 runs the tensor-core kernel,
// f32 the scalar one, as flash_bwd_dkdv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int Hkv, int S, int T, int D, int is_bf16,
                            int masked, int shift, float scale,
                            void* stream) {
  if (bad_shape(B, H, Hkv, S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64)
    return (int)launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                  S, T, masked, shift, scale, st);
  if (is_bf16 && D == 128)
    return (int)launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                   S, T, masked, shift, scale, st);
  if (!is_bf16 && D == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S,
                              T, masked, shift, scale, st);
  if (!is_bf16 && D == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, S,
                               T, masked, shift, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
