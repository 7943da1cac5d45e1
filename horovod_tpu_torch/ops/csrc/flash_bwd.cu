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
// to the input dtype once.  The bf16 kernels multiply the bf16 operands
// exactly on the tensor cores and accumulate in f32; the f32 kernels use
// f32 FMAs throughout (TF32 would miss the f32 contract).
//
// The TPU's sequential grid axis becomes a loop inside the CTA, and
// every output element is written once, by one CTA, in an order fixed by
// the shapes (no atomics: two calls are bit-identical, which the train
// step's captured-against-eager gates rest on):
//   K2: a CTA owns a block of K/V rows of one kv head and loops over the
//       G query heads of its group and over the Q blocks, so dk/dv of a
//       GQA group are summed inside the CTA, with no expanded dk/dv.
//   K3: a CTA owns a block of Q rows of one head and loops over the K
//       blocks of kv head h / G.
// Fusing dq into K2, as FlashAttention-2 and -3 do, would need f32
// atomics, whose order changes from run to run; so the two kernels
// recompute S and dP each, seven products against a fused kernel's five.
//
// Bound on an H100: at the training shape (B=8, H=16, S=T=2048, D=64,
// bf16, causal) K2 does 8*D FLOPs and K3 6*D per visible (row, col)
// pair, ~137 and ~103 GFLOP against ~50 MB of inputs and outputs, so the
// tensor-core rate bounds both (0.14 and 0.10 ms at 989 TFLOP/s), not
// HBM.  What keeps a kernel from it: feeding the tensor cores (only
// wgmma reaches their rate, and only with its operands in shared memory
// or registers ahead of time), the exp of every score (the SFU's 16 a
// clock an SM: 8192 a 128 x 64 tile), and the chain inside a step
// (products, exp, dS, products) that a warpgroup runs in order.
//
// bf16, wgmma fed by TMA (`flash_bwd_dkdv_kernel_wgmma`,
// `flash_bwd_dq_kernel_wgmma`; wgmma_tma.cuh): a CTA of three
// warpgroups.  The first produces: K2's warp 0 (K3's thread 0) keeps a
// WG_STAGES-deep ring of 64-row tiles in flight by TMA, 128-byte
// swizzled, completing on mbarriers (K2: Q and dO, with the stage's lse
// and delta rows stored by the warp's lanes, loaded a step ahead; K3: K
// and V), and gives its registers to the consumers (setmaxnreg 24 / 240).
// Its resident tiles (K2: the CTA's 128 K and V rows; K3: its 128 Q and
// dO rows) land once, by TMA, before the first step.  The other two
// warpgroups each own 64 of the CTA's rows.  Per step, a warpgroup:
//   K2: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands
//       K-major in shared memory: computed transposed, so no tile is
//       ever transposed in memory), P^T = exp2(S^T scale log2e - lse
//       log2e) by the SFU with no branch, masks only on tiles crossing
//       the diagonal or the S edge, then dV += P^T dO (wgmma with A from
//       registers: the f32 fragment of P^T packed to bf16 is the A
//       fragment; dO read MN-major) issued before dS^T = P^T (dP^T -
//       delta) scale is taken, then dK += dS^T Q likewise.
//   K3: S = Q K^T and dP = dO V^T, P and dS as in K2, dQ += dS K (A from
//       registers, K read MN-major).
// dK and dV (K2), dQ (K3) stay in f32 registers until one write at the
// end.  Both warpgroups take every step of the CTA (a tile wholly past a
// warpgroup's diagonal is masked to zeros), so the products' control flow
// is the same for every thread: ptxas serialises every wgmma of a kernel
// whose waits it cannot prove uniform.  The grid puts the CTAs of one
// head side by side (K blocks, or Q blocks longest first, fastest), so
// the rows they all stream come from L2.  Tensor maps are encoded on the
// host for each call and passed as __grid_constant__ parameters; the
// kernels allocate nothing and never synchronise, so they run inside a
// CUDA graph.
//
// f32 (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`): register-tiled
// FFMA fed by 16-byte cp.async, as the f32 K1 (flash_fwd.cu).  In f32
// the bound is the FMA rate outside the tensor cores (67 TFLOP/s: 2.05
// ms for K2 and 1.54 for K3 at the training shape); TF32 would round the
// products to 10 mantissa bits and miss the f32 contract.  What keeps an
// FFMA kernel from that rate is feeding it: the scalar kernels these
// replace read one shared float every two FMAs and landed their tiles 4
// bytes at a time between barriers.  A CTA owns a block of rows (K2:
// keys of one kv head; K3: queries of one head), landed once, and
// streams the other side's rows through two cp.async stages (zeros past
// S and T), 64 rows a stage at D = 64 and 32 at D = 128, so the next
// stage lands while this one is multiplied.  A thread keeps 4 own rows x
// 4 (2) streamed columns of each score tile and 4 own rows x D / 16
// columns of each output in registers, and reads every operand as a
// 16-byte shared load: 8 FMAs a load in every product.  Per stage:
//   K3: S = Q K^T and dP = dO V^T, p = exp2(s sl - lse log2e) by one
//       FMA (sl = scale log2e), ds = p (dp - delta) scale, dS through
//       shared memory to the warp that wrote it, dQ += dS K.
//   K2: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T likewise through
//       two shared tiles, then dV += P^T dO and dK += dS^T Q side by
//       side in one pass.
// Masks apply only on stages that cross T or a shifted diagonal; a
// masked element gives p = 0 exactly, so a fully masked row (lse =
// NEG_INF) gives 0.  Rows read across a tile are padded by 4 floats (the
// 16 rows a half-warp reads at one column fall on distinct 16-byte bank
// groups), P's and dS's by 16 (a warp's two rows do).  One CTA an SM:
// K3 128 rows on 512 threads (128 registers; 177 KB of shared memory at
// D = 64, 222 KB at D = 128); K2 128 rows at D = 64 (217 KB), 96 on 384
// threads at D = 128 (168 registers for its 64 accumulators of dK and
// dV; 202 KB).  The grid runs heads fastest and the longest blocks first
// (K2: the lowest keys; K3: the last queries).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

using hvd_mma::cp_async16;
using hvd_mma::cp_async4;
using hvd_mma::cp_async_commit;
using hvd_mma::cp_async_wait;

constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

// --- K2 and K3 in f32: register-tiled FFMA fed by cp.async ------------------

constexpr int F_RPT = 4;  // own rows a thread

// A CTA of ROWS own rows (K2: keys; K3: queries) on ROWS / F_RPT row
// groups x 16 columns of threads.  Shared memory, in floats: two
// resident tiles [ROWS][LD] (K2: K, V; K3: Q, dO), two stages of two
// streamed tiles [STEP][LD] (K2: Q, dO, then the stage's lse and delta
// [STEP] each; K3: K, V), then NP tiles [ROWS][LDP] (K2: P^T and dS^T;
// K3: dS).
template <int D, int ROWS, int NP>
struct F32Bwd {
  static constexpr int DIM = D;
  static constexpr int RG = ROWS / F_RPT;         // row groups
  static constexpr int THREADS = RG * 16;
  static constexpr int STEP = D == 64 ? 64 : 32;  // streamed rows a stage
  static constexpr int SC = STEP / 16;            // score columns a thread
  static constexpr int OV = D / 64;               // output float4s a row
  static constexpr int LD = D + 4;
  static constexpr int LDP = STEP + 16;
  static constexpr int OWN = ROWS * LD;
  static constexpr int TILE = STEP * LD;
  static constexpr int STAGE = 2 * TILE + 2 * STEP;
  static constexpr int P_TILE = ROWS * LDP;
  static constexpr int SMEM = 4 * (2 * OWN + 2 * STAGE + NP * P_TILE);
};

// c[i][j] = sum over d of A[ty + RG i][d] B[tx + 16 j][d]: 4 deep a
// step, F_RPT float4 of A (the thread's own rows, the same for its
// half-warp) and SC float4 of B, one fmaf chain in d order an element.
template <class L>
__device__ __forceinline__ void scores(float (&c)[F_RPT][L::SC],
                                       const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < F_RPT; ++i)
#pragma unroll
    for (int j = 0; j < L::SC; ++j) c[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < L::DIM; d += 4) {
    float4 a[F_RPT], b[L::SC];
#pragma unroll
    for (int i = 0; i < F_RPT; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + L::RG * i) * L::LD + d);
#pragma unroll
    for (int j = 0; j < L::SC; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * L::LD + d);
#pragma unroll
    for (int i = 0; i < F_RPT; ++i)
#pragma unroll
      for (int j = 0; j < L::SC; ++j) {
        float s = c[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        c[i][j] = fmaf(a[i].w, b[j].w, s);
      }
  }
}

// acc[i][4 h + e] += sum over r < STEP of P[ty + RG i][r] M[r][64 h +
// 4 tx + e]: 4 rows of M a step, F_RPT float4 of P (rows this warp
// wrote), then for each row D / 64 float4 of M; one fmaf chain in r
// order an element.
template <class L>
__device__ __forceinline__ void accumulate(float (&acc)[F_RPT][4 * L::OV],
                                           const float* P, const float* M,
                                           int ty, int tx) {
#pragma unroll
  for (int r = 0; r < L::STEP; r += 4) {
    float4 pv[F_RPT];
#pragma unroll
    for (int i = 0; i < F_RPT; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (ty + L::RG * i) * L::LDP +
                                               r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 mv[L::OV];
#pragma unroll
      for (int h = 0; h < L::OV; ++h)
        mv[h] = *reinterpret_cast<const float4*>(M + (r + u) * L::LD +
                                                 64 * h + 4 * tx);
#pragma unroll
      for (int i = 0; i < F_RPT; ++i) {
        const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int h = 0; h < L::OV; ++h) {
          acc[i][4 * h] = fmaf(p, mv[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(p, mv[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(p, mv[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(p, mv[h].w, acc[i][4 * h + 3]);
        }
      }
    }
  }
}

// The same for two products side by side, a1 += P1 M1 and a2 += P2 M2,
// their loads and FMAs interleaved.  (One helper over an array of
// accumulators spilled at D = 64 on the card, where this does not.)
template <class L>
__device__ __forceinline__ void accumulate2(float (&a1)[F_RPT][4 * L::OV],
                                            const float* P1, const float* M1,
                                            float (&a2)[F_RPT][4 * L::OV],
                                            const float* P2, const float* M2,
                                            int ty, int tx) {
#pragma unroll
  for (int r = 0; r < L::STEP; r += 4) {
    float4 pv[F_RPT], qv[F_RPT];
#pragma unroll
    for (int i = 0; i < F_RPT; ++i) {
      const int off = (ty + L::RG * i) * L::LDP + r;
      pv[i] = *reinterpret_cast<const float4*>(P1 + off);
      qv[i] = *reinterpret_cast<const float4*>(P2 + off);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 m1[L::OV], m2[L::OV];
#pragma unroll
      for (int h = 0; h < L::OV; ++h) {
        const int off = (r + u) * L::LD + 64 * h + 4 * tx;
        m1[h] = *reinterpret_cast<const float4*>(M1 + off);
        m2[h] = *reinterpret_cast<const float4*>(M2 + off);
      }
#pragma unroll
      for (int i = 0; i < F_RPT; ++i) {
        const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
        const float d = u == 0 ? qv[i].x : u == 1 ? qv[i].y
                        : u == 2 ? qv[i].z : qv[i].w;
#pragma unroll
        for (int h = 0; h < L::OV; ++h) {
          a1[i][4 * h] = fmaf(p, m1[h].x, a1[i][4 * h]);
          a1[i][4 * h + 1] = fmaf(p, m1[h].y, a1[i][4 * h + 1]);
          a1[i][4 * h + 2] = fmaf(p, m1[h].z, a1[i][4 * h + 2]);
          a1[i][4 * h + 3] = fmaf(p, m1[h].w, a1[i][4 * h + 3]);
          a2[i][4 * h] = fmaf(d, m2[h].x, a2[i][4 * h]);
          a2[i][4 * h + 1] = fmaf(d, m2[h].y, a2[i][4 * h + 1]);
          a2[i][4 * h + 2] = fmaf(d, m2[h].z, a2[i][4 * h + 2]);
          a2[i][4 * h + 3] = fmaf(d, m2[h].w, a2[i][4 * h + 3]);
        }
      }
    }
  }
}

// Rows [r0, r0 + n) of a (rows, D) matrix into a padded tile by 16-byte
// cp.async, zeros past `rows`.
template <class L>
__device__ __forceinline__ void land_rows(float* dst, const float* src,
                                          int r0, int rows, int n) {
  constexpr int V = L::DIM / 4;  // float4s a row
  for (int i = threadIdx.x; i < n * V; i += L::THREADS) {
    const int r = i / V, c = i % V * 4;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * L::LD + c,
               src + (ok ? (size_t)(r0 + r) * L::DIM + c : 0),
               ok ? 16 : 0);
  }
}

// An accumulator's rows [r0, r0 + ROWS), rows past `rows` dropped.
template <class L>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[F_RPT][4 * L::OV],
                                           int r0, int rows, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < F_RPT; ++i) {
    const int row = r0 + ty + L::RG * i;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < L::OV; ++h) {
      float4 o;
      o.x = acc[i][4 * h];
      o.y = acc[i][4 * h + 1];
      o.z = acc[i][4 * h + 2];
      o.w = acc[i][4 * h + 3];
      *reinterpret_cast<float4*>(dst + (size_t)row * L::DIM + 64 * h + 4 * tx) =
          o;
    }
  }
}

// K2.  Thread (ty, tx) = (tid / 16, tid % 16) owns key rows ty + RG i
// (a warp's two row groups are its own, so P^T and dS^T need no
// barrier), query columns tx + 16 j of each stage, and columns 64 h + 4
// tx .. + 3 of dK and dV.  Each dK / dV element is one fmaf chain over
// the group's heads g, then query rows ascending; a query a key cannot
// see adds p = ds = 0 exactly, so a row's bits do not depend on its CTA
// or the stage.
template <int D, int ROWS>
__global__ void __launch_bounds__(ROWS * 4, 1) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int S,
    int Tn, int masked, int shift, float scale) {
  using L = F32Bwd<D, ROWS, 2>;
  constexpr int STEP = L::STEP, SC = L::SC, R = F_RPT, RG = L::RG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + L::OWN;
  float* ring = Vs + L::OWN;
  float* Ps = ring + 2 * L::STAGE;  // P^T
  float* Ds = Ps + L::P_TILE;       // dS^T

  const int bk = blockIdx.x;  // b * Hkv + hk: kv heads fastest
  const int b = bk / Hkv, hk = bk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * ROWS;  // under the mask the longest first
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t kv_off = (size_t)bk * Tn * D;

  // Q blocks wholly above the shifted diagonal contribute nothing: the
  // first that does has q0 + STEP - 1 >= k0 + shift.
  int qb_begin = 0;
  if (masked) {
    const int lo = k0 + shift - (STEP - 1);
    if (lo > 0) qb_begin = (lo + STEP - 1) / STEP;
  }
  const int per_head = max(0, (S + STEP - 1) / STEP - qb_begin);
  const int n_steps = G * per_head;

  // Stage s <- step n: head g's query rows [q0, q0 + STEP), zeros past S.
  auto load_step = [&](int n, int s) {
    const int bh = b * H + hk * G + n / per_head;
    const int q0 = (qb_begin + n % per_head) * STEP;
    float* Qt = ring + s * L::STAGE;
    float* Ot = Qt + L::TILE;
    float* lt = Ot + L::TILE;
    land_rows<L>(Qt, q + (size_t)bh * S * D, q0, S, STEP);
    land_rows<L>(Ot, dout + (size_t)bh * S * D, q0, S, STEP);
    for (int i = tid; i < STEP; i += L::THREADS) {
      const bool ok = q0 + i < S;
      const size_t off = (size_t)bh * S + (ok ? q0 + i : 0);
      cp_async4(lt + i, lse + off, ok ? 4 : 0);
      cp_async4(lt + STEP + i, delta + off, ok ? 4 : 0);
    }
  };
  // Two groups in flight ahead of the loop: K and V with step 0, step 1.
  // A CTA with no step copies nothing and writes dK = dV = 0.
  if (n_steps > 0) {
    land_rows<L>(Ks, k + kv_off, k0, Tn, ROWS);
    land_rows<L>(Vs, v + kv_off, k0, Tn, ROWS);
    load_step(0, 0);
  }
  cp_async_commit();
  if (n_steps > 1) load_step(1, 1);
  cp_async_commit();

  float dv_acc[R][4 * L::OV], dk_acc[R][4 * L::OV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::OV; ++c) dv_acc[i][c] = dk_acc[i][c] = 0.f;
  const float sl = scale * LOG2E;  // exp(s scale) = exp2(s sl)

  for (int n = 0; n < n_steps; ++n) {
    const int s = n & 1;
    cp_async_wait<1>();  // step n (and K, V) landed; step n + 1 in flight
    __syncthreads();
    const float* Qt = ring + s * L::STAGE;
    const float* Ot = Qt + L::TILE;
    const float* lt = Ot + L::TILE;
    const int q0 = (qb_begin + n % per_head) * STEP;
    float c[R][SC], dp[R][SC];
    scores<L>(c, Ks, Qt, ty, tx);   // S^T = K Q^T
    scores<L>(dp, Vs, Ot, ty, tx);  // dP^T = V dO^T
    // Columns past S read lse = delta = 0 and zero rows: p = 1 against a
    // zero dO row and ds = 0, so they add exact zeros.
    const bool edge = masked && k0 + ROWS - 1 + shift > q0;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const float nl = -lt[tx + 16 * j] * LOG2E, dl = lt[STEP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float p = exp2f(fmaf(c[i][j], sl, nl));
        if (edge && k0 + ty + RG * i + shift > q0 + tx + 16 * j) p = 0.f;
        const int e = (ty + RG * i) * L::LDP + tx + 16 * j;
        Ps[e] = p;
        Ds[e] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncwarp();  // a key row's P^T and dS^T come from its own warp
    accumulate2<L>(dv_acc, Ps, Ot, dk_acc, Ds, Qt, ty, tx);  // dV, dK
    __syncthreads();  // stage s, P^T and dS^T read by every thread
    if (n + 2 < n_steps) load_step(n + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<L>(dk + kv_off, dk_acc, k0, Tn, ty, tx);
  store_rows<L>(dv + kv_off, dv_acc, k0, Tn, ty, tx);
}

// K3.  Thread (ty, tx) owns query rows ty + RG i, key columns tx + 16
// j of each stage, and columns 64 h + 4 tx .. + 3 of dQ.  Each dQ
// element is one fmaf chain over keys ascending from 0 (a key past the
// row's diagonal adds ds = 0 exactly), so a row's bits do not depend on
// its CTA, S, or the stage.
template <int D, int ROWS>
__global__ void __launch_bounds__(ROWS * 4, 1) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int S, int Tn, int masked,
    int shift, float scale) {
  using L = F32Bwd<D, ROWS, 1>;
  constexpr int STEP = L::STEP, SC = L::SC, R = F_RPT, RG = L::RG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + L::OWN;
  float* ring = Os + L::OWN;
  float* Ps = ring + 2 * L::STAGE;

  // Heads fastest, Q blocks longest first: every head's longest CTAs
  // start in the first wave.
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_off = (size_t)bh * S * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;

  // Masked: stages starting past this CTA's last row's shifted diagonal
  // contribute nothing.
  const int t_end = masked ? min(Tn, max(0, q0 + ROWS - shift)) : Tn;
  const int n_tiles = (t_end + STEP - 1) / STEP;

  auto load_tile = [&](int t, int s) {  // stage s <- keys [t STEP, +STEP)
    float* Kt = ring + s * L::STAGE;
    land_rows<L>(Kt, k + kv_off, t * STEP, Tn, STEP);
    land_rows<L>(Kt + L::TILE, v + kv_off, t * STEP, Tn, STEP);
  };
  if (n_tiles > 0) {
    land_rows<L>(Qs, q + q_off, q0, S, ROWS);
    land_rows<L>(Os, dout + q_off, q0, S, ROWS);
    load_tile(0, 0);
  }
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  // The own rows' -lse log2e and delta (rows past S: 0, never stored).
  float nl[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + RG * i;
    nl[i] = row < S ? -lse[(size_t)bh * S + row] * LOG2E : 0.f;
    dl[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[R][4 * L::OV];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::OV; ++c) acc[i][c] = 0.f;
  const float sl = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    cp_async_wait<1>();  // tile t (and Q, dO) landed; tile t + 1 in flight
    __syncthreads();
    const float* Kt = ring + s * L::STAGE;
    const float* Vt = Kt + L::TILE;
    float c[R][SC], dp[R][SC];
    scores<L>(c, Qs, Kt, ty, tx);   // S = Q K^T
    scores<L>(dp, Os, Vt, ty, tx);  // dP = dO V^T
    // Keys past T are zero rows, whose p = exp(-lse) could overflow:
    // masked, with the shifted diagonal, on the tiles that cross either.
    const int t0 = t * STEP;
    const bool edge =
        t0 + STEP > Tn || (masked && t0 + STEP - 1 + shift > q0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + RG * i;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = t0 + tx + 16 * j;
        float p = exp2f(fmaf(c[i][j], sl, nl[i]));
        if (edge && (col >= Tn || (masked && col + shift > row))) p = 0.f;
        Ps[(ty + RG * i) * L::LDP + tx + 16 * j] =
            p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncwarp();  // a row's dS comes from its own warp
    accumulate<L>(acc, Ps, Kt, ty, tx);  // dQ += dS K
    __syncthreads();  // stage s and dS read by every thread
    if (t + 2 < n_tiles) load_tile(t + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<L>(dq + q_off, acc, q0, S, ty, tx);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Own rows a CTA: K3 128 (512 threads, 128 registers a thread); K2 128
// at D = 64, 96 at D = 128 (384 threads, so 168 registers a thread: dK
// and dV take 64 of them, and at 128 rows the products spilled).
constexpr int DQ_ROWS = 128;
template <int D>
constexpr int DKDV_ROWS = D == 64 ? 128 : 96;

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int Hkv, int S,
                        int Tn, int masked, int shift, float scale,
                        cudaStream_t st) {
  constexpr int ROWS = DKDV_ROWS<D>;
  using L = F32Bwd<D, ROWS, 2>;
  auto kern = flash_bwd_dkdv_kernel<D, ROWS>;
  cudaError_t err = allow_smem(kern, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (Tn + ROWS - 1) / ROWS);
  kern<<<grid, L::THREADS, L::SMEM, st>>>(
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
  using L = F32Bwd<D, DQ_ROWS, 1>;
  auto kern = flash_bwd_dq_kernel<D, DQ_ROWS>;
  cudaError_t err = allow_smem(kern, L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + DQ_ROWS - 1) / DQ_ROWS);
  kern<<<grid, L::THREADS, L::SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Hkv, S, Tn, masked, shift, scale);
  return cudaGetLastError();
}

// --- K2 and K3 in bf16: wgmma + TMA -----------------------------------------

using hvd_wgmma::map_heads;
typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 384;  // the producer warpgroup + 2 consumers
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_ROWS = 128;  // a CTA's own rows: K2's K/V, K3's Q
constexpr int WG_STEP = 64;   // the rows a ring stage streams
constexpr int WG_STAGES = 4;
constexpr int BOX_COLS = 64;  // a TMA box row: one 128-byte swizzle line

// Shared memory of K2 and K3 (byte offsets from a 1024-byte aligned
// base): the CTA's two resident tiles (K and V, or Q and dO; WG_ROWS
// rows), then a ring of WG_STAGES stages of two streamed tiles (Q and dO,
// or K and V; WG_STEP rows), each tile D / 64 boxes of 64 columns, box
// after box; then K2's lse and delta rows of each stage, then the
// mbarriers.
template <int D>
struct WgLayout {
  static constexpr int NB = D / BOX_COLS;
  static constexpr int RES_BOX = WG_ROWS * BOX_COLS * 2;  // bytes
  static constexpr int STEP_BOX = WG_STEP * BOX_COLS * 2;
  static constexpr int RES = NB * RES_BOX;    // a resident tile
  static constexpr int TILE = NB * STEP_BOX;  // a streamed tile
  static constexpr int RING = 2 * RES;
  static constexpr int ROWS = RING + WG_STAGES * 2 * TILE;  // lse, delta
  static constexpr int BARS = ROWS + 2 * WG_STAGES * WG_STEP * 4;
  // full[WG_STAGES], empty[WG_STAGES], then the resident tiles' barrier.
  static constexpr int SMEM = 1024 /* alignment slack */ + BARS +
                              (2 * WG_STAGES + 1) * 8;
};

// K2 in bf16.  A CTA: one kv head's WG_ROWS K/V rows (grid (K blocks,
// B * H_kv): the CTAs of one kv head run side by side, so the Q and dO
// rows they all stream are read from L2); warp 0 produces, warpgroups 1
// and 2 each own 64 of the rows.  The ring walks the (query head of the
// group, Q block) steps.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_bwd_dkdv_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Hkv, int S, int Tn, int masked,
    int shift, float scale) {
  using namespace hvd_wgmma;
  using L = WgLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  float* s_lse = reinterpret_cast<float*>(base + L::ROWS);
  float* s_delta = s_lse + WG_STAGES * WG_STEP;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* kv_full = empty + WG_STAGES;

  const int bk = blockIdx.y;  // b * Hkv + hk
  const int b = bk / Hkv, hk = bk % Hkv, G = H / Hkv;
  const int k0 = blockIdx.x * WG_ROWS;
  // Q blocks wholly above the shifted diagonal contribute nothing: the
  // first that does has q0 + WG_STEP - 1 >= k0 + shift.
  int qb_begin = 0;
  if (masked) {
    const int lo = k0 + shift - (WG_STEP - 1);
    if (lo > 0) qb_begin = (lo + WG_STEP - 1) / WG_STEP;
  }
  const int nq = max(0, (S + WG_STEP - 1) / WG_STEP - qb_begin);
  const int steps = G * nq;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's arrival, the lse writers'
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    mbar_init(kv_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: warp 0
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32 || steps == 0) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::RES);
#pragma unroll
      for (int j = 0; j < L::NB; ++j) {
        tma_load_3d(base + j * L::RES_BOX, &tm_k, BOX_COLS * j, k0, bk,
                    kv_full);
        tma_load_3d(base + L::RES + j * L::RES_BOX, &tm_v, BOX_COLS * j, k0,
                    bk, kv_full);
      }
    }
    // lse (in log2 units) and delta of a step's rows (0 past S), two a
    // lane, loaded one step ahead so that their latency hides behind the
    // wait for a free stage.
    float nxt[4];
    auto rows = [&](int i) {
      const int bh = b * H + hk * G + i / nq;
      const int q0 = (qb_begin + i % nq) * WG_STEP;
      const size_t r_off = (size_t)bh * S + q0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = q0 + lane + 32 * h < S;
        nxt[h] = in ? lse[r_off + lane + 32 * h] * LOG2E : 0.f;
        nxt[2 + h] = in ? delta[r_off + lane + 32 * h] : 0.f;
      }
    };
    rows(0);
    for (int i = 0; i < steps; ++i) {
      const int stage = i % WG_STAGES;
      const int bh = b * H + hk * G + i / nq;
      const int q0 = (qb_begin + i % nq) * WG_STEP;
      const float cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
      if (i + 1 < steps) rows(i + 1);
      mbar_wait(&empty[stage], ((i / WG_STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * L::TILE);
        unsigned char* t = base + L::RING + stage * 2 * L::TILE;
#pragma unroll
        for (int j = 0; j < L::NB; ++j) {
          tma_load_3d(t + j * L::STEP_BOX, &tm_q, BOX_COLS * j, q0, bh,
                      &full[stage]);
          tma_load_3d(t + L::TILE + j * L::STEP_BOX, &tm_o, BOX_COLS * j, q0,
                      bh, &full[stage]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_lse[stage * WG_STEP + lane + 32 * h] = cur[h];
        s_delta[stage * WG_STEP + lane + 32 * h] = cur[2 + h];
      }
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // The consumers: warpgroup wg owns K rows j0 .. j0 + 63.
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int j0 = k0 + 64 * wg;
  const int jr = j0 + 16 * warp + (lane >> 2);  // rows jr and jr + 8
  const int tq = 2 * (lane & 3);  // the lane's first column of 8
  const unsigned char* sk = base + 64 * wg * 128;  // the warpgroup's rows
  const unsigned char* sv = sk + L::RES;
  const float sl = scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  if (steps > 0) mbar_wait(kv_full, 0);

  // Both warpgroups take every step of the CTA (a tile wholly above a
  // warpgroup's diagonal, or rows past T, are masked to zeros or never
  // stored), so the products' control flow is the same for every thread:
  // a wait that ptxas must place on a path it cannot prove uniform
  // serialises every wgmma of the kernel.  At D = 64 a step's dV and dK
  // products run on while the warpgroup waits for the next tile and
  // issues its S^T and dP^T (their A registers and their stage stay held
  // until then); at D = 128 their A registers beside dK's and dV's 128
  // accumulators would not fit, so each step's products are waited for
  // at once.
  constexpr bool DEFER = D == 64;
  uint32_t pa[4][4], da[4][4];  // P^T and dS^T, the A of dV and dK
  for (int it = 0; it < steps; ++it) {
    const int stage = it % WG_STAGES;
    const int q0 = (qb_begin + it % nq) * WG_STEP;
    mbar_wait(&full[stage], (it / WG_STAGES) & 1);
    const unsigned char* sq = base + L::RING + stage * 2 * L::TILE;
    const unsigned char* so = sq + L::TILE;
    const float* lt = s_lse + stage * WG_STEP;
    const float* dt = s_delta + stage * WG_STEP;
    // S^T = K Q^T and dP^T = V dO^T, both operands K-major in shared
    // memory, two commit groups.
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(st, kmajor(sk, L::RES_BOX, kk),
                         kmajor(sq, L::STEP_BOX, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(dpt, kmajor(sv, L::RES_BOX, kk),
                         kmajor(so, L::STEP_BOX, kk), kk > 0);
    wgmma_commit();

    // Element (K row j, query row qi): p = exp(s * scale - lse_qi), 0
    // where masked (so fully masked rows, lse = NEG_INF, give 0), while
    // dP^T is still on the tensor cores.  Every exp is taken, with no
    // branch; only tiles crossing the diagonal or the S edge then test
    // elements.
    wgmma_wait<1>();
    fence_all(st);
    if (DEFER && it > 0) {  // the previous step's products are done
      keep_frags(pa);
      keep_frags(da);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * n + tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * n + e] =
            fast_exp2(fmaf(st[4 * n + e], sl, (e & 1) ? -l2.y : -l2.x));
    }
    if (q0 + WG_STEP > S || (masked && j0 + 63 + shift > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = q0 + 8 * (i / 4) + tq + (i & 1);
        const int j = jr + 8 * ((i >> 1) & 1);
        if (!(qi < S && (!masked || j + shift <= qi))) st[i] = 0.f;
      }
    }
    // dV += P^T dO over k = the tile's query rows (A: P^T rounded to
    // dO's dtype, from registers; dO read MN-major, no transpose in
    // memory), on the tensor cores while dS^T is taken.
    to_a_frags(st, pa);
    fence_all(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dva, pa[kk], mnmajor(so, kk, L::STEP_BOX), 1);
    wgmma_commit();

    // ds = p (dp - delta_qi) scale, once dP^T is in (dV may still run).
    wgmma_wait<1>();
    fence_all(dpt);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * n + tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * n + e] = st[4 * n + e] *
                         (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    // dK += dS^T Q (dS^T rounded to Q's dtype, Q read MN-major).
    to_a_frags(dpt, da);
    fence_all(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dka, da[kk], mnmajor(sq, kk, L::STEP_BOX), 1);
    wgmma_commit();
    if (!DEFER) {
      wgmma_wait<0>();
      keep_frags(pa);
      keep_frags(da);
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
  }
  if (DEFER && steps > 0) {
    wgmma_wait<0>();
    keep_frags(pa);
    keep_frags(da);
    if (lane == 0) mbar_arrive(&empty[(steps - 1) % WG_STAGES]);
  }
  fence_all(dva);
  fence_all(dka);

  // Row jr holds fragment entries 4n, 4n + 1 and row jr + 8 entries
  // 4n + 2, 4n + 3 of every 8 columns; each lane writes two neighbours.
  const size_t kv_off = (size_t)bk * Tn * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = jr + 8 * h;
    if (j >= Tn) continue;
    uint32_t* dkr = reinterpret_cast<uint32_t*>(dk + kv_off + (size_t)j * D + tq);
    uint32_t* dvr = reinterpret_cast<uint32_t*>(dv + kv_off + (size_t)j * D + tq);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dkr[n * 4] = pack_bf16(dka[4 * n + 2 * h], dka[4 * n + 2 * h + 1]);
      dvr[n * 4] = pack_bf16(dva[4 * n + 2 * h], dva[4 * n + 2 * h + 1]);
    }
  }
}

// K3 in bf16.  A CTA: one head's WG_ROWS Q rows (grid (Q blocks, B * H),
// a head's longest causal tiles first, its CTAs side by side so that the
// K and V tiles they all stream are read from L2); thread 0 produces,
// warpgroups 1 and 2 each own 64 of the rows.  The ring walks the K/V
// tiles of kv head h / G.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_bwd_dq_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_o, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Hkv,
    int S, int Tn, int masked, int shift, float scale) {
  using namespace hvd_wgmma;
  using L = WgLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* q_full = empty + WG_STAGES;

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;
  // K tiles starting past the shifted diagonal of this CTA's last row
  // contribute nothing: k0 + shift <= q0 + WG_ROWS - 1 is needed.
  const int k_end = masked ? min(Tn, max(0, q0 + WG_ROWS - shift)) : Tn;
  const int n_tiles = (k_end + WG_STEP - 1) / WG_STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer: thread 0
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0 || n_tiles == 0) return;
    mbar_arrive_expect_tx(q_full, 2 * L::RES);
#pragma unroll
    for (int j = 0; j < L::NB; ++j) {
      tma_load_3d(base + j * L::RES_BOX, &tm_q, BOX_COLS * j, q0, bh, q_full);
      tma_load_3d(base + L::RES + j * L::RES_BOX, &tm_o, BOX_COLS * j, q0, bh,
                  q_full);
    }
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], 2 * L::TILE);
      unsigned char* t = base + L::RING + stage * 2 * L::TILE;
#pragma unroll
      for (int j = 0; j < L::NB; ++j) {
        tma_load_3d(t + j * L::STEP_BOX, &tm_k, BOX_COLS * j, it * WG_STEP,
                    bkv, &full[stage]);
        tma_load_3d(t + L::TILE + j * L::STEP_BOX, &tm_v, BOX_COLS * j,
                    it * WG_STEP, bkv, &full[stage]);
      }
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns Q rows r0 .. r0 + 63.
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int r0 = q0 + 64 * wg;
  const int row = r0 + 16 * warp + (lane >> 2);  // rows row and row + 8
  const int tq = 2 * (lane & 3);
  const unsigned char* sq = base + 64 * wg * 128;  // the warpgroup's rows
  const unsigned char* so = sq + L::RES;
  const float sl = scale * LOG2E;
  // lse (in log2 units) and delta of the lane's two rows (0 past S).
  float ls[2], dl[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    ls[h2] = r < S ? lse[(size_t)bh * S + r] * LOG2E : 0.f;
    dl[h2] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }

  // Both warpgroups take every tile of the CTA (a tile wholly past a
  // warpgroup's diagonal is masked to zeros; rows past S are never
  // stored), so the products' control flow is the same for every thread,
  // as K2's.
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % WG_STAGES, t0 = it * WG_STEP;
    mbar_wait(&full[stage], (it / WG_STAGES) & 1);
    const unsigned char* skt = base + L::RING + stage * 2 * L::TILE;
    const unsigned char* svt = skt + L::TILE;
    // S = Q K^T and dP = dO V^T, both operands K-major in shared memory,
    // two commit groups.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(s, kmajor(sq, L::RES_BOX, kk),
                         kmajor(skt, L::STEP_BOX, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0, 0>(dp, kmajor(so, L::RES_BOX, kk),
                         kmajor(svt, L::STEP_BOX, kk), kk > 0);
    wgmma_commit();

    // p = exp(s * scale - lse), 0 where masked (so fully masked rows,
    // lse = NEG_INF, give 0), while dP is on the tensor cores; then
    // ds = p (dp - delta) scale.  Every exp is taken, with no branch;
    // only tiles crossing the diagonal or the T edge then test elements.
    wgmma_wait<1>();
    fence_all(s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fast_exp2(fmaf(s[i], sl, -ls[(i >> 1) & 1]));
    if (t0 + WG_STEP > Tn || (masked && t0 + 63 + shift > r0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = t0 + 8 * (i / 4) + tq + (i & 1);
        const int r = row + 8 * ((i >> 1) & 1);
        if (!(col < Tn && (!masked || col + shift <= r))) s[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_all(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * scale;

    // dQ += dS K over k = the tile's key rows: A (dS rounded to K's
    // dtype) from registers, K read MN-major.
    uint32_t da[4][4];
    to_a_frags(dp, da);
    fence_all(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dqa, da[kk], mnmajor(skt, kk, L::STEP_BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dqa);
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  const size_t q_off = (size_t)bh * S * D;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    if (r >= S) continue;
    uint32_t* dqr = reinterpret_cast<uint32_t*>(dq + q_off + (size_t)r * D + tq);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      dqr[n * 4] = pack_bf16(dqa[4 * n + 2 * h2], dqa[4 * n + 2 * h2 + 1]);
  }
}

// K2 (dk_dv 1) or K3 (0) in bf16; tensor maps encoded for this call.
template <int D>
cudaError_t launch_wgmma(int dk_dv, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* d0, void* d1, int B, int H,
                         int Hkv, int S, int Tn, int masked, int shift,
                         float scale, cudaStream_t st) {
  const int q_box = dk_dv ? WG_STEP : WG_ROWS;
  const int kv_box = dk_dv ? WG_ROWS : WG_STEP;
  CUtensorMap tq, tk, tv, to;
  if (!map_heads(&tq, q, B * H, S, D, q_box) ||
      !map_heads(&tk, k, B * Hkv, Tn, D, kv_box) ||
      !map_heads(&tv, v, B * Hkv, Tn, D, kv_box) ||
      !map_heads(&to, dout, B * H, S, D, q_box))
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int smem = WgLayout<D>::SMEM;
  if (dk_dv) {
    auto kern = flash_bwd_dkdv_kernel_wgmma<D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tn + WG_ROWS - 1) / WG_ROWS, B * Hkv);
    kern<<<grid, WG_THREADS, smem, st>>>(
        tq, tk, tv, to, l, dl, static_cast<bf16*>(d0), static_cast<bf16*>(d1),
        H, Hkv, S, Tn, masked, shift, scale);
  } else {
    auto kern = flash_bwd_dq_kernel_wgmma<D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((S + WG_ROWS - 1) / WG_ROWS, B * H);
    kern<<<grid, WG_THREADS, smem, st>>>(tq, tk, tv, to, l, dl,
                                         static_cast<bf16*>(d0), H, Hkv, S,
                                         Tn, masked, shift, scale);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S, int T) {
  return B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
         B * H > 65535;
}

}  // namespace

// dk, dv (B, H_kv, T, D) in the input dtype.  lse and delta are f32
// (B, H, S); q and dout (B, H, S, D); k and v (B, H_kv, T, D).  bf16
// runs the tensor-core kernel, f32 the register-tiled FFMA one; pointers
// must be 16-byte aligned (the wrapper checks).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Hkv, int S, int T, int D,
                              int is_bf16, int masked, int shift,
                              float scale, void* stream) {
  if (bad_shape(B, H, Hkv, S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64)
    return (int)launch_wgmma<64>(1, q, k, v, dout, lse, delta, dk, dv, B, H,
                                 Hkv, S, T, masked, shift, scale, st);
  if (is_bf16 && D == 128)
    return (int)launch_wgmma<128>(1, q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Hkv, S, T, masked, shift, scale, st);
  if (!is_bf16 && D == 64)
    return (int)launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                Hkv, S, T, masked, shift, scale, st);
  if (!is_bf16 && D == 128)
    return (int)launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                 Hkv, S, T, masked, shift, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, S, D) in the input dtype; bf16 runs the tensor-core kernel,
// f32 the register-tiled FFMA one, as flash_bwd_dkdv.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int H,
                            int Hkv, int S, int T, int D, int is_bf16,
                            int masked, int shift, float scale,
                            void* stream) {
  if (bad_shape(B, H, Hkv, S, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64)
    return (int)launch_wgmma<64>(0, q, k, v, dout, lse, delta, dq, nullptr,
                                 B, H, Hkv, S, T, masked, shift, scale, st);
  if (is_bf16 && D == 128)
    return (int)launch_wgmma<128>(0, q, k, v, dout, lse, delta, dq, nullptr,
                                  B, H, Hkv, S, T, masked, shift, scale, st);
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
