// K1: flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/attention.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`).  Same function: tiled
// attention with an online softmax in f32, an optional shifted causal
// mask (position (row, col) attends iff col + shift <= row; shift 0 is
// causal, the runtime scalar of `flash_attention_shifted`), K tiles
// wholly past the shifted diagonal of a CTA's last row skipped, `o` in
// the input dtype and the row logsumexp in f32; a fully masked row gives
// o = 0 and lse = NEG_INF.  Rounding points mirror the JAX kernel:
// s = (q . k) * scale in f32 (bf16 products are exact in f32; the bf16
// kernel takes the scale into its exp's FMA), p cast to V's dtype before
// p . v, f32 accumulation, o cast to the input dtype.
// No atomics: two calls give the same bits.
//
// The shift is a kernel argument, or, with `shift_dev` non-null, an int
// every CTA reads from device memory before it bounds its key loop:
// a CUDA graph bakes arguments passed by value, so the serving engine's
// captured suffix and chunk prefills (one graph for every prefix length
// of a page-count bucket) hand the shift over as a device scalar.  Both
// modes clamp the shift to [-T, S], which keeps the mask.
//
// GQA: K/V keep their H_kv heads and query head h reads kv head
// h / (H / H_kv), the grouping of `jnp.repeat` in `expand_kv`, so no
// expanded copy of K/V is ever materialised.
//
// Bound on an H100: 4 D FLOPs a visible (row, col) pair.  At the serving
// prefill shape (B=2, H=16, H_kv=4, S=T=2048, D=64, bf16, causal) that is
// ~17 GFLOP against ~21 MB of inputs and outputs, and at the training
// shape (B=8, H=16 MHA) ~69 GFLOP against ~34 MB, so the tensor-core rate
// bounds it (0.017 and 0.069 ms at 989 TFLOP/s), not HBM.  What keeps it
// from that: only wgmma reaches the tensor cores' rate, and only with its
// operands in shared memory or registers ahead of time; at D = 64 the
// exp of every score takes the SFU (16 a clock an SM) as long as the
// products take the tensor cores, so the two must overlap; and each
// warpgroup runs its step's chain (S, softmax, rescale) in order.
//
// Two kernels, chosen by dtype in the C entry point (not a fallback: each
// dtype has exactly one kernel):
//
// * bf16, wgmma fed by TMA (`flash_fwd_kernel_wgmma`; wgmma_tma.cuh): a
//   CTA of three warpgroups takes 128 query rows of one head.  The first
//   produces: its thread 0 lands the CTA's Q rows once by TMA, then keeps
//   a four-stage ring of K and V tiles of kv head h / G in flight (128
//   key rows a step at D = 64, 64 at D = 128), 128-byte swizzled,
//   completing on mbarriers; the warpgroup gives its registers to the
//   consumers (setmaxnreg 24 / 240).  The other two each own 64 of the
//   rows.  Step it of a consumer warpgroup issues S_it = Q K_it^T on
//   wgmma with both operands K-major in shared memory (SS), then
//   O += P_{it-1} V_{it-1} with P rounded to bf16 as register A (the f32
//   fragment's own layout) and V read MN-major, and takes the online
//   softmax of S_it while that second product runs: masked scores (only
//   on tiles crossing the diagonal or the T edge) NEG_INF, the row max
//   across a quad by shuffles, p = exp2(s scale log2e - m scale log2e)
//   by one FMA and `ex2.approx` each, with no branch; a row with nothing
//   visible yet takes its exps against 0, so its masked scores give
//   exactly 0.  Only then does it wait for the product, rescale O's f32
//   registers by alpha, release the previous stage and pack P_it.  The
//   two warpgroups issue their products in turns (named barriers), so
//   one's products run while the other takes its softmax.  O stays in
//   f32 registers until one write at the end, o = O / l by rows.  Both
//   warpgroups take every step of the CTA (a tile wholly past a
//   warpgroup's diagonal is masked to zeros), so every wait is uniform:
//   ptxas serialises every wgmma of a kernel whose waits it cannot prove
//   so.  The producer and the consumers count the steps from the same
//   (device) shift; a CTA with none issues no copy and writes o = 0 and
//   lse = NEG_INF.  The grid puts a head's CTAs side by side, longest
//   causal tiles first, so the K and V tiles they all stream come from
//   L2.  Tensor maps (Q over (D, S, B H), K and V over (D, T, B H_kv):
//   rows past S or T land as zeros, a box never reads the next head) are
//   encoded on the host for each call and passed as __grid_constant__
//   parameters; the kernel allocates nothing and never synchronises, so
//   it runs inside the captured tick, admission and train-step graphs.
// * f32 (`flash_fwd_kernel`): register-tiled FFMA fed by cp.async.  In
//   f32 the bound is the FMA rate outside the tensor cores (67 TFLOP/s:
//   0.26 ms at the serving prefill, 1.03 ms at the training shape); TF32
//   tensor cores would round the products to 10 mantissa bits and miss
//   the f32 contract (1e-4 of the plain version, exact greedy tokens).
//   What keeps an FFMA kernel from that rate is feeding it: the scalar
//   kernel it replaced read one shared float an FMA (Q K^T) or two (P V)
//   and landed its tiles 4 bytes at a time between barriers.  Here a CTA
//   of 256 threads takes 64 query rows of one head; Q, and K and V tiles
//   of 64 keys (32 at D = 128), land by 16-byte cp.async (zeros past S
//   and T), K and V into two stages, so the next tile arrives while this
//   one is multiplied.  Each thread keeps 4 rows x 4 key columns of S and
//   4 rows x D / 16 columns of O in registers and reads its operands as
//   16-byte shared loads, 8 FMAs a load in both products (against the
//   scalar kernel's 1 and 1/2).  The softmax runs on the raw scores: a
//   row's max and sum go across its 16 lanes by shuffles, p = exp2(s sl
//   - m sl) by one FMA (sl = scale log2 e), masked scores (only on tiles
//   crossing T or a shifted diagonal) NEG_INF; P goes through shared
//   memory to the warp that wrote it.  The grid runs heads fastest and
//   Q blocks longest first.  No spill at D = 128 (128 registers a
//   thread, two CTAs an SM).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

using hvd_mma::cp_async16;
using hvd_mma::cp_async_commit;
using hvd_mma::cp_async_wait;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

// --- f32: register-tiled FFMA fed by cp.async ------------------------------

constexpr int F_BQ = 64;   // query rows a CTA
constexpr int F_RPT = 4;   // query rows a thread
constexpr int F_THREADS = F_BQ / F_RPT * 16;  // row groups x 16 columns

// Shared memory, in floats: the CTA's Q rows [F_BQ][LDQ], its P tile
// [F_BQ][LDP], then STAGES stages of a K tile [BK][LDQ] and a V tile
// [BK][D].  Rows of Q and K are padded by 4 floats, so that the 16 rows
// a half-warp reads at one column fall on distinct 16-byte bank groups;
// P's by 16, so that a warp's two rows do.  D = 64: 103 KB, D = 128
// (32 keys a stage): 110 KB, two CTAs an SM either way.  (Eight rows a
// thread on 128 threads took 200 registers and ran 1.4-1.7x slower on
// the card; one barrier a tile, with one tile ahead, 1-4 % slower.)
template <int D>
struct F32Layout {
  static constexpr int BK = D == 64 ? 64 : 32;  // keys a stage
  static constexpr int SC = BK / 16;            // score columns a thread
  static constexpr int OV = D / 64;             // output float4s a row
  static constexpr int LDQ = D + 4;
  static constexpr int LDP = BK + 16;
  static constexpr int STAGES = 2;
  static constexpr int Q_FLOATS = F_BQ * LDQ;
  static constexpr int P_FLOATS = F_BQ * LDP;
  static constexpr int K_FLOATS = BK * LDQ;
  static constexpr int STAGE = K_FLOATS + BK * D;
  static constexpr int SMEM =
      4 * (Q_FLOATS + P_FLOATS + STAGES * STAGE);
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + RG i (i <
// F_RPT, RG = F_BQ / F_RPT row groups), the tile's key columns tx + 16 j
// (j < SC) of S, and output columns 64 h + 4 tx .. + 3 (h < D / 64) of
// O; a warp's two row groups are its own, so P needs no barrier.  S =
// Q K^T goes 4 deep in d a step: F_RPT float4 of Q (its rows) and SC
// float4 of K (its keys), 4 F_RPT SC FMAs; O += P V goes 4 keys a step:
// F_RPT float4 of P, then for each key D / 64 float4 of V, F_RPT D / 4
// FMAs.  Every score and output is one fmaf chain in d or key order
// (keys tiled from 0 whatever the CTA), and a row's max and sum go
// across its 16 lanes by xor shuffles in one fixed order, so a row's
// bits depend on that row, its keys and its visible range only: not on
// S, its place in its tile, the batch or how the shift came.
template <int D>
__global__ void __launch_bounds__(F_THREADS, 2) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int S, int Tn, int masked,
    int shift, const int* __restrict__ shift_dev, float scale) {
  using L = F32Layout<D>;
  constexpr int BK = L::BK, SC = L::SC, OV = L::OV, R = F_RPT;
  constexpr int RG = F_BQ / R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ps = Qs + L::Q_FLOATS;
  float* ring = Ps + L::P_FLOATS;

  // The grid runs heads fastest, Q blocks longest first: every head's
  // longest CTAs start in the first wave, and the CTAs in flight read the
  // K and V tiles of a few Q-block rows of every head, which stay in L2.
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + (size_t)bh * S * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  if (shift_dev) shift = max(-Tn, min(S, *shift_dev));
  // Masked: tiles starting past this CTA's last row's shifted diagonal
  // (t0 + shift > q0 + F_BQ - 1) contribute nothing.
  const int t_end = masked ? min(Tn, max(0, q0 + F_BQ - shift)) : Tn;
  const int n_tiles = (t_end + BK - 1) / BK;

  // Stage s <- keys [t BK, t BK + BK), zeros past T.
  auto load_tile = [&](int t, int s) {
    float* Ks = ring + s * L::STAGE;
    float* Vs = Ks + L::K_FLOATS;
    for (int i = tid; i < BK * D / 4; i += F_THREADS) {
      const int r = i / (D / 4), c = i % (D / 4) * 4, key = t * BK + r;
      const bool ok = key < Tn;
      const size_t off = ok ? (size_t)key * D + c : 0;
      cp_async16(Ks + r * L::LDQ + c, kb + off, ok ? 16 : 0);
      cp_async16(Vs + r * D + c, vb + off, ok ? 16 : 0);
    }
  };
  // Two groups in flight ahead of the loop: Q with tile 0, tile 1.  A CTA
  // with no tile copies nothing and writes o = 0, lse = NEG_INF below.
  if (n_tiles > 0) {
    for (int i = tid; i < F_BQ * D / 4; i += F_THREADS) {
      const int r = i / (D / 4), c = i % (D / 4) * 4;
      const bool ok = q0 + r < S;
      cp_async16(Qs + r * L::LDQ + c, qb + (ok ? (size_t)(q0 + r) * D + c : 0),
                 ok ? 16 : 0);
    }
    load_tile(0, 0);
  }
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  float acc[R][4 * OV];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OV; ++c) acc[i][c] = 0.f;
  }
  const float sl = scale * LOG2E;  // exp(s scale) = exp2(s sl)

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    cp_async_wait<1>();  // tile t (and Q) landed; tile t + 1 in flight
    __syncthreads();
    const float* Ks = ring + s * L::STAGE;
    const float* Vs = Ks + L::K_FLOATS;

    float sc[R][SC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[R], kv[SC];
#pragma unroll
      for (int i = 0; i < R; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + RG * i) * L::LDQ + d);
#pragma unroll
      for (int j = 0; j < SC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::LDQ + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // Online softmax on the raw scores: masked ones NEG_INF (only on a
    // tile that crosses T or some row's shifted diagonal; rows past S
    // are zeros, never stored), the row max and sum across the row's 16
    // lanes (every row's shuffles of one level together), p = exp2(s sl
    // - m sl) by one FMA.  A row this tile hides wholly keeps m, l and O
    // as they were (alpha = exp2(0) = 1, p = 0).
    const int t0 = t * BK;
    if (t0 + BK > Tn || (masked && t0 + BK - 1 + shift > q0)) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + ty + RG * i;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int col = t0 + tx + 16 * j;
          if (col >= Tn || (masked && col + shift > row)) sc[i][j] = NEG_INF;
        }
      }
    }
    float mt[R], psum[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mt[i] = NEG_INF;
#pragma unroll
      for (int j = 0; j < SC; ++j) mt[i] = fmaxf(mt[i], sc[i][j]);
    }
#pragma unroll
    for (int x = 1; x < 16; x *= 2)
#pragma unroll
      for (int i = 0; i < R; ++i)
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], x));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      const float alpha = exp2f((m[i] - m_new) * sl);
      const float nm = -m_new * sl;
      psum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        // Masked lanes are zeroed: a row with nothing visible yet has
        // m_new = NEG_INF, where exp2 of s sl - m sl would not be 0.
        const float p =
            sc[i][j] > NEG_INF * 0.5f ? exp2f(fmaf(sc[i][j], sl, nm)) : 0.f;
        psum[i] += p;
        Ps[(ty + RG * i) * L::LDP + tx + 16 * j] = p;
      }
      m[i] = m_new;
      mt[i] = alpha;
#pragma unroll
      for (int c = 0; c < 4 * OV; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int x = 1; x < 16; x *= 2)
#pragma unroll
      for (int i = 0; i < R; ++i)
        psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], x);
#pragma unroll
    for (int i = 0; i < R; ++i) l[i] = mt[i] * l[i] + psum[i];
    __syncwarp();  // a row's P comes from its own warp

#pragma unroll
    for (int j = 0; j < BK; j += 4) {
      float4 pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + RG * i) * L::LDP + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[OV];
#pragma unroll
        for (int hh = 0; hh < OV; ++hh)
          vv[hh] = *reinterpret_cast<const float4*>(Vs + (j + u) * D + 64 * hh +
                                                    4 * tx);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int hh = 0; hh < OV; ++hh) {
            acc[i][4 * hh] = fmaf(p, vv[hh].x, acc[i][4 * hh]);
            acc[i][4 * hh + 1] = fmaf(p, vv[hh].y, acc[i][4 * hh + 1]);
            acc[i][4 * hh + 2] = fmaf(p, vv[hh].z, acc[i][4 * hh + 2]);
            acc[i][4 * hh + 3] = fmaf(p, vv[hh].w, acc[i][4 * hh + 3]);
          }
        }
      }
    }
    __syncthreads();  // stage s and P read by every thread
    if (t + 2 < n_tiles) load_tile(t + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // o = O / l by rows, 16-byte stores; lse = m scale + log l.
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + RG * i;
    if (row >= S) continue;
    const bool live = l[i] > 0.f;
    float* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int hh = 0; hh < OV; ++hh) {
      float4 r;
      r.x = live ? acc[i][4 * hh] / l[i] : 0.f;
      r.y = live ? acc[i][4 * hh + 1] / l[i] : 0.f;
      r.z = live ? acc[i][4 * hh + 2] / l[i] : 0.f;
      r.w = live ? acc[i][4 * hh + 3] / l[i] : 0.f;
      *reinterpret_cast<float4*>(orow + 64 * hh + 4 * tx) = r;
    }
    if (tx == 0)
      lse[(size_t)bh * S + row] = live ? m[i] * scale + logf(l[i]) : NEG_INF;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int S, int Tn,
                   int masked, int shift, const int* shift_dev, float scale,
                   cudaStream_t stream) {
  const int smem = F32Layout<D>::SMEM;
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + F_BQ - 1) / F_BQ);
  kern<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, S, Tn, masked, shift, shift_dev,
      scale);
  return cudaGetLastError();
}

// --- bf16: wgmma fed by TMA -------------------------------------------------

using hvd_wgmma::map_heads;
typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 384;  // the producer warpgroup + 2 consumers
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_ROWS = 128;  // a CTA's query rows, 64 a consumer
constexpr int BOX_COLS = 64;  // a TMA box row: one 128-byte swizzle line
constexpr float LN2 = 0.6931471805599453f;

// Shared memory (byte offsets from a 1024-byte aligned base): the CTA's
// Q rows (WG_ROWS), then a ring of STAGES stages of a K and a V tile
// (WG_STEP rows), each tile D / 64 boxes of 64 columns, box after box;
// then the mbarriers: full[STAGES], empty[STAGES], Q's.
// WG_STEP: 128 key rows a step at D = 64 (fewer, longer steps: S is
// m64n128), 64 at D = 128 (128-key tiles would leave room for two
// stages, and ran slower), four stages either way.
template <int D>
struct WgLayout {
  static constexpr int WG_STEP = D == 64 ? 128 : 64;
  static constexpr int NB = D / BOX_COLS;
  static constexpr int STAGES = 4;
  static constexpr int RES_BOX = WG_ROWS * BOX_COLS * 2;  // bytes
  static constexpr int STEP_BOX = WG_STEP * BOX_COLS * 2;
  static constexpr int RING = NB * RES_BOX;   // past the Q tile
  static constexpr int TILE = NB * STEP_BOX;  // a streamed tile
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int SMEM = 1024 /* alignment slack */ + BARS +
                              (2 * STAGES + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_fwd_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, bf16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int S, int Tn, int masked,
    int shift, const int* __restrict__ shift_dev, float scale) {
  using namespace hvd_wgmma;
  using L = WgLayout<D>;
  constexpr int BN = L::WG_STEP, KK = BN / 16;  // keys a step, k-slices
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* q_full = empty + L::STAGES;

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_ROWS;  // longest first
  if (shift_dev) shift = max(-Tn, min(S, *shift_dev));
  // K tiles starting past the shifted diagonal of this CTA's last row
  // contribute nothing: k0 + shift <= q0 + WG_ROWS - 1 is needed.  The
  // producer and the consumers count from the same shift.
  const int t_end = masked ? min(Tn, max(0, q0 + WG_ROWS - shift)) : Tn;
  const int n_tiles = (t_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
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
    mbar_arrive_expect_tx(q_full, L::RING);
#pragma unroll
    for (int j = 0; j < L::NB; ++j)
      tma_load_3d(base + j * L::RES_BOX, &tm_q, BOX_COLS * j, q0, bh, q_full);
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], 2 * L::TILE);
      unsigned char* t = base + L::RING + stage * 2 * L::TILE;
#pragma unroll
      for (int j = 0; j < L::NB; ++j) {
        tma_load_3d(t + j * L::STEP_BOX, &tm_k, BOX_COLS * j, it * BN, bkv,
                    &full[stage]);
        tma_load_3d(t + L::TILE + j * L::STEP_BOX, &tm_v, BOX_COLS * j,
                    it * BN, bkv, &full[stage]);
      }
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns Q rows r0 .. r0 + 63; this lane rows
  // `row` and row + 8 (fragment registers i with (i / 2) % 2 = 0 and 1).
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int r0 = q0 + 64 * wg;
  const int row = r0 + 16 * warp + (lane >> 2);
  const int tq = 2 * (lane & 3);  // the lane's first column of 8
  const unsigned char* sq = base + 64 * wg * 128;  // the warpgroup's rows
  const float sl = scale * LOG2E;  // raw scores to log2 units

  float oa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
  // Row state: the max of the raw scores q . k, and this lane's share of
  // the row sum (its columns), summed over the quad once at the end.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[KK][4];  // P rounded to bf16: the A of O += P V
  if (n_tiles > 0) mbar_wait(q_full, 0);

  // Step it issues S_it = Q K_it^T and then O += P_{it-1} V_{it-1}, takes
  // the softmax of S_it while that second product runs, and only then
  // waits for it, rescales O and packs P_it.  Every wait is taken on
  // every step (the first step's second group is empty).  The two
  // warpgroups issue their products in turns (named barriers 1 and 2,
  // warpgroup 0 first), so that one's products run on the tensor cores
  // while the other takes its softmax.
  if (wg == 1) named_barrier_arrive(1, 256);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % L::STAGES, t0 = it * BN;
    mbar_wait(&full[stage], (it / L::STAGES) & 1);
    named_barrier_sync(1 + wg, 256);  // this warpgroup's turn
    const unsigned char* skt = base + L::RING + stage * 2 * L::TILE;
    const unsigned char* svp =  // the previous step's V
        base + L::RING + ((it + L::STAGES - 1) % L::STAGES) * 2 * L::TILE +
        L::TILE;
    // S = Q K^T, both operands K-major in shared memory; then O += P V
    // over k = the previous tile's key rows: A (P rounded to V's dtype)
    // from registers, V read MN-major.
    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, 0, 0>(s, kmajor(sq, L::RES_BOX, kk),
                         kmajor(skt, L::STEP_BOX, kk), kk > 0);
    wgmma_commit();
    if (it > 0) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        wgmma_rs<D>(oa, pa[kk], mnmajor(svp, kk, L::STEP_BOX), 1);
    }
    wgmma_commit();
    named_barrier_arrive(2 - wg, 256);  // the other warpgroup's turn
    wgmma_wait<1>();
    fence_all(s);

    // NEG_INF where masked, tested element by element only on tiles
    // crossing the diagonal or the T edge; the row max of the raw scores
    // (scale > 0 keeps their order).
    if (t0 + BN > Tn || (masked && t0 + BN - 1 + shift > r0)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = t0 + 8 * (i / 4) + tq + (i & 1);
        const int r = row + 8 * ((i >> 1) & 1);
        if (!(col < Tn && (!masked || col + shift <= r))) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mb[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = fast_exp2((m[hh] - mn) * sl);
      m[hh] = mn;
      // p = exp2(s sl - m sl), one FMA and one exp an element.  A row
      // with nothing visible yet (max NEG_INF) takes its exps against 0:
      // exp2(NEG_INF sl) is exactly 0, where against its own max it would
      // be exp2(0) = 1.
      mb[hh] = mn > NEG_INF * 0.5f ? -mn * sl : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = fast_exp2(fmaf(s[i], sl, mb[(i >> 1) & 1]));
      ps[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];

    // The previous P V is done: its stage is free, O can be rescaled and
    // its A registers hold P_it.
    wgmma_wait<0>();
    keep_frags(pa);
    fence_all(oa);
    if (it > 0 && lane == 0)
      mbar_arrive(&empty[(it + L::STAGES - 1) % L::STAGES]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oa[i] *= alpha[(i >> 1) & 1];
    to_a_frags(s, pa);
  }
  // The last step's O += P V (an empty group when there was no step).
  wgmma_fence();
  if (n_tiles > 0) {
    const unsigned char* svp = base + L::RING +
                               ((n_tiles - 1) % L::STAGES) * 2 * L::TILE +
                               L::TILE;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_rs<D>(oa, pa[kk], mnmajor(svp, kk, L::STEP_BOX), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep_frags(pa);
  fence_all(oa);
  if (n_tiles > 0 && lane == 0)
    mbar_arrive(&empty[(n_tiles - 1) % L::STAGES]);

  // Row `row` holds fragment entries 4n, 4n + 1 and row + 8 entries
  // 4n + 2, 4n + 3 of every 8 columns; each lane writes two neighbours,
  // and lane 0 of the quad the row's logsumexp, m scale + log l.
  const size_t q_off = (size_t)bh * S * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row + 8 * hh;
    if (r >= S) continue;
    const bool live = lt > 0.f;
    uint32_t* orow =
        reinterpret_cast<uint32_t*>(o + q_off + (size_t)r * D + tq);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      orow[n * 4] = live ? pack_bf16(oa[4 * n + 2 * hh] / lt,
                                     oa[4 * n + 2 * hh + 1] / lt)
                         : 0u;
    if ((lane & 3) == 0)
      lse[(size_t)bh * S + r] =
          live ? m[hh] * sl * LN2 + logf(lt) : NEG_INF;
  }
}

// K1 in bf16; tensor maps encoded for this call.
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Hkv, int S,
                         int Tn, int masked, int shift, const int* shift_dev,
                         float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!map_heads(&tq, q, B * H, S, D, WG_ROWS) ||
      !map_heads(&tk, k, B * Hkv, Tn, D, WgLayout<D>::WG_STEP) ||
      !map_heads(&tv, v, B * Hkv, Tn, D, WgLayout<D>::WG_STEP))
    return cudaErrorInvalidValue;
  const int smem = WgLayout<D>::SMEM;
  auto kern = flash_fwd_kernel_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + WG_ROWS - 1) / WG_ROWS, B * H);
  kern<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Hkv,
      S, Tn, masked, shift, shift_dev, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 runs the wgmma kernel, f32 the scalar one (see the note at the
// top).  Pointers must be 16-byte aligned (the wrapper checks).
// `shift_dev`: null for the by-value `shift`, else a device int32 that
// replaces it (with `masked` set).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Hkv, int S,
                         int T, int D, int is_bf16, int masked, int shift,
                         float scale, void* stream, const void* shift_dev) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(shift_dev);
  cudaError_t err;
  if (is_bf16 && D == 64)
    err = launch_wgmma<64>(q, k, v, o, lse, B, H, Hkv, S, T, masked, shift,
                           sd, scale, st);
  else if (is_bf16 && D == 128)
    err = launch_wgmma<128>(q, k, v, o, lse, B, H, Hkv, S, T, masked,
                            shift, sd, scale, st);
  else if (!is_bf16 && D == 64)
    err = launch<64>(q, k, v, o, lse, B, H, Hkv, S, T, masked, shift, sd,
                     scale, st);
  else if (!is_bf16 && D == 128)
    err = launch<128>(q, k, v, o, lse, B, H, Hkv, S, T, masked, shift, sd,
                      scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
