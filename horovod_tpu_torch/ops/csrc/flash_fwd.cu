// K1: flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/attention.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`).  Same function: tiled
// attention with an online softmax in f32, an optional shifted causal
// mask (position (row, col) attends iff col + shift <= row; shift 0 is
// causal, the runtime scalar of `flash_attention_shifted`), K tiles
// wholly past the shifted diagonal skipped, `o` in the
// input dtype and the row logsumexp in f32; a fully masked row gives
// o = 0 and lse = NEG_INF.  Rounding points mirror the JAX kernel:
// s = (q . k) * scale in f32 (bf16 products are exact in f32), p cast to
// V's dtype before p . v, f32 accumulation, o cast to the input dtype.
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
// Bound on an H100: at the serving prefill shape (B=2, H=16, H_kv=4,
// S=T=2048, D=64, bf16, causal) the work is ~17 GFLOP against ~21 MB
// of inputs and outputs, so the tensor-core rate (989 TFLOP/s, ~17 us)
// bounds it, not HBM (~6 us).
//
// Two instantiations, chosen by dtype in the C entry point (not a
// fallback: each dtype has exactly one kernel):
//
// * bf16 (`flash_fwd_kernel_mma`): both products on the tensor cores
//   with mma.sync.m16n8k16 (mma_bf16.cuh).  A CTA of 4 warps takes a
//   64-row Q tile, 16 rows a warp, held in registers as A fragments for
//   the whole K loop.  64-row K and V tiles are staged in shared memory
//   in bf16 (rows padded to D + 8 for conflict-free ldmatrix), double
//   buffered with cp.async so tile t + 1 lands while tile t computes.
//   S = Q K^T accumulates in f32 fragments; the online softmax runs on
//   them (row max and sum across the 4 lanes of a quad by shuffles), and
//   P, rounded to bf16 in registers, is the A operand of P V with V's B
//   fragments from ldmatrix.trans: P never touches shared memory.  Only
//   tiles that cross the shifted diagonal or the ragged T edge are
//   masked element by element; a warp skips the products of a tile that
//   lies wholly past its rows' diagonal.  Q tiles launch longest first
//   (reverse order in grid y) so the causal triangle's short tail fills
//   the last wave.  mma.sync, not wgmma + TMA: the first tensor-core
//   design, one warp-level product per instruction; wgmma is later work.
// * f32 (`flash_fwd_kernel`): the scalar kernel of the first port, one
//   CTA per (batch*head, 64-row Q tile), four threads a query row,
//   tiles in shared memory as f32 and scalar FMAs.  TF32 tensor cores
//   would round the products to 10 mantissa bits and miss the f32
//   contract (1e-4 of the plain version, exact greedy tokens).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key columns per staged tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

// --- f32: scalar FMAs ---------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int S, int Tn, int masked,
    int shift, const int* __restrict__ shift_dev, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][D + 1]  (padded: no bank clash)
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1]

  const int bh = blockIdx.y;        // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;  // a row's 4 threads share a warp
  const int row = q0 + r;
  const bool row_ok = row < S;      // ragged edge: S smaller than the tile

  const float* qrow = q + ((size_t)bh * S + (row_ok ? row : 0)) * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? qrow[d] : 0.f;

  constexpr int NC = D / TPR;       // output columns per thread
  constexpr int NS = BK / TPR;      // scores per thread per tile
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  if (shift_dev) shift = max(-Tn, min(S, *shift_dev));
  // Masked: tiles starting past this CTA's last row's shifted diagonal
  // (t0 + shift > q0 + BQ - 1) contribute nothing.
  const int t_end = masked ? min(Tn, max(0, q0 + BQ - shift)) : Tn;
  for (int t0 = 0; t0 < t_end; t0 += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, t = t0 + j;
      float kk = 0.f, vv = 0.f;
      if (t < Tn) {
        kk = kb[(size_t)t * D + d];
        vv = vb[(size_t)t * D + d];
      }
      Ks[j * (D + 1) + d] = kk;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[NS];
    float mt = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int j = sub + TPR * jj, col = t0 + j;
      const float* kr = Ks + j * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const bool ok =
          row_ok && col < Tn && (!masked || col + shift <= row);
      s[jj] = ok ? dot * scale : NEG_INF;
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      // Rows masked so far have m_new == NEG_INF: exp(s - m_new) would
      // be exp(0) = 1 for masked lanes, so zero them explicitly.
      const float p = s[jj] > NEG_INF * 0.5f ? expf(s[jj] - m_new) : 0.f;
      psum += p;
      Ps[r * (BK + 1) + sub + TPR * jj] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's P entries come from its own warp

    const float* pr = Ps + r * (BK + 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = sub + TPR * c;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) pv = fmaf(pr[j], Vs[j * D + d], pv);
      acc[c] = acc[c] * alpha + pv;
    }
    __syncthreads();  // before the next tile overwrites Ks / Vs
  }

  if (!row_ok) return;
  const bool live = l > 0.f;
  float* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) orow[sub + TPR * c] = live ? acc[c] / l : 0.f;
  if (sub == 0) lse[(size_t)bh * S + row] = live ? m + logf(l) : NEG_INF;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int S, int Tn,
                   int masked, int shift, const int* shift_dev, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BK * (D + 1) + BK * D + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, S, Tn, masked, shift, shift_dev,
      scale);
  return cudaGetLastError();
}

// --- bf16: tensor cores ------------------------------------------------------

using hvd_mma::bf16;

constexpr int MMA_WARPS = 4;                 // 16 query rows a warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int S, int Tn, int masked,
    int shift, const int* __restrict__ shift_dev, float scale) {
  using namespace hvd_mma;
  constexpr int LD = D + 8;   // padded row stride of every tile
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;  // n-tiles of a warp's 16 x BK score tile
  constexpr int ND = D / 8;   // n-tiles of a warp's 16 x D output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq0 = q0 + warp * 16;                     // the warp's rows
  const int row0 = wq0 + (lane >> 2), row1 = row0 + 8;  // this lane's
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  if (shift_dev) shift = max(-Tn, min(S, *shift_dev));
  // Masked: tiles starting past this CTA's last row's shifted diagonal
  // (t0 + shift > q0 + BQ - 1) contribute nothing.
  const int t_end = masked ? min(Tn, max(0, q0 + BQ - shift)) : Tn;
  const int n_tiles = (t_end + BK - 1) / BK;

  // cp.async groups: Q, then one per K/V tile (empty past the last), so
  // "all but the newest group landed" is always the tile about to run.
  load_rows_async<BQ, D, MMA_THREADS>(Qs, q + (size_t)bh * S * D, q0, S);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async<BK, D, MMA_THREADS>(Ks, kb, 0, Tn);
    load_rows_async<BK, D, MMA_THREADS>(Vs, vb, 0, Tn);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[KS][4];  // the warp's Q rows as A fragments, all of D
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], frag_a<LD>(Qs, warp * 16, ks * 16, lane));

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // Row state of rows row0 and row1; l is this lane's share of the row
  // sum (its columns), summed over the quad once at the end.
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

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
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, frag_b<LD>(Kt, np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }

      // s = (q . k) * scale in f32; NEG_INF where masked, as in JAX.
      // Only tiles crossing the diagonal or the T edge test elements.
      const bool edge = t0 + BK > Tn || (masked && t0 + BK - 1 + shift > wq0);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge) {
            const int col = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (!(col < Tn && (!masked || col + shift <= row))) x = NEG_INF;
          }
          s[n][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f((m0 - mn0) * LOG2E);
      const float al1 = exp2f((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      // Rows masked so far have m == NEG_INF: exp(s - m) would be 1 for
      // their masked lanes, so those are zeroed explicitly.
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn0 : mn1;
          const float p =
              s[n][e] > NEG_INF * 0.5f ? exp2f((s[n][e] - mn) * LOG2E) : 0.f;
          s[n][e] = p;
          if (e < 2) ps0 += p; else ps1 += p;
        }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }

      // o += P V: P rounded to V's dtype (bf16) in registers, as the A
      // fragment of k-step kt (columns 16 kt .. 16 kt + 15 of P).
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, frag_a<LD>(Vt, kt * 16, dp * 16, lane));
          mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this half
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // Row row0 holds fragment entries 0, 1 and row row1 entries 2, 3; each
  // lane writes two neighbouring columns of every n-tile, and lane 0 of
  // the quad the row's logsumexp.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    if (row >= S) continue;
    const bool live = l > 0.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + ((size_t)bh * S + row) * D + 2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < ND; ++n)
      orow[n * 4] = live ? pack_bf16(acc[n][2 * half] / l,
                                     acc[n][2 * half + 1] / l)
                         : 0u;
    if ((lane & 3) == 0)
      lse[(size_t)bh * S + row] = live ? m + logf(l) : NEG_INF;
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Hkv, int S, int Tn,
                       int masked, int shift, const int* shift_dev,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (BQ + 4 * BK) * (D + 8);
  auto kern = flash_fwd_kernel_mma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, S, Tn, masked, shift, shift_dev,
      scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 runs the tensor-core kernel, f32 the scalar one (see the note at
// the top).  Pointers must be 16-byte aligned (the wrapper checks).
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
    err = launch_mma<64>(q, k, v, o, lse, B, H, Hkv, S, T, masked, shift, sd,
                         scale, st);
  else if (is_bf16 && D == 128)
    err = launch_mma<128>(q, k, v, o, lse, B, H, Hkv, S, T, masked, shift,
                          sd, scale, st);
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
