// K4: paged-attention decode for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/paged_attention.py
// `_kernel_body` (launched by `_pallas_paged_attend`).  Same function:
// R grouped query rows of one (slot, kv head) attend straight against
// the paged KV pool.  The kernel reads each physical page id from the
// slot's table row itself, masks logical positions >= limit[s], runs
// the online softmax in f32 and writes o (f32) and the row logsumexp;
// limit == 0 gives o = 0 and lse = NEG_INF.  int8 pages are dequantized
// in the load as (float)q * scale, then rounded to the compute dtype
// before the dot (`DEQUANT_COMPUTE`); q is rounded to the compute dtype,
// the unnormalised p to V's dtype before p . v, sums stay in f32.
//
// Bound on an H100: HBM.  A decode tick's R = 4 rows do ~4 FLOP a byte
// of K/V, the speculative verify's R = G W = 20 about 20; both far under
// the ~295 at which the tensor cores' rate would bound it.  At the serving
// shape (8 slots, H_kv=4, Dh=64, page 16, 136 pages a slot, bf16) a full
// table is ~17.8 MB of K/V, ~5.3 us at 3.35 TB/s.  What keeps a kernel
// from that: enough bytes in flight across all 132 SMs, each page read
// once (not once a block of rows), and the CUDA cores' FMA rate, which
// at 20 rows a byte-pair would need ~67 TFLOP/s, their whole rate, to
// keep up with HBM; and, at this size, the two launches and each CTA's
// few copy round trips.
//
// Split-K flash-decoding, two kernels on one stream; the first is the
// split kernel or, for a bf16 pool with R > 8, the rows kernel (the C
// entry point `paged_attend` chooses; not a fallback: each (pool, R) has
// exactly one kernel):
//
// * `paged_attend_split_kernel`: grid (slot * H_kv, split, R block).
//   Split i takes the fixed run of table entries [i * pps, (i+1) * pps)
//   (pps, pages a split, is chosen by the caller from S, H_kv, R and
//   max_pages only, never from limit, so no device value is read on the
//   host).  A CTA whose run starts at or past limit[s] writes an empty
//   partial (m = NEG_INF, l = 0) and exits.  Its live pages stream
//   through a three-stage cp.async ring of 16-byte copies in the stored
//   dtype; rows past the limit are never copied.  A chunk is up to 64
//   logical rows and 8 KB of K (and of V), each row read from its own
//   page (the run's page ids are staged in shared memory first), so a
//   chunk spans pages when they are short: at bf16, Dh 64, page 16, two
//   chunks of 4 pages are in flight while a third is read.  4 warps own
//   positions: a group of L lanes (8 for Dh <= 64, 16 up to 128, a
//   template argument so that the shuffle loops unroll and the query
//   rows' chains interleave) takes one position, each lane 8 elements of
//   Dh read as one vector from shared memory, and the group's dot
//   products are summed by shuffles, on the CUDA cores (f32 pools need
//   exact f32 FMAs; int8 pages are dequantised in the load).  Scores are
//   kept in log2 units, so each exponential is one exp2.  Each warp keeps
//   its own online softmax (m, l, acc) in registers for up to RB query
//   rows (the template's R block, 4 or 8; a larger R takes more grid z
//   blocks), merged across its groups and then across the 4 warps once
//   at the end.  The partial (m, l, acc[R][Dh]) goes to f32 scratch that
//   the wrapper allocated.  q is read in its own dtype (f32 or bf16).
// * `paged_attend_rows_kernel` (bf16 pools, R > 8: the speculative
//   verify's G W rows): the same grid and partials, with one R block of
//   up to 32 rows, so each page is read from HBM once for all of a kv
//   head's rows (the split kernel's 8-row blocks read it once a block).
//   Warp 0's lane 0 copies each page's K and V by TMA (wgmma_tma.cuh),
//   a box of 64 columns x up to 64 page rows from 3-D maps over the pool
//   as (Dh, page rows, page * H_kv + head), 128-byte swizzled, into an
//   even-length mbarrier ring; a box past the page's last row, or past
//   Dh, lands as zeros.  Rows of the last page past the limit are copied
//   with it and get p = 0 (the pool is finite: the engine's pages start
//   as zeros).  Warps 1-4 compute on the tensor cores with mma.sync
//   m16n8k16 (mma_bf16.cuh; HBM-bound, so wgmma's 64-row minimum would
//   only add padding): warp 1 + w takes row tile w % 2 (16 rows of q as
//   A fragments in registers, zero past R) of every chunk of parity
//   w / 2, 16 page rows at a time: scores from K's B fragments by
//   ldmatrix on the swizzled box, the online softmax in log2 units
//   (`ex2.approx`, no branch), then o += p . v with p rounded to bf16 as
//   the A fragment and V's B fragments by ldmatrix.trans.  The two warps
//   of a row tile merge through shared memory at the end.
// * `paged_attend_combine_kernel`: one CTA per (slot, kv head) and block
//   of 4 rows reads its live splits in index order: m = max over splits
//   with l > 0, o = sum e^(m_i - m) acc_i / sum e^(m_i - m) l_i and
//   lse = m + log sum e^(m_i - m) l_i, the weights staged in shared
//   memory once a row.  A split with l = 0 gets weight 0 explicitly (its
//   e^(NEG_INF - NEG_INF) would be 1).  No atomics: the result is the
//   same, bit for bit, from call to call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;      // chunks in the ring: two in flight
constexpr int CHUNK_MAX = 64;  // rows a chunk (THREADS >= 2 * CHUNK_MAX)
constexpr int CHUNK_BYTES = 8192;  // of K (and of V) a chunk, at most
constexpr int PPS_MAX = 1024;      // pages a split (their ids in smem)
constexpr int DH_MAX = 128;  // q and acc: 8 values a lane, 16 lanes a row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)
constexpr float LN2 = 0.6931471805599453f;

// Round an f32 value to the compute type C and back (identity for f32).
template <typename C> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows a ring chunk: CHUNK_BYTES of K at most, and at most CHUNK_MAX.
__host__ __device__ __forceinline__ int chunk_rows(int Dh, int elem) {
  const int rows = CHUNK_BYTES / (Dh * elem);
  return rows < CHUNK_MAX ? rows : CHUNK_MAX;
}

// Eight consecutive stored values at p (shared memory, 8-element
// aligned) widened to f32.
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const int8_t* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {a.x, a.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

// P: stored pool type (float / bf16 / int8).  C: compute type — the
// pool's own type when unquantized, the model dtype for int8 pools.
// RB: query rows a CTA (grid z covers R in blocks of RB).  L: lanes a
// position, 8 for Dh <= 64 and 16 for Dh <= 128 (lanes whose 8 columns
// lie past Dh idle).
template <typename P, typename C, int RB, int L>
__global__ void __launch_bounds__(THREADS) paged_attend_split_kernel(
    const void* __restrict__ qg, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ limit, float* __restrict__ part, int Hkv,
    int R, int Dh, int ps, int max_pages, int pps, float sqrt_dh,
    int q_bf16) {
  using namespace hvd_mma;
  constexpr bool quantized = sizeof(P) == 1;
  constexpr int GPW = 32 / L;  // positions a warp takes at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cr = chunk_rows(Dh, sizeof(P));  // rows a chunk
  const int stage_elems = cr * Dh;
  P* Kr = reinterpret_cast<P*>(smem_raw);    // [STAGES][cr][Dh]
  P* Vr = Kr + STAGES * stage_elems;         // [STAGES][cr][Dh]
  float* Sk = reinterpret_cast<float*>(Vr + STAGES * stage_elems);
  float* Sv = Sk + STAGES * cr;              // [STAGES][cr] int8 scales
  float* Wm = Sv + STAGES * cr;              // [WARPS][RB]
  float* Wl = Wm + WARPS * RB;               // [WARPS][RB]
  float* Wa = Wl + WARPS * RB;               // [WARPS][RB][Dh]
  int* Pg = reinterpret_cast<int*>(Wa + WARPS * RB * Dh);  // [pps] page ids

  const int blk = blockIdx.x;  // s * Hkv + h
  const int s = blk / Hkv, h = blk % Hkv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int r0 = blockIdx.z * RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lim = limit[s];
  const int live_pages = min(max_pages, (max(lim, 0) + ps - 1) / ps);
  const int b0 = split * pps, b1 = min(b0 + pps, live_pages);
  // Partial layout: acc [S*Hkv][n_split][R][Dh], then m and l
  // [S*Hkv][n_split][R]; m in log2 units (scores times log2 e).
  const int n_blk = gridDim.x;
  float* pacc = part + ((size_t)blk * n_split + split) * R * Dh;
  float* pm = part + (size_t)n_blk * n_split * R * Dh +
              ((size_t)blk * n_split + split) * R;
  float* pl = pm + (size_t)n_blk * n_split * R;

  if (b0 >= b1) {  // the run starts at or past limit: an empty partial
    for (int r = r0 + tid; r < min(R, r0 + RB); r += THREADS) {
      pm[r] = NEG_INF;
      pl[r] = 0.f;
    }
    return;
  }

  // The run's live positions [p0, p1): rows past the limit are never
  // copied.  Chunk c holds positions p0 + c * cr .. + cr, each row read
  // from its own page (a chunk spans pages when they are short).
  const int p0 = b0 * ps, p1 = min(b1 * ps, lim);
  const int n_chunks = (p1 - p0 + cr - 1) / cr;
  for (int i = tid; i < b1 - b0; i += THREADS)
    Pg[i] = table[(size_t)s * max_pages + b0 + i];
  __syncthreads();
  constexpr int EP = 16 / sizeof(P);  // elements a 16-byte copy
  const int ppr = Dh / EP;            // copies a row
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int rows = min(cr, p1 - p0 - c * cr);
      const int st = c % STAGES;
      P* kd = Kr + st * stage_elems;
      P* vd = Vr + st * stage_elems;
      for (int i = tid; i < rows * ppr; i += THREADS) {
        const int j = i / ppr, e = (i % ppr) * EP;
        const int pos = c * cr + j;  // from p0, which starts a page
        const size_t at =
            (((size_t)Pg[pos / ps] * Hkv + h) * ps + pos % ps) * Dh + e;
        cp_async16(kd + j * Dh + e, kp + at, 16);
        cp_async16(vd + j * Dh + e, vp + at, 16);
      }
      if constexpr (quantized) {  // one scale a row: K by threads < cr,
        const int j = tid < cr ? tid : tid - cr;  // V by the next cr
        if (j < rows) {
          const int pos = c * cr + j;
          const size_t at =
              ((size_t)Pg[pos / ps] * Hkv + h) * ps + pos % ps;
          if (tid < cr) cp_async4(Sk + st * cr + j, ks + at, 4);
          else cp_async4(Sv + st * cr + j, vs + at, 4);
        }
      }
    }
    cp_async_commit();  // empty past the last chunk: uniform counting
  };

  const int grp = lane / L, sub = lane % L;  // position group, Dh slice
  const int d0 = sub * 8;
  const bool dlive = d0 < Dh;
  // Scores in log2 units: exp(x) = exp2(x * log2 e), one MUFU op.
  const float sl = LOG2E / sqrt_dh;

  // This lane's 8 elements of each query row, rounded to the compute type.
  float q[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const size_t at = ((size_t)blk * R + r0 + r) * Dh + d0 + e;
      float x = 0.f;
      if (dlive && r0 + r < R)
        x = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(qg)[at])
                   : static_cast<const float*>(qg)[at];
      q[r][e] = round_to<C>(x);
    }
  float m[RB], l[RB], acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  issue(0);
  issue(1);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // chunk c landed (c + 1 may still be in flight)
    __syncthreads();     // ... for every thread; chunk c - 1 is read
    issue(c + 2);        // into chunk c - 1's stage
    const int st = c % STAGES;
    const int rows = min(cr, p1 - p0 - c * cr);  // all below the limit
    const P* Kt = Kr + st * stage_elems;
    const P* Vt = Vr + st * stage_elems;
    // Every warp walks the same passes (rows is CTA-uniform), so the
    // shuffles below see all 32 lanes.
    for (int j0 = 0; j0 < rows; j0 += WARPS * GPW) {
      const int j = j0 + warp * GPW + grp;
      const bool vis = j < rows;
      float kk[8], vv[8];
      if (vis && dlive) {
        load8(kk, Kt + j * Dh + d0);
        load8(vv, Vt + j * Dh + d0);
        if constexpr (quantized) {  // dequant: f32 multiply, one rounding
          const float sk = Sk[st * cr + j], sv = Sv[st * cr + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kk[e] = round_to<C>(kk[e] * sk);
            vv[e] = round_to<C>(vv[e] * sv);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kk[e] = vv[e] = 0.f;
      }
      // Position j's score of each row: the group's partial dots summed;
      // then the warp's max over its groups' positions.
      float sc[RB], mx[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(q[r][e], kk[e], dot);
        sc[r] = dot;
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
#pragma unroll
      for (int r = 0; r < RB; ++r) mx[r] = sc[r] = vis ? sc[r] * sl : NEG_INF;
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        const float alpha = exp2f(m[r] - m_new);
        // Masked positions get p = 0 explicitly: while every position so
        // far is masked, m_new is NEG_INF and exp(sc - m_new) would be 1.
        const float p = vis ? exp2f(sc[r] - m_new) : 0.f;
        const float pr = round_to<C>(p);  // p in V's dtype
        m[r] = m_new;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[r][e] = fmaf(pr, vv[e], acc[r][e] * alpha);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  // Merge the warp's groups (one shared m, so plain sums), then the
  // warps through shared memory.
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (dlive)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          Wa[(warp * RB + r) * Dh + d0 + e] = acc[r][e];
      if (lane == 0) {
        Wm[warp * RB + r] = m[r];
        Wl[warp * RB + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < RB * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh;
    if (r0 + r >= R) break;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (Wl[w * RB + r] > 0.f) M = fmaxf(M, Wm[w * RB + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (Wl[w * RB + r] > 0.f) {  // a warp that saw nothing: weight 0
        const float wt = exp2f(Wm[w * RB + r] - M);
        lsum += wt * Wl[w * RB + r];
        a += wt * Wa[(w * RB + r) * Dh + d];
      }
    pacc[(size_t)(r0 + r) * Dh + d] = a;
    if (d == 0) {
      pm[r0 + r] = M;
      pl[r0 + r] = lsum;
    }
  }
}

// One CTA per (slot, kv head) and block of WARPS rows (a warp a row, so
// that a verify's R = 20 spreads over five CTAs a kv head, each thread
// reading its few outputs' splits in flight).  Shared memory: [n_split][R]
// split weights, [n_split][R] weighted row sums, [R] row sums.
__global__ void __launch_bounds__(THREADS) paged_attend_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ limit,
    float* __restrict__ o, float* __restrict__ lse, int Hkv, int R, int Dh,
    int ps, int max_pages, int pps, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = blockIdx.x;  // s * Hkv + h
  const int s = blk / Hkv;
  const int n_blk = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * WARPS, r1 = min(R, r0 + WARPS);
  const int lim = limit[s];
  const int live_pages = min(max_pages, (max(lim, 0) + ps - 1) / ps);
  const int n_live = min(n_split, (live_pages + pps - 1) / pps);
  float* W = reinterpret_cast<float*>(smem_raw);  // [n_split][R]
  float* WL = W + n_split * R;                    // [n_split][R]
  float* Ls = WL + n_split * R;                   // [R]
  const float* pacc = part + (size_t)blk * n_split * R * Dh;
  const float* pm = part + (size_t)n_blk * n_split * R * Dh +
                    (size_t)blk * n_split * R;
  const float* pl = pm + (size_t)n_blk * n_split * R;
  // A warp a row: lanes take the splits for the max (exact in any
  // order) and the weights; lane 0 sums the weighted l in split order.
  const int row = r0 + warp;
  if (row < r1) {
    float M = NEG_INF;
    for (int k = lane; k < n_live; k += 32)
      if (pl[k * R + row] > 0.f) M = fmaxf(M, pm[k * R + row]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    for (int k = lane; k < n_live; k += 32) {
      const float lk = pl[k * R + row];
      // An empty split gets weight 0 explicitly, not e^(NEG_INF - NEG_INF).
      const float w = lk > 0.f ? exp2f(pm[k * R + row] - M) : 0.f;
      W[k * R + row] = w;
      WL[k * R + row] = w * lk;
    }
    __syncwarp();
    if (lane == 0) {
      float lsum = 0.f;
      for (int k = 0; k < n_live; ++k) lsum += WL[k * R + row];
      Ls[row] = lsum;
      lse[(size_t)blk * R + row] = lsum > 0.f ? M * LN2 + logf(lsum) : NEG_INF;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (r1 - r0) * Dh; i += THREADS) {
    const int r = r0 + i / Dh, d = i % Dh;
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_live; ++k)
      a = fmaf(W[k * R + r], pacc[((size_t)k * R + r) * Dh + d], a);
    const float lsum = Ls[r];
    o[((size_t)blk * R + r) * Dh + d] = lsum > 0.f ? a / lsum : 0.f;
  }
}

// Merges the first kernel's partials, whichever kernel wrote them.
cudaError_t launch_combine(const void* limit, void* o, void* lse, void* part,
                           int S, int Hkv, int R, int Dh, int ps,
                           int max_pages, int pps, cudaStream_t stream) {
  const int n_split = (max_pages + pps - 1) / pps;
  const size_t csmem = sizeof(float) * ((size_t)2 * n_split * R + R);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attend_combine_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (err != cudaSuccess) return err;
  dim3 grid(S * Hkv, (R + WARPS - 1) / WARPS);
  paged_attend_combine_kernel<<<grid, THREADS, csmem, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(limit),
      static_cast<float*>(o), static_cast<float*>(lse), Hkv, R, Dh, ps,
      max_pages, pps, n_split);
  return cudaGetLastError();
}

// --- bf16 pools, R > 8: the tensor-core rows kernel -------------------------

constexpr int ROWS_MIN = 8;   // a bf16 pool's R above this: the rows kernel
constexpr int ROWS_MAX = 32;  // query rows a CTA: two m16 row tiles
constexpr int ROWS_THREADS = 32 * (1 + WARPS);  // a producer warp + WARPS
constexpr int ROWS_RING_BYTES = 49152;  // the ring's target size

// Page rows a ring stage: the page rounded up to whole 16-row k-steps of
// p . v, at most 64 (a longer page takes several stages).
__host__ __device__ __forceinline__ int rows_chunk(int ps) {
  const int c = (ps + 15) / 16 * 16;
  return c < 64 ? c : 64;
}

// Shared memory of the rows kernel (byte offsets from a 1024-byte aligned
// base): the ring, `stages` stages of a K and a V chunk, each NB boxes of
// 64 columns x `ch` rows (128 bytes a row, 128-byte swizzled); after the
// chunk loop the same bytes hold the four consumer warps' (m, l, o) for
// the merge.  Then the split's page ids, then full[stages], empty[stages].
struct RowsLayout {
  int ch, box, tile, stages, ids, bars, smem;
  __host__ __device__ RowsLayout(int ps, int nb, int pps) {
    ch = rows_chunk(ps);
    box = ch * 128;
    tile = nb * box;
    int n = ROWS_RING_BYTES / (2 * tile);
    n = n < 2 ? 2 : (n > 8 ? 8 : n);
    stages = n & ~1;  // even: the two consumer pairs take alternate stages
    const int merge = (WARPS * 16 * (2 + 64 * nb)) * 4;
    ids = stages * 2 * tile > merge ? stages * 2 * tile : merge;
    bars = (ids + 4 * pps + 7) / 8 * 8;
    smem = 1024 /* alignment slack */ + bars + 2 * stages * 8;
  }
};

// This lane's ldmatrix row address in a swizzled K or V chunk: element
// (row r, column c) of box c / 64 lies at r * 128, its 16-byte column
// chunk (c % 64) / 8 moved by r % 8 (TMA's 128-byte swizzle).
__device__ __forceinline__ const hvd_mma::bf16* swz(const unsigned char* t, int box,
                                           int r, int c) {
  return reinterpret_cast<const hvd_mma::bf16*>(
      t + (c / 64) * box + r * 128 + ((((c % 64) >> 3) ^ (r & 7)) << 4));
}

// DMAX: the head dim rounded up to 64 or 128 (NB = DMAX / 64 boxes of 64
// columns; columns past Dh land as zeros and add nothing).  Grid (slot *
// H_kv, split, R / 32 blocks).  Warp 0 produces (lane 0 issues the TMA
// copies), warps 1..4 consume: warp 1 + cw takes row tile cw % 2 (16
// rows) of every chunk of parity cw / 2, so each page is read from HBM
// once for all 32 rows and each warp keeps its own online softmax.
template <int DMAX>
__global__ void __launch_bounds__(ROWS_THREADS, DMAX == 64 ? 4 : 2)
    paged_attend_rows_kernel(
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, const void* __restrict__ qg,
    const int* __restrict__ table, const int* __restrict__ limit,
    float* __restrict__ part, int Hkv, int R, int Dh, int ps, int max_pages,
    int pps, float sqrt_dh, int q_bf16) {
  using namespace hvd_mma;
  namespace wg = hvd_wgmma;
  constexpr int NB = DMAX / 64;
  constexpr int KS = DMAX / 16;  // k-steps of q . k
  constexpr int NT = DMAX / 8;   // n-tiles of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = wg::align_1024(smem_raw);
  const RowsLayout lay(ps, NB, pps);
  int* Pg = reinterpret_cast<int*>(base + lay.ids);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + lay.stages;

  const int blk = blockIdx.x;  // s * Hkv + h
  const int s = blk / Hkv, h = blk % Hkv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int r0 = blockIdx.z * ROWS_MAX;
  const int nrows = min(R - r0, ROWS_MAX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lim = limit[s];
  const int live_pages = min(max_pages, (max(lim, 0) + ps - 1) / ps);
  const int b0 = split * pps, b1 = min(b0 + pps, live_pages);
  // The split kernel's partial layout (see there), m in log2 units.
  const int n_blk = gridDim.x;
  float* pacc = part + ((size_t)blk * n_split + split) * R * Dh;
  float* pm = part + (size_t)n_blk * n_split * R * Dh +
              ((size_t)blk * n_split + split) * R;
  float* pl = pm + (size_t)n_blk * n_split * R;

  if (b0 >= b1) {  // the run starts at or past limit: an empty partial
    for (int r = tid; r < nrows; r += ROWS_THREADS) {
      pm[r0 + r] = NEG_INF;
      pl[r0 + r] = 0.f;
    }
    return;
  }

  // Chunk c: rows (c % cpp) * ch .. + ch of the run's page c / cpp; the
  // last page's chunks that start at or past the limit are never copied.
  const int ch = lay.ch, cpp = (ps + ch - 1) / ch;
  const int last = min(b1 * ps, lim) - (b1 - 1) * ps;  // its live rows
  const int n_chunks = (b1 - b0 - 1) * cpp + (last + ch - 1) / ch;
  const int n_mt = nrows > 16 ? 2 : 1;  // row tiles holding live rows
  for (int i = tid; i < b1 - b0; i += ROWS_THREADS)
    Pg[i] = table[(size_t)s * max_pages + b0 + i];
  if (tid == 0) {
    for (int st = 0; st < lay.stages; ++st) {
      wg::mbar_init(&full[st], 1);
      wg::mbar_init(&empty[st], n_mt);  // the consuming warps of a stage
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int cw = warp - 1, mt = cw & 1;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float oa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;
  if (warp == 0) {
    if (lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int st = c % lay.stages;
        wg::mbar_wait(&empty[st], ((c / lay.stages) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(&full[st], 2 * lay.tile);
        unsigned char* kd = base + st * 2 * lay.tile;
        const int row = (c % cpp) * ch, ph = Pg[c / cpp] * Hkv + h;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          wg::tma_load_3d(kd + j * lay.box, &tm_k, 64 * j, row, ph, &full[st]);
          wg::tma_load_3d(kd + lay.tile + j * lay.box, &tm_v, 64 * j, row, ph,
                          &full[st]);
        }
      }
    }
  } else if (mt < n_mt) {
    // This lane's rows of the tile (g and g + 8 of mma.sync's fragments)
    // and its first column of each 8; q rounded to bf16 as A fragments,
    // zero past R and Dh.
    const int tq = 2 * (lane & 3);
    const int ra = r0 + 16 * mt + (lane >> 2), rb = ra + 8;
    auto qv = [&](int r, int c) -> float {
      if (r >= R || c >= Dh) return 0.f;
      const size_t at = ((size_t)blk * R + r) * Dh + c;
      return q_bf16 ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(qg)[at])
                    : static_cast<const float*>(qg)[at];
    };
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + tq;
      qf[ks][0] = pack_bf16(qv(ra, c), qv(ra, c + 1));
      qf[ks][1] = pack_bf16(qv(rb, c), qv(rb, c + 1));
      qf[ks][2] = pack_bf16(qv(ra, c + 8), qv(ra, c + 9));
      qf[ks][3] = pack_bf16(qv(rb, c + 8), qv(rb, c + 9));
    }
    const float sl = LOG2E / sqrt_dh;  // scores in log2 units
    for (int c = cw >> 1; c < n_chunks; c += 2) {
      const int st = c % lay.stages;
      wg::mbar_wait(&full[st], (c / lay.stages) & 1);
      const unsigned char* kt = base + st * 2 * lay.tile;
      const unsigned char* vt = kt + lay.tile;
      const int row = (c % cpp) * ch;
      // Chunk rows j < vis are live: inside the page and below the limit.
      const int vis =
          min(min(ch, ps - row), lim - ((b0 + c / cpp) * ps + row));
      // The chunk 16 rows at a time: their scores (n-tile n of sc, rows
      // 16 sb + 8 n ..), the online softmax, then o += p . v with p
      // rounded to V's dtype (bf16) in registers as the A fragment and
      // V's B fragments by ldmatrix.trans.
      for (int sb = 0; sb < ch / 16; ++sb) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int kr = sb * 16 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t kf[4];
          ldsm_x4(kf, swz(kt, lay.box, kr, ks * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(sc[0], qf[ks], kf[0], kf[1]);
          mma_bf16(sc[1], qf[ks], kf[2], kf[3]);
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = sb * 16 + 8 * n + tq + (e & 1);
            sc[n][e] = j < vis ? sc[n][e] * sl : NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        float alpha[2], mb[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float mn = fmaxf(m[hh], mx[hh]);
          alpha[hh] = wg::fast_exp2(m[hh] - mn);
          m[hh] = mn;
          mb[hh] = mn > NEG_INF * 0.5f ? mn : 0.f;  // exp2(NEG_INF - 0) = 0
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[n][e] = wg::fast_exp2(sc[n][e] - mb[e >> 1]);
            psum[e >> 1] += sc[n][e];
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + psum[hh];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          oa[n][0] *= alpha[0];
          oa[n][1] *= alpha[0];
          oa[n][2] *= alpha[1];
          oa[n][3] *= alpha[1];
        }
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                                pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]),
                                pack_bf16(sc[1][2], sc[1][3])};
        const int vr = sb * 16 + (lane & 15);
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, swz(vt, lay.box, vr, dp * 16 + (lane >> 4) * 8));
          mma_bf16(oa[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(oa[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[st]);  // this warp read it
    }
  }

  // Merge: the two warps of a row tile (chunks of either parity) through
  // shared memory, the ring's bytes (every copy has landed and been read).
  __syncthreads();
  float* Wm = reinterpret_cast<float*>(base);  // [WARPS][16]
  float* Wl = Wm + WARPS * 16;                 // [WARPS][16]
  float* Wa = Wl + WARPS * 16;                 // [WARPS][16][DMAX]
  if (warp > 0) {  // a warp with no live rows leaves (NEG_INF, 0, 0)
    const int tq = 2 * (lane & 3), g = lane >> 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if ((lane & 3) == 0) {
        Wm[cw * 16 + g + 8 * hh] = m[hh];
        Wl[cw * 16 + g + 8 * hh] = l[hh];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* wa = Wa + (cw * 16 + g + 8 * hh) * DMAX + 8 * n + tq;
        wa[0] = oa[n][2 * hh];
        wa[1] = oa[n][2 * hh + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * Dh; i += ROWS_THREADS) {
    const int r = i / Dh, d = i % Dh;
    const int w0 = (r >> 4) * 16 + (r & 15);  // row r in warp r / 16's
    const int w1 = w0 + 2 * 16;               // ... and in the pair's other
    float M = NEG_INF;
    if (Wl[w0] > 0.f) M = Wm[w0];
    if (Wl[w1] > 0.f) M = fmaxf(M, Wm[w1]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int w = k ? w1 : w0;
      if (Wl[w] > 0.f) {  // a warp that saw nothing: weight 0
        const float wt = exp2f(Wm[w] - M);
        lsum += wt * Wl[w];
        a += wt * Wa[w * DMAX + d];
      }
    }
    pacc[(size_t)(r0 + r) * Dh + d] = a;
    if (d == 0) {
      pm[r0 + r] = M;
      pl[r0 + r] = lsum;
    }
  }
}

template <int DMAX>
cudaError_t launch_rows(const void* qg, const void* kp, const void* vp,
                        const void* table, const void* limit, void* o,
                        void* lse, void* part, int S, int Hkv, int R, int Dh,
                        int ps, int max_pages, int pps, int pool_pages,
                        float sqrt_dh, int q_bf16, cudaStream_t stream) {
  const RowsLayout lay(ps, DMAX / 64, pps);
  // The pool as (Dh, page rows, page * H_kv + head): a chunk's box past a
  // page's last row lands as zeros, never the next head's rows.
  CUtensorMap tk, tv;
  if (!hvd_wgmma::map_heads(&tk, kp, pool_pages * Hkv, ps, Dh, lay.ch) ||
      !hvd_wgmma::map_heads(&tv, vp, pool_pages * Hkv, ps, Dh, lay.ch))
    return cudaErrorInvalidValue;
  auto kern = paged_attend_rows_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err != cudaSuccess) return err;
  const int n_split = (max_pages + pps - 1) / pps;
  dim3 grid(S * Hkv, n_split, (R + ROWS_MAX - 1) / ROWS_MAX);
  kern<<<grid, ROWS_THREADS, lay.smem, stream>>>(
      tk, tv, qg, static_cast<const int*>(table),
      static_cast<const int*>(limit), static_cast<float*>(part), Hkv, R, Dh,
      ps, max_pages, pps, sqrt_dh, q_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine(limit, o, lse, part, S, Hkv, R, Dh, ps, max_pages,
                        pps, stream);
}

template <typename P, typename C, int RB, int L>
cudaError_t launch(const void* qg, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* limit, void* o, void* lse, void* part, int S,
                   int Hkv, int R, int Dh, int ps, int max_pages, int pps,
                   float sqrt_dh, int q_bf16, cudaStream_t stream) {
  const int cr = chunk_rows(Dh, sizeof(P));
  const size_t smem = 2 * sizeof(P) * STAGES * cr * Dh +
                      sizeof(float) * (2 * STAGES * cr +
                                       WARPS * RB * (2 + Dh)) +
                      sizeof(int) * pps;
  auto kern = paged_attend_split_kernel<P, C, RB, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_split = (max_pages + pps - 1) / pps;
  dim3 grid(S * Hkv, n_split, (R + RB - 1) / RB);
  kern<<<grid, THREADS, smem, stream>>>(
      qg, static_cast<const P*>(kp), static_cast<const P*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(limit),
      static_cast<float*>(part), Hkv, R, Dh, ps, max_pages, pps, sqrt_dh,
      q_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine(limit, o, lse, part, S, Hkv, R, Dh, ps, max_pages,
                        pps, stream);
}

template <typename P, typename C>
cudaError_t launch_rb(const void* qg, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* table,
                      const void* limit, void* o, void* lse, void* part,
                      int S, int Hkv, int R, int Dh, int ps, int max_pages,
                      int pps, float sqrt_dh, int q_bf16, cudaStream_t st) {
#define HVD_PAGED_LAUNCH(RB, L)                                              \
  return launch<P, C, RB, L>(qg, kp, vp, ks, vs, table, limit, o, lse, part, \
                             S, Hkv, R, Dh, ps, max_pages, pps, sqrt_dh,     \
                             q_bf16, st)
  if (R <= 4 && Dh <= 64) HVD_PAGED_LAUNCH(4, 8);
  if (R <= 4) HVD_PAGED_LAUNCH(4, 16);
  if (Dh <= 64) HVD_PAGED_LAUNCH(8, 8);
  HVD_PAGED_LAUNCH(8, 16);
#undef HVD_PAGED_LAUNCH
}

}  // namespace

// pool_kind: 0 = f32, 1 = bf16, 2 = int8 (ks / vs then hold the
// per-vector f32 scales).  compute_bf16 selects the dequant target of
// int8 pools; unquantized pools compute in their stored type.  q_bf16:
// qg is bf16 (else f32).  part is f32 scratch of S * Hkv * n_split * R *
// (Dh + 2) values, n_split = ceil(max_pages / pages_per_split), and
// pages_per_split <= 1024.  Dh must be a multiple of 8 (16 for int8) and
// at most 128; pools 16-byte aligned (the wrapper checks); pool_pages is
// the pools' page count P.
//
// One kernel for each (pool, R), chosen here (not a fallback): a bf16
// pool with R > 8 runs the tensor-core rows kernel (R in blocks of 32,
// every page read once a block); R <= 8 and the f32 and int8 pools run
// the split kernel (f32 needs exact f32 FMAs; int8 would need a
// dequantising pass in front of the tensor cores).  split_grid
// (ops/paged_attention.py) mirrors the choice for the row blocks.
extern "C" int paged_attend(const void* qg, const void* kp, const void* vp,
                            const void* ks, const void* vs,
                            const void* table, const void* limit, void* o,
                            void* lse, int S, int Hkv, int R, int Dh,
                            int ps, int max_pages, int pool_kind,
                            int compute_bf16, float sqrt_dh, void* stream,
                            void* part, int pages_per_split, int q_bf16,
                            int pool_pages) {
  if (S < 1 || Hkv < 1 || R < 1 || Dh < 8 || Dh > DH_MAX || Dh % 8 ||
      (pool_kind == 2 && Dh % 16) || ps < 1 || max_pages < 1 ||
      pool_pages < 1 ||
      pages_per_split < 1 || pages_per_split > PPS_MAX ||
      (max_pages + pages_per_split - 1) / pages_per_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pps = pages_per_split;
  if (pool_kind == 1 && R > ROWS_MIN && Dh <= 64)
    return (int)launch_rows<64>(qg, kp, vp, table, limit, o, lse, part, S,
                                Hkv, R, Dh, ps, max_pages, pps, pool_pages,
                                sqrt_dh, q_bf16, st);
  if (pool_kind == 1 && R > ROWS_MIN)
    return (int)launch_rows<128>(qg, kp, vp, table, limit, o, lse, part, S,
                                 Hkv, R, Dh, ps, max_pages, pps, pool_pages,
                                 sqrt_dh, q_bf16, st);
  if (pool_kind == 0)
    return (int)launch_rb<float, float>(qg, kp, vp, ks, vs, table, limit, o,
                                        lse, part, S, Hkv, R, Dh, ps,
                                        max_pages, pps, sqrt_dh, q_bf16, st);
  if (pool_kind == 1)
    return (int)launch_rb<__nv_bfloat16, __nv_bfloat16>(
        qg, kp, vp, ks, vs, table, limit, o, lse, part, S, Hkv, R, Dh, ps,
        max_pages, pps, sqrt_dh, q_bf16, st);
  if (pool_kind == 2 && compute_bf16)
    return (int)launch_rb<int8_t, __nv_bfloat16>(
        qg, kp, vp, ks, vs, table, limit, o, lse, part, S, Hkv, R, Dh, ps,
        max_pages, pps, sqrt_dh, q_bf16, st);
  if (pool_kind == 2)
    return (int)launch_rb<int8_t, float>(qg, kp, vp, ks, vs, table, limit, o,
                                         lse, part, S, Hkv, R, Dh, ps,
                                         max_pages, pps, sqrt_dh, q_bf16, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
