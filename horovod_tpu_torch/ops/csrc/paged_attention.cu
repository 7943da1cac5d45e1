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
// Bound on an H100: decode attention does ~4 FLOP a byte of K/V, far
// under the ~295 at which the tensor cores would matter, so HBM bounds
// it: at the serving shape (8 slots, H_kv=4, R=4, Dh=64, page 16, 136
// pages a slot, bf16) a full table is ~17.8 MB of K/V, ~5.3 us at
// 3.35 TB/s.  The only lever is keeping enough bytes in flight across
// all 132 SMs; scores and p . v run on the CUDA cores.
//
// Split-K flash-decoding, two kernels on one stream:
//
// * `paged_attend_split_kernel`: grid (slot * H_kv, split, R block).
//   Split i takes the fixed run of table entries [i * pps, (i+1) * pps)
//   (pps, pages a split, is chosen by the caller from S, H_kv and
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
//   products are summed by shuffles.  Scores are kept in log2 units, so
//   each exponential is one exp2.  Each warp keeps its own online softmax
//   (m, l, acc) in registers for up to RB query rows (the template's R
//   block, 4 or 8; a larger R takes more grid z blocks), merged across
//   its groups and then across the 4 warps once at the end.  The partial
//   (m, l, acc[R][Dh]) goes to f32 scratch that the wrapper allocated.
//   q is read in its own dtype (f32 or bf16).
// * `paged_attend_combine_kernel`: one CTA per (slot, kv head) reads its
//   live splits in index order: m = max over splits with l > 0,
//   o = sum e^(m_i - m) acc_i / sum e^(m_i - m) l_i and
//   lse = m + log sum e^(m_i - m) l_i, the weights staged in shared
//   memory once a row.  A split with l = 0 gets weight 0 explicitly (its
//   e^(NEG_INF - NEG_INF) would be 1).  No atomics: the result is the
//   same, bit for bit, from call to call.
//
// Tensor cores are not used: at ~4 FLOP a byte they would wait on HBM
// exactly as the CUDA cores do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// One CTA per (slot, kv head).  Shared memory: [n_split][R] split
// weights, [n_split][R] weighted row sums, [R] row sums.
__global__ void __launch_bounds__(THREADS) paged_attend_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ limit,
    float* __restrict__ o, float* __restrict__ lse, int Hkv, int R, int Dh,
    int ps, int max_pages, int pps, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int blk = blockIdx.x;  // s * Hkv + h
  const int s = blk / Hkv;
  const int n_blk = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
  for (int r = warp; r < R; r += WARPS) {
    float M = NEG_INF;
    for (int k = lane; k < n_live; k += 32)
      if (pl[k * R + r] > 0.f) M = fmaxf(M, pm[k * R + r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    for (int k = lane; k < n_live; k += 32) {
      const float lk = pl[k * R + r];
      // An empty split gets weight 0 explicitly, not e^(NEG_INF - NEG_INF).
      const float w = lk > 0.f ? exp2f(pm[k * R + r] - M) : 0.f;
      W[k * R + r] = w;
      WL[k * R + r] = w * lk;
    }
    __syncwarp();
    if (lane == 0) {
      float lsum = 0.f;
      for (int k = 0; k < n_live; ++k) lsum += WL[k * R + r];
      Ls[r] = lsum;
      lse[(size_t)blk * R + r] = lsum > 0.f ? M * LN2 + logf(lsum) : NEG_INF;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * Dh; i += THREADS) {
    const int r = i / Dh, d = i % Dh;
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_live; ++k)
      a = fmaf(W[k * R + r], pacc[((size_t)k * R + r) * Dh + d], a);
    const float lsum = Ls[r];
    o[((size_t)blk * R + r) * Dh + d] = lsum > 0.f ? a / lsum : 0.f;
  }
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
  const size_t csmem = sizeof(float) * ((size_t)2 * n_split * R + R);
  err = cudaFuncSetAttribute(paged_attend_combine_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)csmem);
  if (err != cudaSuccess) return err;
  paged_attend_combine_kernel<<<S * Hkv, THREADS, csmem, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(limit),
      static_cast<float*>(o), static_cast<float*>(lse), Hkv, R, Dh, ps,
      max_pages, pps, n_split);
  return cudaGetLastError();
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
// at most 128; pools 16-byte aligned (the wrapper checks).
extern "C" int paged_attend(const void* qg, const void* kp, const void* vp,
                            const void* ks, const void* vs,
                            const void* table, const void* limit, void* o,
                            void* lse, int S, int Hkv, int R, int Dh,
                            int ps, int max_pages, int pool_kind,
                            int compute_bf16, float sqrt_dh, void* stream,
                            void* part, int pages_per_split, int q_bf16) {
  if (S < 1 || Hkv < 1 || R < 1 || Dh < 8 || Dh > DH_MAX || Dh % 8 ||
      (pool_kind == 2 && Dh % 16) || ps < 1 || max_pages < 1 ||
      pages_per_split < 1 || pages_per_split > PPS_MAX ||
      (max_pages + pages_per_split - 1) / pages_per_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pps = pages_per_split;
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
