// K4: paged-attention decode for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/paged_attention.py
// `_kernel_body` (launched by `_pallas_paged_attend`).  Same function:
// R grouped query rows of one (slot, kv head) attend straight against
// the paged KV pool.  The kernel reads each physical page id from the
// slot's table row itself, masks logical positions >= limit[s], runs
// the online softmax over pages in f32 and writes o (f32) and the row
// logsumexp; limit == 0 gives o = 0 and lse = NEG_INF.  int8 pages are
// dequantized in the load as (float)q * scale, then rounded to the
// compute dtype before the dot (`DEQUANT_COMPUTE`); q is rounded to the
// compute dtype, p to V's dtype before p . v, sums stay in f32.
//
// Bound on an H100: decode attention is bandwidth-bound.  At the serving
// shape (8 slots, H_kv=4, R=4, Dh=64, page 16, 136 pages a slot, bf16)
// a full pool is ~2.2 MB of K/V per slot per layer, ~5 us at 3.35 TB/s.
// This first version is the simple, right one: one CTA of 128 threads
// per (slot, kv head), walking the slot's live pages one at a time,
// each page staged in shared memory as f32.  That grid is 32 CTAs, so it
// fills only 32 of the 132 SMs, and each page costs a round trip to
// HBM plus three barriers; it runs far from the bound.  Split-K
// flash-decoding (pages split across CTAs, an LSE-combine pass) is the
// later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// Round an f32 value to the compute type C and back (identity for f32).
template <typename C> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// P: stored pool type (float / bf16 / int8).  C: compute type — the
// pool's own type when unquantized, the model dtype for int8 pools.
template <typename P, typename C>
__global__ void __launch_bounds__(THREADS) paged_attend_kernel(
    const float* __restrict__ qg, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ limit, float* __restrict__ o,
    float* __restrict__ lse, int Hkv, int R, int Dh, int ps, int max_pages,
    float sqrt_dh) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [R][Dh]
  float* Ks = Qs + R * Dh;            // [ps][Dh + 1]
  float* Vs = Ks + ps * (Dh + 1);     // [ps][Dh]
  float* Ss = Vs + ps * Dh;           // [R][ps]
  float* Acc = Ss + R * ps;           // [R][Dh]
  float* Ms = Acc + R * Dh;           // [R] running max
  float* Ls = Ms + R;                 // [R] running sum
  float* As = Ls + R;                 // [R] this page's rescale

  const int blk = blockIdx.x;         // s * Hkv + h
  const int s = blk / Hkv, h = blk % Hkv;
  const int tid = threadIdx.x;
  const int lim = limit[s];
  constexpr bool quantized = sizeof(P) == 1;

  for (int i = tid; i < R * Dh; i += THREADS) {
    Qs[i] = round_to<C>(qg[(size_t)blk * R * Dh + i]);
    Acc[i] = 0.f;
  }
  for (int i = tid; i < R; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.f;
  }
  __syncthreads();

  for (int b = 0; b < max_pages && b * ps < lim; ++b) {
    const size_t pg = (size_t)table[(size_t)s * max_pages + b];
    const size_t base = (pg * Hkv + h) * (size_t)ps * Dh;
    const size_t sbase = (pg * Hkv + h) * (size_t)ps;
    for (int i = tid; i < ps * Dh; i += THREADS) {
      const int j = i / Dh, d = i % Dh;
      float kk = to_f(kp[base + i]), vv = to_f(vp[base + i]);
      if constexpr (quantized) {  // fused dequant: f32 multiply, one rounding
        kk = round_to<C>(kk * ks[sbase + j]);
        vv = round_to<C>(vv * vs[sbase + j]);
      }
      Ks[j * (Dh + 1) + d] = kk;
      Vs[j * Dh + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < R * ps; i += THREADS) {
      const int rr = i / ps, j = i % ps;
      const float* qr = Qs + rr * Dh;
      const float* kr = Ks + j * (Dh + 1);
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ss[i] = b * ps + j < lim ? dot / sqrt_dh : NEG_INF;
    }
    __syncthreads();

    for (int rr = tid; rr < R; rr += THREADS) {
      float* sr = Ss + rr * ps;
      float mx = NEG_INF;
      for (int j = 0; j < ps; ++j) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(Ms[rr], mx);
      float psum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float p = expf(sr[j] - m_new);  // masked lanes: exp(-1e30) = 0
        psum += p;
        sr[j] = round_to<C>(p);               // p in V's dtype
      }
      const float alpha = expf(Ms[rr] - m_new);
      Ls[rr] = alpha * Ls[rr] + psum;
      Ms[rr] = m_new;
      As[rr] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < R * Dh; i += THREADS) {
      const int rr = i / Dh, d = i % Dh;
      const float* pr = Ss + rr * ps;
      float pv = 0.f;
      for (int j = 0; j < ps; ++j) pv = fmaf(pr[j], Vs[j * Dh + d], pv);
      Acc[i] = Acc[i] * As[rr] + pv;
    }
    __syncthreads();  // before the next page overwrites Ks / Vs / Ss
  }

  for (int i = tid; i < R * Dh; i += THREADS) {
    const float l = Ls[i / Dh];
    o[(size_t)blk * R * Dh + i] = l > 0.f ? Acc[i] / l : 0.f;
  }
  for (int rr = tid; rr < R; rr += THREADS) {
    const float l = Ls[rr];
    lse[(size_t)blk * R + rr] = l > 0.f ? Ms[rr] + logf(l) : NEG_INF;
  }
}

template <typename P, typename C>
cudaError_t launch(const void* qg, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* limit, void* o, void* lse, int S, int Hkv,
                   int R, int Dh, int ps, int max_pages, float sqrt_dh,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * R * Dh + ps * (Dh + 1) +
                                       ps * Dh + R * ps + 3 * R);
  auto kern = paged_attend_kernel<P, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<S * Hkv, THREADS, smem, stream>>>(
      static_cast<const float*>(qg), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(limit), static_cast<float*>(o),
      static_cast<float*>(lse), Hkv, R, Dh, ps, max_pages, sqrt_dh);
  return cudaGetLastError();
}

}  // namespace

// pool_kind: 0 = f32, 1 = bf16, 2 = int8 (ks / vs then hold the
// per-vector f32 scales).  compute_bf16 selects the dequant target of
// int8 pools; unquantized pools compute in their stored type.
extern "C" int paged_attend(const void* qg, const void* kp, const void* vp,
                            const void* ks, const void* vs,
                            const void* table, const void* limit, void* o,
                            void* lse, int S, int Hkv, int R, int Dh,
                            int ps, int max_pages, int pool_kind,
                            int compute_bf16, float sqrt_dh, void* stream) {
  if (S < 1 || Hkv < 1 || R < 1 || Dh < 1 || ps < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pool_kind == 0)
    err = launch<float, float>(qg, kp, vp, ks, vs, table, limit, o, lse, S,
                               Hkv, R, Dh, ps, max_pages, sqrt_dh, st);
  else if (pool_kind == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(qg, kp, vp, ks, vs, table,
                                               limit, o, lse, S, Hkv, R, Dh,
                                               ps, max_pages, sqrt_dh, st);
  else if (pool_kind == 2 && compute_bf16)
    err = launch<int8_t, __nv_bfloat16>(qg, kp, vp, ks, vs, table, limit, o,
                                        lse, S, Hkv, R, Dh, ps, max_pages,
                                        sqrt_dh, st);
  else if (pool_kind == 2)
    err = launch<int8_t, float>(qg, kp, vp, ks, vs, table, limit, o, lse, S,
                                Hkv, R, Dh, ps, max_pages, sqrt_dh, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
