// K1: flash-attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/attention.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`).  Same function: tiled
// attention with an online softmax in f32, optional causal mask
// (col <= row), K tiles wholly above the diagonal skipped, `o` in the
// input dtype and the row logsumexp in f32; a fully masked row gives
// o = 0 and lse = NEG_INF.  Rounding points mirror the JAX kernel:
// s = (q . k) * scale in f32 (bf16 products are exact in f32), p cast to
// V's dtype before p . v, f32 accumulation, o cast to the input dtype.
//
// GQA: K/V keep their H_kv heads and query head h reads kv head
// h / (H / H_kv), the grouping of `jnp.repeat` in `expand_kv`, so no
// expanded copy of K/V is ever materialised.
//
// Bound on an H100: at the serving prefill shape (B=2, H=16, H_kv=4,
// S=T=2048, D=64, bf16, causal) the work is ~17 GFLOP against ~21 MB
// of inputs and outputs, so the tensor-core rate (989 TFLOP/s, ~17 us)
// bounds it, not HBM (~6 us).  This first version is the simple, right
// one: one CTA per (batch*head, 64-row Q tile), 256 threads, four per
// query row; each 64-column K/V tile is staged in shared memory as f32
// and the products run as scalar f32 FMAs from shared memory.  It
// therefore runs at CUDA-core rate, far from the bound; moving the two
// products onto wgmma/mma.sync with TMA-fed tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key columns per staged tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG_INF = -1e30f;

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int H, int Hkv, int S, int Tn, int causal, float scale) {
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

  const T* qrow = q + ((size_t)bh * S + (row_ok ? row : 0)) * D;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Tn * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? to_f(qrow[d]) : 0.f;

  constexpr int NC = D / TPR;       // output columns per thread
  constexpr int NS = BK / TPR;      // scores per thread per tile
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  // Causal: tiles starting past this CTA's last row contribute nothing.
  const int t_end = causal ? min(Tn, q0 + BQ) : Tn;
  for (int t0 = 0; t0 < t_end; t0 += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D, t = t0 + j;
      float kk = 0.f, vv = 0.f;
      if (t < Tn) {
        kk = to_f(kb[(size_t)t * D + d]);
        vv = to_f(vb[(size_t)t * D + d]);
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
      const bool ok = row_ok && col < Tn && (!causal || col <= row);
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
      Ps[r * (BK + 1) + sub + TPR * jj] = to_f(from_f<T>(p));  // p in V's dtype
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
  T* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    orow[sub + TPR * c] = from_f<T>(live ? acc[c] / l : 0.f);
  }
  if (sub == 0) lse[(size_t)bh * S + row] = live ? m + logf(l) : NEG_INF;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int S, int Tn,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BK * (D + 1) + BK * D + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, S, Tn, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int H, int Hkv, int S,
                         int T, int D, int is_bf16, int causal, float scale,
                         void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Hkv, S, T,
                                    causal, scale, st);
  else if (is_bf16 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, S, T,
                                     causal, scale, st);
  else if (!is_bf16 && D == 64)
    err = launch<float, 64>(q, k, v, o, lse, B, H, Hkv, S, T, causal,
                            scale, st);
  else if (!is_bf16 && D == 128)
    err = launch<float, 128>(q, k, v, o, lse, B, H, Hkv, S, T, causal,
                             scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
