// G1 and G2: the grouped (ragged) matrix products of the dropless
// mixture-of-experts dispatch and its backward, for Hopper (sm_90a),
// plain C ABI.
//
// No Pallas original: the counterparts of the XLA op `lax.ragged_dot(xs,
// W, counts)` and of its VJP, which the JAX package's dropless
// mixture-of-experts dispatch (horovod_tpu/ops/moe.py `dropless_moe`)
// runs for the experts' gate, up and down products:
//
//   G1 forward:     out[t, :] = xs[t, :] @ W[g(t)]
//   G1 transposed:  dx[t, :] = dy[t, :] @ W[g(t)]^T        (the input's grad)
//   G2:             dW[e] = sum over t in group e of xs[t]^T dy[t]
//
// g(t) = the e with off[e] <= t < off[e+1]; xs (T, K) sorted by group, W
// (E, K, N), outputs in the input dtype, f32 accumulation.  `offsets`
// (E + 1 int32, the cumsum of the group sizes with a leading 0) is READ
// FROM DEVICE MEMORY: the serving engine captures each admission shape,
// and the train step each batch shape, once as a CUDA graph, which bakes
// the launch's arguments, while the group sizes change with every batch.
// So every grid depends on the shapes only.
//
// Row invariance, which the serving gates rest on (a bucket-padded
// admission against the single-request oracle): a row's G1 output bits
// depend only on that row and its group's weights.  Every tile runs the
// same K loop in one order, with no split-K, and the tile a row falls in
// changes only which registers hold it.  So neither T, nor the other
// groups' sizes, nor the row's place in its tile changes its bits.  G2
// walks its group's rows in one fixed order with no atomics and no split
// over rows, so it is reproducible bit for bit (graph replay = eager).
//
// Bound on an H100: at the MoE prefill's gate product (T = 8192, K =
// 1024, N = 2048, E = 8, bf16) the work is 34 GFLOP against ~84 MB of
// inputs and outputs, so the tensor-core rate bounds it (989 TFLOP/s,
// ~35 us), not HBM (~25 us); G2 at that shape likewise.
//
// Kernels, chosen by dtype and mode in the C entry points (not a
// fallback: each has exactly one):
//
// * G1 bf16, both modes (`grouped_mm_kernel_wgmma`): warp-specialised and
//   persistent (wgmma_tma.cuh).  A CTA of three warpgroups: one thread
//   of the first issues TMA loads into a WG_STAGES-deep ring of 128 x 64
//   tiles of xs and 64 x 128 tiles of W[e], 128-byte swizzled, with
//   completion on mbarriers; the other two each multiply 64 rows of the
//   128 x 128 output tile with wgmma.m64n128k16 (f32 accumulators in
//   registers), keeping one stage's products in flight while releasing
//   the stage before.  W's layout is the descriptor's transpose bit: the
//   forward reads W[e] (K, N) MN-major, dx reads it as W[e]^T, K-major.
//   One CTA an SM (the grid: the SM count, or fewer tiles); each walks
//   the (row tile, column tile) list with a stride of the grid, the
//   groups' row tiles numbered from a prefix of tile counts built in
//   shared memory from the device offsets; the producer runs ahead into
//   the next tile while the consumers store this one.  A row tile that
//   starts in group e may run past the group's end into the next group's
//   rows (or past T: TMA fills those with zeros): they are multiplied by
//   W[e] and never stored (stores from registers, predicated on row <
//   row_end).  Tile and ring: 128 x 128 with 6 stages was the fastest
//   of the variants timed on the card (128 x 256 with the 4 stages that
//   fit; the two consumers taking whole tiles in turns, ping-pong).
// * G1 f32 (`grouped_mm_kernel<TRANS_W>`): scalar FMAs, 256 threads on a
//   64 x 64 tile, 4 x 4 outputs a thread, each a sequential fmaf over k
//   (TF32 tensor cores would miss the f32 contract, as for K1-K3); grid
//   ceil(T / 64) + E row tiles (each group starts its own tiles) by
//   ceil(N / 64), a CTA walking the offsets to find its tile.
// * G2 bf16 (`grouped_dw_kernel_mma`): mma.sync.m16n8k16 (mma_bf16.cuh);
//   a CTA of 4 warps (2 x 2) computes a 64 x 128 tile of dW[e] from
//   32-row stages of xs and dy, double buffered with cp.async; xs's tile
//   (rows t, K contiguous) is read as A^T with ldmatrix.trans.  Grid E x
//   ceil(K / 64) by ceil(N / 128), from shapes alone; a CTA reads its
//   group's two offsets and loops over the group's rows.  An empty group
//   writes zeros.
// * G2 f32 (`grouped_dw_kernel`): scalar, 64 x 64 tiles as G1's f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

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

// --- G1 bf16: wgmma + TMA -----------------------------------------------------

constexpr int WG_BM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int WG_BN = 128;  // output columns a tile: wgmma's N
constexpr int WG_BK = 64;   // K a stage: one 128-byte swizzle row of bf16
constexpr int WG_STAGES = 6;
constexpr int WG_THREADS = 384;  // producer warpgroup + 2 consumers
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;
constexpr int WG_SMEM = 1024 /* alignment slack */ +
                        WG_STAGES * (WG_A_BYTES + WG_B_BYTES) +
                        2 * WG_STAGES * 8 + 2 * (MAX_GROUPS + 1) * 4;

// Row tile `r` of the list: its group, first row and the group's end.
__device__ __forceinline__ void row_tile(const int* first, const int* lo,
                                         int r, int& e, int& row0,
                                         int& row_end) {
  e = 0;
  while (first[e + 1] <= r) ++e;
  row0 = lo[e] + (r - first[e]) * WG_BM;
  row_end = lo[e + 1];
}

// B_MN_MAJOR 1: the forward, B = W[e] (Kd x Nd, Nd contiguous), loaded
// as WG_BN / 64 boxes of 64 columns x 64 k.  0: dx, B = W[e]^T with W[e]
// (Nd x Kd, Kd contiguous), one box of 64 k x WG_BN rows.
template <int B_MN_MAJOR>
__global__ void __launch_bounds__(WG_THREADS, 1) grouped_mm_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_a,
    __grid_constant__ const CUtensorMap tm_b, const int* __restrict__ offsets,
    bf16* __restrict__ out, int T, int Kd, int Nd, int E) {
  using namespace hvd_wgmma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(base);
  bf16* sB = reinterpret_cast<bf16*>(base + WG_STAGES * WG_A_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + WG_STAGES * (WG_A_BYTES + WG_B_BYTES));
  uint64_t* empty = full + WG_STAGES;
  int* first = reinterpret_cast<int*>(empty + WG_STAGES);  // row tiles
  int* lo = first + MAX_GROUPS + 1;                        // clamped offsets

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    fence_mbar_init();
    int l = min(max(offsets[0], 0), T);
    first[0] = 0;
    lo[0] = l;
    for (int e = 0; e < E; ++e) {
      const int h = min(max(offsets[e + 1], l), T);
      first[e + 1] = first[e] + (h - l + WG_BM - 1) / WG_BM;
      lo[e + 1] = h;
      l = h;
    }
  }
  __syncthreads();
  const int n_col = (Nd + WG_BN - 1) / WG_BN;
  const int n_tiles = first[E] * n_col;
  const int nk = (Kd + WG_BK - 1) / WG_BK;

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, row0, row_end;
      row_tile(first, lo, tile / n_col, e, row0, row_end);
      const int n0 = (tile % n_col) * WG_BN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], WG_A_BYTES + WG_B_BYTES);
        tma_load_2d(sA + stage * (WG_BM * WG_BK), &tm_a, kb * WG_BK, row0,
                    &full[stage]);
        bf16* b = sB + stage * (WG_BK * WG_BN);
        if (B_MN_MAJOR) {
#pragma unroll
          for (int j = 0; j < WG_BN / 64; ++j)
            tma_load_3d(b + j * 64 * WG_BK, &tm_b, n0 + 64 * j, kb * WG_BK, e,
                        &full[stage]);
        } else {
          tma_load_3d(b, &tm_b, kb * WG_BK, n0, e, &full[stage]);
        }
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumer warpgroups: rows [64 half, 64 half + 64) of each tile.
  setmaxnreg_inc<232>();
  const int half = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  float acc[WG_BN / 2];
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, row0, row_end;
    row_tile(first, lo, tile / n_col, e, row0, row_end);
    const int n0 = (tile % n_col) * WG_BN;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      const bf16* a = sA + stage * (WG_BM * WG_BK) + half * 64 * WG_BK;
      const bf16* b = sB + stage * (WG_BK * WG_BN);
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = make_desc(a + kk * 16, 16, 1024);
        const uint64_t db = B_MN_MAJOR
                                ? make_desc(b + kk * 16 * 64, 64 * WG_BK * 2,
                                            1024)
                                : make_desc(b + kk * 16, 16, 1024);
        wgmma_m64n128k16<B_MN_MAJOR>(acc, da, db, kb > 0 || kk > 0);
      }
      wgmma_commit();
      // Every product but this stage's has finished: release the last.
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < WG_BN / 2; ++i) fence_operand(acc[i]);

    const int rbase = row0 + half * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
      if (col >= Nd) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h;
        if (row >= row_end) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * Nd + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// --- f32: scalar FMAs ---------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int F_THREADS = 256;  // 16 x 16, 4 x 4 outputs a thread

// G1 f32.  TRANS_W 0: B(k, n) = W[e][k][n] (Kd x Nd); 1: B(k, n) =
// W[e][n][k] (dx: W[e] is Nd x Kd).
template <int TRANS_W>
__global__ void __launch_bounds__(F_THREADS) grouped_mm_kernel(
    const float* __restrict__ xs, const float* __restrict__ w,
    const int* __restrict__ offsets, float* __restrict__ out, int T, int Kd,
    int Nd, int E) {
  int e, row0, row_end;
  if (!find_tile(offsets, E, T, FBM, blockIdx.x, e, row0, row_end)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [FBM][FBK + 1]
  float* Bs = As + FBM * (FBK + 1);                 // [FBK][FBN + 1]
  const float* we = w + (size_t)e * Kd * Nd;
  const int n0 = blockIdx.y * FBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kd; k0 += FBK) {
    for (int i = threadIdx.x; i < FBM * FBK; i += F_THREADS) {
      const int r = i / FBK, c = i % FBK;
      const int row = row0 + r, k = k0 + c;
      As[r * (FBK + 1) + c] =
          row < row_end && k < Kd ? xs[(size_t)row * Kd + k] : 0.f;
    }
    for (int i = threadIdx.x; i < FBK * FBN; i += F_THREADS) {
      // Neighbouring threads on neighbouring addresses of W either way.
      const int r = TRANS_W ? i % FBK : i / FBN;
      const int c = TRANS_W ? i / FBK : i % FBN;
      const int k = k0 + r, n = n0 + c;
      Bs[r * (FBN + 1) + c] =
          k < Kd && n < Nd
              ? we[TRANS_W ? (size_t)n * Kd + k : (size_t)k * Nd + n]
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * (FBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * (FBN + 1) + tx + 16 * j];
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
      if (col < Nd) out[(size_t)row * Nd + col] = acc[i][j];
    }
  }
}

// --- G2: the weight gradient --------------------------------------------------

// This CTA's group's rows [lo, hi), clamped to [0, T].
__device__ __forceinline__ void group_rows(const int* __restrict__ offsets,
                                           int e, int T, int& lo, int& hi) {
  lo = min(max(offsets[e], 0), T);
  hi = min(max(offsets[e + 1], lo), T);
}

constexpr int DW_BM = 64;   // rows of dW[e] (K) a CTA
constexpr int DW_BN = 128;  // columns of dW[e] (N) a CTA
constexpr int DW_BT = 32;   // token rows a stage
constexpr int DW_LDA = DW_BM + 8;
constexpr int DW_LDB = DW_BN + 8;
constexpr int DW_THREADS = 128;

__device__ __forceinline__ void load_dw_stage(bf16* As, bf16* Bs,
                                              const bf16* __restrict__ xs,
                                              const bf16* __restrict__ dy,
                                              int t0, int t_end, int k0,
                                              int n0, int K, int N) {
  for (int i = threadIdx.x; i < DW_BT * (DW_BM / 8); i += DW_THREADS) {
    const int r = i / (DW_BM / 8), c = i % (DW_BM / 8);
    const int t = t0 + r, k = k0 + c * 8;
    const bool ok = t < t_end && k < K;
    hvd_mma::cp_async16(As + r * DW_LDA + c * 8,
                        xs + (ok ? (size_t)t * K + k : 0), ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < DW_BT * (DW_BN / 8); i += DW_THREADS) {
    const int r = i / (DW_BN / 8), c = i % (DW_BN / 8);
    const int t = t0 + r, n = n0 + c * 8;
    const bool ok = t < t_end && n < N;
    hvd_mma::cp_async16(Bs + r * DW_LDB + c * 8,
                        dy + (ok ? (size_t)t * N + n : 0), ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(DW_THREADS) grouped_dw_kernel_mma(
    const bf16* __restrict__ xs, const bf16* __restrict__ dy,
    const int* __restrict__ offsets, bf16* __restrict__ dw, int T, int K,
    int N) {
  const int k_tiles = (K + DW_BM - 1) / DW_BM;
  const int e = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * DW_BM, n0 = blockIdx.y * DW_BN;
  int lo, hi;
  group_rows(offsets, e, T, lo, hi);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [2][DW_BT][DW_LDA]
  bf16* Bs = As + 2 * DW_BT * DW_LDA;             // [2][DW_BT][DW_LDB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int nt = (hi - lo + DW_BT - 1) / DW_BT;
  if (nt > 0) {
    load_dw_stage(As, Bs, xs, dy, lo, hi, k0, n0, K, N);
    hvd_mma::cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    const int s = it & 1;
    if (it + 1 < nt)
      load_dw_stage(As + (s ^ 1) * DW_BT * DW_LDA,
                    Bs + (s ^ 1) * DW_BT * DW_LDB, xs, dy,
                    lo + (it + 1) * DW_BT, hi, k0, n0, K, N);
    hvd_mma::cp_async_commit();
    hvd_mma::cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const bf16* At = As + s * DW_BT * DW_LDA;
    const bf16* Bt = Bs + s * DW_BT * DW_LDB;
#pragma unroll
    for (int kk = 0; kk < DW_BT; kk += 16) {
      // A = xs^T: the stage holds xs's rows (t) with K contiguous, so the
      // A fragments of rows wm.. are ldmatrix.trans of the (t, k) blocks.
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        hvd_mma::ldsm_x4_trans(
            af[mi], hvd_mma::frag_b<DW_LDA>(At, kk, wm + mi * 16, lane));
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bfr[4];
        hvd_mma::ldsm_x4_trans(
            bfr, hvd_mma::frag_a<DW_LDB>(Bt, kk, wn + nj * 16, lane));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          hvd_mma::mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          hvd_mma::mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this stage
  }

  bf16* out = dw + (size_t)e * K * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wm + mi * 16 + g + 8 * h;
        if (row >= K) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

constexpr int FDT = 16;  // token rows a step of G2 f32

__global__ void __launch_bounds__(F_THREADS) grouped_dw_kernel(
    const float* __restrict__ xs, const float* __restrict__ dy,
    const int* __restrict__ offsets, float* __restrict__ dw, int T, int K,
    int N) {
  const int k_tiles = (K + FBM - 1) / FBM;
  const int e = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * FBM, n0 = blockIdx.y * FBN;
  int lo, hi;
  group_rows(offsets, e, T, lo, hi);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [FDT][FBM]
  float* Bs = As + FDT * FBM;                       // [FDT][FBN]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += FDT) {
    for (int i = threadIdx.x; i < FDT * FBM; i += F_THREADS) {
      const int r = i / FBM, c = i % FBM;
      const int t = t0 + r, k = k0 + c;
      As[i] = t < hi && k < K ? xs[(size_t)t * K + k] : 0.f;
    }
    for (int i = threadIdx.x; i < FDT * FBN; i += F_THREADS) {
      const int r = i / FBN, c = i % FBN;
      const int t = t0 + r, n = n0 + c;
      Bs[i] = t < hi && n < N ? dy[(size_t)t * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < FDT; ++tt) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[tt * FBM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tt * FBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// --- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links the CUDA runtime only, as every kernel library here.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first, `dims`), `strides` in
// bytes of dims 1.., read in boxes of `box`, 128-byte swizzled, zeros past
// every edge.  False if the driver refuses it.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const bf16* a, const bf16* w, const int* off, bf16* out,
                 int T, int K, int N, int E, int transpose_w,
                 cudaStream_t st) {
  // The product's reduction (Kd) and output (Nd) widths.
  const int Kd = transpose_w ? N : K, Nd = transpose_w ? K : N;
  CUtensorMap tm_a, tm_b;
  const cuuint64_t a_dims[2] = {(cuuint64_t)Kd, (cuuint64_t)T};
  const cuuint64_t a_strides[1] = {(cuuint64_t)Kd * 2};
  const cuuint32_t a_box[2] = {WG_BK, WG_BM};
  // W (E, K, N) as (N, K, E) innermost first.
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t fwd_box[3] = {64, WG_BK, 1};  // 64 columns x 64 k
  const cuuint32_t dx_box[3] = {WG_BK, WG_BN, 1};  // 64 k x WG_BN rows
  if (!encode(&tm_a, a, 2, a_dims, a_strides, a_box) ||
      !encode(&tm_b, w, 3, w_dims, w_strides, transpose_w ? dx_box : fwd_box))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Persistent: one CTA an SM, or one a tile where there are fewer tiles
  // than SMs.  Shapes only: the most row tiles any routing can need.
  const int most = ((T + WG_BM - 1) / WG_BM + E) * ((Nd + WG_BN - 1) / WG_BN);
  const dim3 grid(sms < most ? sms : most);
  auto kern = transpose_w ? grouped_mm_kernel_wgmma<0>
                          : grouped_mm_kernel_wgmma<1>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, WG_THREADS, WG_SMEM, st>>>(tm_a, tm_b, off, out, T, Kd, Nd, E);
  return (int)cudaGetLastError();
}

}  // namespace

// G1.  W is (E, K, N).  transpose_w 0: out (T, N) = a (T, K) @ W[group];
// 1: out (T, K) = a (T, N) @ W[group]^T.  Groups by `offsets` (E + 1 int32
// on the device).  bf16 runs the wgmma kernel, f32 the scalar one.
// Pointers must be 16-byte aligned (the wrapper checks).  Returns a
// cudaError_t; cudaErrorInvalidValue also when the driver refuses a
// tensor map.
extern "C" int grouped_matmul(const void* a, const void* w,
                              const void* offsets, void* out, int T, int K,
                              int N, int E, int is_bf16, int transpose_w,
                              void* stream) {
  if (T < 1 || E < 1 || E > MAX_GROUPS || K < 8 || N < 8 || K % 8 ||
      N % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (is_bf16)
    return launch_wgmma(static_cast<const bf16*>(a),
                        static_cast<const bf16*>(w), off,
                        static_cast<bf16*>(out), T, K, N, E, transpose_w, st);
  const int Kd = transpose_w ? N : K, Nd = transpose_w ? K : N;
  const size_t smem = sizeof(float) * (FBM * (FBK + 1) + FBK * (FBN + 1));
  auto kern = transpose_w ? grouped_mm_kernel<1> : grouped_mm_kernel<0>;
  dim3 grid((T + FBM - 1) / FBM + E, (Nd + FBN - 1) / FBN);
  kern<<<grid, F_THREADS, smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), off,
      static_cast<float*>(out), T, Kd, Nd, E);
  return (int)cudaGetLastError();
}

// G2: dw (E, K, N), dw[e] = xs[rows of e]^T @ dy[rows of e], xs (T, K), dy
// (T, N), groups by `offsets` (E + 1 int32 on the device).  Every element
// of dw is written (an empty group's as zeros).
extern "C" int grouped_matmul_dw(const void* xs, const void* dy,
                                 const void* offsets, void* dw, int T, int K,
                                 int N, int E, int is_bf16, void* stream) {
  if (T < 1 || E < 1 || E > MAX_GROUPS || K < 8 || N < 8 || K % 8 ||
      N % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (is_bf16) {
    const size_t smem = sizeof(bf16) * 2 * DW_BT * (DW_LDA + DW_LDB);
    auto kern = grouped_dw_kernel_mma;
    dim3 grid(E * ((K + DW_BM - 1) / DW_BM), (N + DW_BN - 1) / DW_BN);
    kern<<<grid, DW_THREADS, smem, st>>>(
        static_cast<const bf16*>(xs), static_cast<const bf16*>(dy), off,
        static_cast<bf16*>(dw), T, K, N);
  } else {
    const size_t smem = sizeof(float) * FDT * (FBM + FBN);
    auto kern = grouped_dw_kernel;
    dim3 grid(E * ((K + FBM - 1) / FBM), (N + FBN - 1) / FBN);
    kern<<<grid, F_THREADS, smem, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(dy), off,
        static_cast<float*>(dw), T, K, N);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
