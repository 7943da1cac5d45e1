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
// gives each element of dW[e] to one CTA, which walks the group's rows
// in one fixed order with no atomics and no split over rows, so the
// summation order depends on the shapes and offsets only and a call is
// reproducible bit for bit (graph replay = eager).
//
// Bound on an H100: at the MoE prefill's gate product (T = 8192, K =
// 1024, N = 2048, E = 8, bf16) the work is 34 GFLOP against ~84 MB of
// inputs and outputs, so the tensor-core rate bounds it (989 TFLOP/s,
// ~35 us), not HBM (~25 us); G2 at that shape likewise.  What keeps a
// bf16 kernel from that rate is feeding the tensor cores (wgmma fed by a
// TMA ring, one persistent CTA an SM, so no SM idles on an empty group)
// and emptying a tile (G2's epilogue, below).  In f32 the
// bound is the FMA rate outside the tensor cores (67 TFLOP/s, ~0.51 ms):
// the f32 contract (one sequential fmaf chain an output) rules out TF32,
// and what keeps an FFMA kernel from that rate is feeding it from shared
// memory (16-byte loads, many FMAs a load) and landing the next tiles
// while these are multiplied.
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
// * G1 f32 (`grouped_mm_kernel<TRANS_W>`): register-tiled FMAs.  128
//   threads on a 64 x 128 tile, 8 x 8 outputs a thread, at most 128
//   registers so that four CTAs share an SM; per 8-deep k-step a thread
//   reads 8 values of A and 8 of B as four 16-byte shared loads for 64
//   FMAs.  Two shared stages, filled by 16-byte global loads staged in
//   registers while the other stage is multiplied (one __syncthreads a
//   step); A is stored k-major (transposed on the way in), and so is
//   W[e]^T in dx mode, whose rows are Kd-contiguous.  Each output is one
//   sequential fmaf chain over k from 0 up, starting at 0.0 (no split-K,
//   no tree, no TF32), as the scalar kernel it replaced summed, so its
//   bits are that kernel's.  Grid ceil(T / 64) + E row tiles (each group
//   starts its own tiles) by ceil(N / 128), a CTA walking the offsets to
//   find its tile.  (128 x 128 tiles of 256 threads, two CTAs an SM,
//   ran slower on the card at the MoE shapes.)
// * G2 bf16 (`grouped_dw_kernel_wgmma`): G1's machinery with the
//   reduction over token rows, dW[e] (K x N) = xs_e^T dy_e.  Both
//   operands are MN-major (xs's K and dy's N are contiguous): wgmma reads
//   A = xs_e^T with imm-trans-a set.  A stage is 64 token rows: each
//   consumer warpgroup's A is one TMA box of 64 K-columns x 64 rows, B
//   two boxes of 64 N-columns, each token row one 128-byte line.  A
//   group's boxes start at its first row, so only its last box can hold
//   rows of the next group (TMA zero-fills only past T): the consumer
//   zeroes those lines of its A box in shared memory, whole lines (the
//   swizzle moves 16-byte chunks within a line), fences them to the
//   async proxy and meets its warpgroup at a named barrier before the
//   products read them.  Persistent, one CTA an SM, over the units
//   (expert, 128-row tile of K, 128-column tile of N) numbered from the
//   shapes; a unit's length comes from the device offsets, so one grid
//   serves every routing.  An empty group's tiles are written as zeros
//   with no loads.  The epilogue goes through shared memory (a swizzled
//   bf16 tile a warpgroup) and leaves as 16-byte stores along dW's rows,
//   where stores straight from the accumulator fragment would write 4
//   bytes to each of 8 rows an instruction.  No split over rows: at the
//   main path's shapes an expert has 128 output tiles, so even one live
//   expert fills 128 of 132 SMs.
// * G2 f32 (`grouped_dw_kernel`): register-tiled FMAs fed by cp.async.
//   Both operands lie along the output's axes (xs rows along K, dy rows
//   along N), so 16-byte cp.async copies land token-major stages [rows]
//   [128] of each with no transpose, zeros at or past the group's end, in
//   three stages of 16 token rows.  256 threads on a 128 x 128 tile of
//   dW[e], 8 x 8 outputs a thread: per token row four 16-byte shared
//   loads, 64 FMAs; 127 registers, two CTAs an SM.  (G1's 64 x 128 tile
//   of 128 threads at four CTAs an SM spilled at 128 registers and ran
//   0.95 ms against 0.82 at the gate shape; 32 rows a stage spilled;
//   8 rows in four stages, or two stages, ran no faster.)  Each output
//   is one sequential fmaf chain over the group's rows in order from
//   0.0, no split over rows (so every row on one expert leaves the grid
//   K / 128 x N / 128 live tiles), no atomics, no TF32: the scalar
//   kernel's bits, which it replaced.  The grid comes from the shapes,
//   the offsets from device memory; an empty group's tiles are zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

using hvd_mma::cp_async16;
using hvd_mma::cp_async_commit;
using hvd_mma::cp_async_wait;
using hvd_wgmma::encode;
using hvd_wgmma::sm_count;
typedef __nv_bfloat16 bf16;

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
        wgmma_ss<128, 0, B_MN_MAJOR>(acc, da, db, kb > 0 || kk > 0);
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

// --- G1 f32: register-tiled FMAs ---------------------------------------------

constexpr int FM_BM = 64, FM_BN = 128, FM_BK = 8;
constexpr int FM_THREADS = 2 * FM_BM;  // FM_BM / 8 x 16, 8 x 8 outputs each
constexpr int FM_LDA = FM_BM + 4;      // floats a k-row of a stage (padded)
constexpr int FM_LDB = FM_BN + 4;
constexpr int FM_STAGE = FM_BK * (FM_LDA + FM_LDB);
constexpr int FM_B_LOADS = FM_BK * FM_BN / 4 / FM_THREADS;  // float4 a thread

// G1 f32.  TRANS_W 0: B(k, n) = W[e][k][n] (Kd x Nd); 1: B(k, n) =
// W[e][n][k] (dx: W[e] is Nd x Kd).  Kd and Nd are multiples of 8, so a
// k-step never runs past Kd and a 16-byte load never straddles Nd.
template <int TRANS_W>
__global__ void __launch_bounds__(FM_THREADS, 65536 / 128 / FM_THREADS)
    grouped_mm_kernel(const float* __restrict__ xs,
                      const float* __restrict__ w,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int T, int Kd, int Nd, int E) {
  int e, row0, row_end;
  if (!find_tile(offsets, E, T, FM_BM, blockIdx.x, e, row0, row_end)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Two stages of A [FM_BK][FM_LDA] and B [FM_BK][FM_LDB], both k-major.
  float* stages = reinterpret_cast<float*>(smem_raw);
  const float* we = w + (size_t)e * Kd * Nd;
  const int n0 = blockIdx.y * FM_BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // A (and B in dx mode): a thread copies 4 k of one row (of xs; of W[e]
  // (Nd x Kd)) and stores them down a column of the k-major stage.  B in
  // the forward: 4 columns of one k-row of W[e] (Kd x Nd).
  const int tr = tid / 2, tk = (tid % 2) * 4;
  const bool a_ok = row0 + tr < row_end;
  const float* a_src = xs + (size_t)(a_ok ? row0 + tr : 0) * Kd + tk;
  int bk[FM_B_LOADS], bn[FM_B_LOADS];
  const float* b_src[FM_B_LOADS];
#pragma unroll
  for (int j = 0; j < FM_B_LOADS; ++j) {
    const int q = tid + j * FM_THREADS;
    bk[j] = TRANS_W ? (q % 2) * 4 : q / (FM_BN / 4);
    bn[j] = TRANS_W ? q / 2 : (q % (FM_BN / 4)) * 4;
    const int n = n0 + bn[j] < Nd ? n0 + bn[j] : -1;
    b_src[j] = n < 0 ? nullptr
               : we + (TRANS_W ? (size_t)n * Kd + bk[j]
                               : (size_t)bk[j] * Nd + n);
  }
  const float4 zero4 = {0.f, 0.f, 0.f, 0.f};
  float4 ra, rb[FM_B_LOADS];
  auto fetch = [&](int k0) {
    ra = a_ok ? *reinterpret_cast<const float4*>(a_src + k0) : zero4;
#pragma unroll
    for (int j = 0; j < FM_B_LOADS; ++j)
      rb[j] = b_src[j] == nullptr
                  ? zero4
                  : *reinterpret_cast<const float4*>(
                        b_src[j] + (TRANS_W ? (size_t)k0 : (size_t)k0 * Nd));
  };
  auto stash = [&](int s) {
    float* a = stages + s * FM_STAGE;
    float* b = a + FM_BK * FM_LDA;
    a[(tk + 0) * FM_LDA + tr] = ra.x;
    a[(tk + 1) * FM_LDA + tr] = ra.y;
    a[(tk + 2) * FM_LDA + tr] = ra.z;
    a[(tk + 3) * FM_LDA + tr] = ra.w;
#pragma unroll
    for (int j = 0; j < FM_B_LOADS; ++j) {
      if (TRANS_W) {
        b[(bk[j] + 0) * FM_LDB + bn[j]] = rb[j].x;
        b[(bk[j] + 1) * FM_LDB + bn[j]] = rb[j].y;
        b[(bk[j] + 2) * FM_LDB + bn[j]] = rb[j].z;
        b[(bk[j] + 3) * FM_LDB + bn[j]] = rb[j].w;
      } else {
        *reinterpret_cast<float4*>(b + bk[j] * FM_LDB + bn[j]) = rb[j];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Two stages: the next step's tiles travel through registers while
  // this one's are multiplied; one barrier a step.
  const int nk = Kd / FM_BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * FM_BK);
    const float* a = stages + s * FM_STAGE;
    const float* b = a + FM_BK * FM_LDA;
#pragma unroll
    for (int kk = 0; kk < FM_BK; ++kk) {
      // Rows 4 ty.. and FM_BM / 2 + 4 ty.., columns 4 tx.. and 64 + 4 tx..
      const float4 a0 =
          *reinterpret_cast<const float4*>(a + kk * FM_LDA + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(
          a + kk * FM_LDA + FM_BM / 2 + 4 * ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(b + kk * FM_LDB + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + kk * FM_LDB + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(s ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : FM_BM / 2 + 4 * ty + i - 4);
    if (row >= row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      if (col < Nd) {
        const float4 v = {acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]};
        *reinterpret_cast<float4*>(out + (size_t)row * Nd + col) = v;
      }
    }
  }
}

// --- G2 bf16: wgmma + TMA -----------------------------------------------------

// G2's shared memory: G1's ring and tables, then the output tile (bf16,
// WG_BM x WG_BN) on its way to global memory.
constexpr int DW_C_BYTES = WG_BM * WG_BN * 2;
constexpr int DW_SMEM = WG_SMEM + DW_C_BYTES;

// dW[e] = xs_e^T dy_e over units (expert, 128-row tile of K, 128-column
// tile of N), one CTA an SM walking them with a stride of the grid.  The
// reduction runs over the group's token rows, WG_BK a stage: A = xs_e^T
// and B = dy_e, both MN-major.
__global__ void __launch_bounds__(WG_THREADS, 1) grouped_dw_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_x,
    __grid_constant__ const CUtensorMap tm_dy,
    const int* __restrict__ offsets, bf16* __restrict__ dw, int T, int K,
    int N, int E) {
  using namespace hvd_wgmma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* sA = reinterpret_cast<bf16*>(base);
  bf16* sB = reinterpret_cast<bf16*>(base + WG_STAGES * WG_A_BYTES);
  bf16* sC = reinterpret_cast<bf16*>(base + WG_STAGES * (WG_A_BYTES +
                                                          WG_B_BYTES));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + WG_STAGES * (WG_A_BYTES + WG_B_BYTES) + DW_C_BYTES);
  uint64_t* empty = full + WG_STAGES;
  int* lo = reinterpret_cast<int*>(empty + WG_STAGES);  // clamped offsets

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    fence_mbar_init();
    int l = min(max(offsets[0], 0), T);
    lo[0] = l;
    for (int e = 0; e < E; ++e) {
      l = min(max(offsets[e + 1], l), T);
      lo[e + 1] = l;
    }
  }
  __syncthreads();
  const int n_col = (N + WG_BN - 1) / WG_BN;
  const int per_e = (K + WG_BM - 1) / WG_BM * n_col;
  const int n_units = E * per_e;

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int e = u / per_e;
      const int m0 = (u % per_e) / n_col * WG_BM, n0 = (u % n_col) * WG_BN;
      const int nt = (lo[e + 1] - lo[e] + WG_BK - 1) / WG_BK;
      for (int kb = 0; kb < nt; ++kb) {
        const int t0 = lo[e] + kb * WG_BK;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], WG_A_BYTES + WG_B_BYTES);
        bf16* a = sA + stage * (WG_BM * WG_BK);
        bf16* b = sB + stage * (WG_BK * WG_BN);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tma_load_2d(a + j * 64 * WG_BK, &tm_x, m0 + 64 * j, t0,
                      &full[stage]);
          tma_load_2d(b + j * 64 * WG_BK, &tm_dy, n0 + 64 * j, t0,
                      &full[stage]);
        }
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumer warpgroups: rows [64 half, 64 half + 64) of each dW tile.
  setmaxnreg_inc<232>();
  const int half = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  float acc[WG_BN / 2];
  int stage = 0, phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int e = u / per_e;
    const int m0 = (u % per_e) / n_col * WG_BM, n0 = (u % n_col) * WG_BN;
    const int nt = (lo[e + 1] - lo[e] + WG_BK - 1) / WG_BK;
    int prev = 0;
    for (int kb = 0; kb < nt; ++kb) {
      mbar_wait(&full[stage], phase);
      bf16* a = sA + stage * (WG_BM * WG_BK) + half * 64 * WG_BK;
      const bf16* b = sB + stage * (WG_BK * WG_BN);
      // The group's last box may run into the next group's rows: zero
      // this warpgroup's A lines from the group's end on.
      const int rows = lo[e + 1] - (lo[e] + kb * WG_BK);
      if (rows < WG_BK) {
        uint4* line = reinterpret_cast<uint4*>(a);  // 8 chunks a row
        const uint4 z = {0u, 0u, 0u, 0u};
        for (int i = rows * 8 + threadIdx.x % 128; i < WG_BK * 8; i += 128)
          line[i] = z;
        fence_proxy_async();
        named_barrier_sync(1 + half, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = make_desc(a + kk * 16 * 64, 64 * WG_BK * 2, 1024);
        const uint64_t db = make_desc(b + kk * 16 * 64, 64 * WG_BK * 2, 1024);
        wgmma_ss<128, 1, 1>(acc, da, db, kb > 0 || kk > 0);
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
    if (nt > 0) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
    } else {  // an empty group: zeros, no loads
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < WG_BN / 2; ++i) fence_operand(acc[i]);

    // The epilogue through shared memory: the fragment's 4-byte pieces
    // land in this warpgroup's 64 x 128 bf16 tile (rows of 16 16-byte
    // chunks, chunk c of row r at c ^ (r % 8): no bank conflict either
    // way), then leave as whole 16-byte chunks along dW's rows.
    bf16* ct = sC + half * 64 * WG_BN;
    named_barrier_sync(1 + half, 128);  // the last tile's reads are done
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            ct + r * WG_BN + 8 * (i ^ (r & 7)) + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    named_barrier_sync(1 + half, 128);
    bf16* out = dw + (size_t)e * K * N;
#pragma unroll
    for (int j = threadIdx.x % 128; j < 64 * (WG_BN / 8); j += 128) {
      const int r = j / (WG_BN / 8), c = j % (WG_BN / 8);
      const int row = m0 + half * 64 + r, col = n0 + 8 * c;
      if (row < K && col < N)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
            *reinterpret_cast<const uint4*>(ct + r * WG_BN + 8 * (c ^ (r & 7)));
    }
  }
}

// --- G2 f32: register-tiled FMAs fed by cp.async ------------------------------

// This CTA's group's rows [lo, hi), clamped to [0, T].
__device__ __forceinline__ void group_rows(const int* __restrict__ offsets,
                                           int e, int T, int& lo, int& hi) {
  lo = min(max(offsets[e], 0), T);
  hi = min(max(offsets[e + 1], lo), T);
}

constexpr int DW_F_BM = 128, DW_F_BN = 128;  // a dW tile: K rows x N columns
constexpr int DW_F_TX = DW_F_BN / 8;         // threads along N
constexpr int DW_F_THREADS = DW_F_BM / 8 * DW_F_TX;  // 8 x 8 outputs each
constexpr int DW_F_ROWS = 16;                // token rows a stage
constexpr int DW_F_STAGES = 3;
constexpr int DW_F_STAGE = DW_F_ROWS * (DW_F_BM + DW_F_BN);  // floats
constexpr int DW_F_COPIES = DW_F_STAGE / 4 / DW_F_THREADS;  // 16 B a thread
constexpr int DW_F_SMEM = 4 * DW_F_STAGES * DW_F_STAGE;
static_assert(DW_F_ROWS * DW_F_BM / 4 % DW_F_THREADS == 0,
              "a copy step lands xs or dy, never both");

// G2 f32: dW[e][k0.., n0..] for one (expert, K tile, N tile).  A stage is
// DW_F_ROWS token rows of xs [rows][DW_F_BM] and of dy [rows][DW_F_BN],
// landed as they lie in memory (16-byte cp.async along K and N), zeros at
// or past the group's end and past K or N.  Thread (ty, tx) keeps rows 4
// ty.. and DW_F_BM / 2 + 4 ty.. of the tile and columns 4 tx.. and
// DW_F_BN / 2 + 4 tx..: per token row four 16-byte shared loads, 64
// FMAs.  Each output is one fmaf chain over the group's rows in order
// from 0.0 (a zero row adds nothing), as the scalar kernel it replaced
// summed: its bits, but for the sign of a zero (the card gave every bit
// of the scalar kernel's at the gate shape, zeros' signs too).
__global__ void __launch_bounds__(DW_F_THREADS, 65536 / 128 / DW_F_THREADS)
    grouped_dw_kernel(const float* __restrict__ xs,
                      const float* __restrict__ dy,
                      const int* __restrict__ offsets, float* __restrict__ dw,
                      int T, int K, int N) {
  const int k_tiles = (K + DW_F_BM - 1) / DW_F_BM;
  const int e = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * DW_F_BM, n0 = blockIdx.y * DW_F_BN;
  int lo, hi;
  group_rows(offsets, e, T, lo, hi);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, tx = tid % DW_F_TX, ty = tid / DW_F_TX;

  // Stage s <- token rows [t0, t0 + DW_F_ROWS): copy q of a thread is
  // xs's 16-byte chunk q, or past them dy's.
  auto load = [&](int t0, int s) {
    float* a = stages + s * DW_F_STAGE;
    float* b = a + DW_F_ROWS * DW_F_BM;
#pragma unroll
    for (int j = 0; j < DW_F_COPIES; ++j) {
      const int q = tid + j * DW_F_THREADS;
      if (q < DW_F_ROWS * DW_F_BM / 4) {
        const int r = q / (DW_F_BM / 4), c = q % (DW_F_BM / 4) * 4;
        const bool ok = t0 + r < hi && k0 + c < K;
        cp_async16(a + r * DW_F_BM + c,
                   ok ? xs + (size_t)(t0 + r) * K + k0 + c : xs, ok ? 16 : 0);
      } else {
        const int qb = q - DW_F_ROWS * DW_F_BM / 4;
        const int r = qb / (DW_F_BN / 4), c = qb % (DW_F_BN / 4) * 4;
        const bool ok = t0 + r < hi && n0 + c < N;
        cp_async16(b + r * DW_F_BN + c,
                   ok ? dy + (size_t)(t0 + r) * N + n0 + c : dy, ok ? 16 : 0);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // DW_F_STAGES - 1 steps in flight ahead; each step waits for its own
  // stage, then refills the one the step before read.
  const int steps = (hi - lo + DW_F_ROWS - 1) / DW_F_ROWS;
#pragma unroll
  for (int s = 0; s < DW_F_STAGES - 1; ++s) {
    if (s < steps) load(lo + s * DW_F_ROWS, s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<DW_F_STAGES - 2>();
    __syncthreads();
    const int nx = it + DW_F_STAGES - 1;
    if (nx < steps) load(lo + nx * DW_F_ROWS, nx % DW_F_STAGES);
    cp_async_commit();
    const float* a = stages + (it % DW_F_STAGES) * DW_F_STAGE;
    const float* b = a + DW_F_ROWS * DW_F_BM;
#pragma unroll
    for (int r = 0; r < DW_F_ROWS; ++r) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(a + r * DW_F_BM + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(
          a + r * DW_F_BM + DW_F_BM / 2 + 4 * ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(b + r * DW_F_BN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(
          b + r * DW_F_BN + DW_F_BN / 2 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  float* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + (i < 4 ? 4 * ty + i : DW_F_BM / 2 + 4 * ty + i - 4);
    if (row >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + DW_F_BN / 2 * h + 4 * tx;
      if (col < N) {
        const float4 v = {acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]};
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) = v;
      }
    }
  }
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
  int sms = 0;
  cudaError_t err = sm_count(sms);
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

int launch_dw_wgmma(const bf16* xs, const bf16* dy, const int* off,
                    bf16* dw, int T, int K, int N, int E, cudaStream_t st) {
  // xs (T, K) and dy (T, N), innermost first, in boxes of 64 columns x
  // WG_BK token rows.
  CUtensorMap tm_x, tm_dy;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t dy_dims[2] = {(cuuint64_t)N, (cuuint64_t)T};
  const cuuint64_t dy_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, WG_BK};
  if (!encode(&tm_x, xs, 2, x_dims, x_strides, box) ||
      !encode(&tm_dy, dy, 2, dy_dims, dy_strides, box))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const int units =
      E * ((K + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  const dim3 grid(sms < units ? sms : units);
  err = cudaFuncSetAttribute(grouped_dw_kernel_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  grouped_dw_kernel_wgmma<<<grid, WG_THREADS, DW_SMEM, st>>>(
      tm_x, tm_dy, off, dw, T, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// G1.  W is (E, K, N).  transpose_w 0: out (T, N) = a (T, K) @ W[group];
// 1: out (T, K) = a (T, N) @ W[group]^T.  Groups by `offsets` (E + 1 int32
// on the device).  bf16 runs the wgmma kernel, f32 the register-tiled
// one.
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
  const size_t smem = sizeof(float) * 2 * FM_STAGE;
  auto kern = transpose_w ? grouped_mm_kernel<1> : grouped_mm_kernel<0>;
  dim3 grid((T + FM_BM - 1) / FM_BM + E, (Nd + FM_BN - 1) / FM_BN);
  kern<<<grid, FM_THREADS, smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), off,
      static_cast<float*>(out), T, Kd, Nd, E);
  return (int)cudaGetLastError();
}

// G2: dw (E, K, N), dw[e] = xs[rows of e]^T @ dy[rows of e], xs (T, K), dy
// (T, N), groups by `offsets` (E + 1 int32 on the device).  Every element
// of dw is written (an empty group's as zeros).  bf16 runs the wgmma
// kernel, f32 the scalar one; a tensor map the driver refuses is
// cudaErrorInvalidValue, as in G1.
extern "C" int grouped_matmul_dw(const void* xs, const void* dy,
                                 const void* offsets, void* dw, int T, int K,
                                 int N, int E, int is_bf16, void* stream) {
  if (T < 1 || E < 1 || E > MAX_GROUPS || K < 8 || N < 8 || K % 8 ||
      N % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (is_bf16)
    return launch_dw_wgmma(static_cast<const bf16*>(xs),
                           static_cast<const bf16*>(dy), off,
                           static_cast<bf16*>(dw), T, K, N, E, st);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DW_F_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(E * ((K + DW_F_BM - 1) / DW_F_BM), (N + DW_F_BN - 1) / DW_F_BN);
  grouped_dw_kernel<<<grid, DW_F_THREADS, DW_F_SMEM, st>>>(
      static_cast<const float*>(xs), static_cast<const float*>(dy), off,
      static_cast<float*>(dw), T, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
