// Tensor-core building blocks of the bf16 flash kernels (K1 in
// flash_fwd.cu, K2 in flash_bwd.cu), sm_90a.
//
// * cp.async copies global -> shared (16 bytes a thread for tile rows,
//   4 bytes for f32 row vectors), with zero fill past a ragged edge;
// * ldmatrix loads 8x8 bf16 blocks of a padded shared tile straight into
//   mma.sync fragments, `.trans` where the operand is stored k-major;
// * mma.sync.m16n8k16 bf16 x bf16 -> f32.
//
// Tiles live in shared memory as bf16 rows of D + 8 elements: the row
// stride of D * 2 + 16 bytes shifts each row by four banks, so the eight
// 16-byte rows one ldmatrix phase reads land on 32 different banks.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                      a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8, f32):   c0 c1 (g, 2t..2t+1)  c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n-tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product's k-step: a
// probability tile never leaves registers (`pack_bf16`).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace hvd_mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared.  src_bytes < 16 zero-fills the rest; 0
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (needs only 4-byte alignment).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 blocks; lane i supplies the row address of block i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even, as XLA's convert), the
// first in the low half: one register of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// --- addressing of the padded tiles ------------------------------------------

// This lane's row address for ldsm_x4 of the 16 x 16 block at (r0, c0)
// of a row-major tile with row stride LD, read as an A fragment (or,
// with ldsm_x4_trans, as the B fragments of the two n-tiles c0..c0+15
// of a k-major operand: k = rows r0..r0+15).  Blocks: rows +0/+8 by
// lane bit 3, columns +0/+8 by lane bit 4.
template <int LD>
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int r0,
                                              int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

// This lane's row address for ldsm_x4 of the B fragments of two n-tiles
// (n0..n0+7, n0+8..n0+15) at k-step k0 of an operand stored n-major
// (row n holds k contiguous, as K rows for Q K^T): registers 0, 1 are
// n-tile 0's b0, b1 and registers 2, 3 n-tile 1's.
template <int LD>
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int n0,
                                              int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}

// Rows [r0, r0 + ROWS) of a (n, D) bf16 matrix into a padded tile of row
// stride D + 8, 16 bytes a thread per step; rows past n read as 0.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int r0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok ? 16 : 0);
  }
}

// Entries [r0, r0 + N) of an f32 vector of length n into shared memory,
// 4 bytes a thread; entries past n read as 0.
template <int N>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int r0, int n, int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < N) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok ? 4 : 0);
  }
}

}  // namespace hvd_mma
