// Warp-level int8 tensor-core tiles: mma.sync m16n8k32 with s8 operands and
// exact s32 accumulation, fed by ldmatrix from K-major int8 tiles in shared
// memory.  Used by S6 (int8_gemm.cu); written for B13 and B14 to take up.
//
// The m16n8k32 s8 fragments hold the same bytes, lane for lane, as the
// m16n8k16 bf16 fragments of flash_mma.cuh: a pair of int8 values sits where
// one bf16 value sat.  So ldmatrix (which moves 16-bit elements) loads them
// unchanged from a tile whose rows run along the depth: A [rows, K] as it is
// in memory, B as its transpose [N, K] ("col").  ldmatrix .trans moves 16-bit
// elements and cannot transpose bytes, so a row-major B [K, N] has to be
// transposed to K-major before it is staged (int8_gemm.cu does it with a
// small kernel of its own).
//
// Tiles sit row-major with a row stride of LD bytes; LD = depth + 16 bytes
// (80 for a 64-deep tile) keeps the eight 16-byte rows of each ldmatrix
// phase on distinct banks, and every row 16-byte aligned for cp.async.
#pragma once

#include <stdint.h>

#include "flash_mma.cuh"

namespace tapclip {
namespace mma8 {

// c += a . b, one m16n8k32 int8 MMA; the int32 sum is exact (|a|, |b| <= 128
// and depth below 2^17).
__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A operand: rows [r0, r0 + 16) x bytes [k0, k0 + 32) of a K-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* X, int r0, int k0) {
  const int l = threadIdx.x & 31;
  mma::ldsm_x4(a, X + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * LD + k0 + (l >> 4) * 16);
}

// B operands of the n-tiles [n0, n0 + 8) (b0) and [n0 + 8, n0 + 16) (b1) over
// bytes [k0, k0 + 32) of a K-major tile X [n][k].
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b0)[2], uint32_t (&b1)[2], const int8_t* X, int n0, int k0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  mma::ldsm_x4(r, X + (n0 + (l & 7) + ((l >> 4) & 1) * 8) * LD + k0 + ((l >> 3) & 1) * 16);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

}  // namespace mma8
}  // namespace tapclip
