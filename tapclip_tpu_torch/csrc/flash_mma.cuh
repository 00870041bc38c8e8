// Warp-level tensor-core tiles of the flash attention kernels: K3
// (attn_aux.cu) and the backward chain (flash_bwd.cu: LSE, dK/dV, dQ).
//
// Products run as mma.sync.aligned.m16n8k16 with bf16 operands and f32
// accumulation (FlashAttention-2 style; wgmma is later work).  A warp owns
// 16 rows of a 64-row tile, so row max and row sum are shuffles among the
// four lanes of a quad.  Operand tiles sit in shared memory row-major with a
// padded row stride (tile_ld: Dh + 8 bf16 or Dh + 4 f32 elements), which
// keeps the fragment loads free of bank conflicts and every row 16-byte
// aligned for the 16-byte cp.async copies that fill it (load_tile).  A
// score accumulator becomes the A operand of the next product in registers
// (acc_to_a): the m16n8 C fragment of two neighbouring 8-column tiles is the
// m16n8k16 A fragment of their 16 columns.
//
// Precision: the function of the JAX kernels does not change.
//   * bf16 operands are exact: a product of two bf16 values is exact in f32,
//     so one bf16 MMA per product changes only the order of the f32 sums.
//     bf16 tiles reach the MMAs by ldmatrix (.trans where the product reads
//     the tile along its rows).
//   * An f32 operand is split into kF32Terms bf16 terms, x = x0 + x1 + x2
//     (x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1); the residual
//     is below 2^-24 |x|), and the product sums the partial products of the
//     term pairs (i, j) with i + j < max(terms): six MMAs when both operands
//     are f32.  The error reading, emulated in torch at the card tests'
//     flash shapes (python -m tapclip_tpu_torch.scripts.split_error
//     --terms N, against the plain f32 versions): three terms read at most
//     1.4e-6 absolute on the LSE, 6.3e-7 norm-relative on the gradients and
//     5.1e-7 on K3's output; two terms (three MMAs) 1.4e-5, 9.4e-6 and
//     6.7e-6, against the limits of 1e-5, 1e-5 and 1e-5: so three.  f32
//     tiles reach the MMAs by 64-bit (32-bit along the rows) shared loads
//     and are split in registers.
//   * f32 values that meet a bf16 operand (p and ds in the bf16 backward)
//     split into kAccTerms = 2 terms: 2^-16 relative, far below the bf16
//     rounding of the results.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace tapclip {
namespace mma {

constexpr int kTile = 64;  // keys of a K3 key tile; rows and keys of the chain's tiles
constexpr int kF32Terms = 3;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;
// bf16 terms of an operand held in shared memory in T.
template <typename T>
constexpr int kTerms = kIsF32<T> ? kF32Terms : 1;
// bf16 terms of an f32 accumulator used as an operand beside T operands.
template <typename T>
constexpr int kAccTerms = kIsF32<T> ? kF32Terms : 2;

// Row stride, in elements, of a staged [rows, DH] tile of T.
template <typename T, int DH>
__host__ __device__ constexpr int tile_ld() {
  return DH + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- cp.async ------------------------------------------------------------------

// 16 bytes global -> shared; zeros when !in (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// X_s[r][0, DH) = row t0 + r of the operand whose row t sits at x + t * st,
// for r < ROWS (zeros past T), by 16-byte cp.async issued by NTHREADS
// threads (not committed).  x and st * sizeof(T) must be 16-byte aligned.
template <typename T, int DH, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* X_s, const T* __restrict__ x, int st, int t0, int T_) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements of a chunk
  constexpr int kChunks = DH / kPer;                      // chunks of a row
  constexpr int kLd = tile_ld<T, DH>();
#pragma unroll 4
  for (int i = 0; i < (ROWS * kChunks + NTHREADS - 1) / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    if (ROWS * kChunks % NTHREADS != 0 && c >= ROWS * kChunks) break;
    const int r = c / kChunks, e = (c % kChunks) * kPer;
    const bool in = t0 + r < T_;
    cp_async16(X_s + r * kLd + e, x + (in ? static_cast<size_t>(t0 + r) * st + e : 0), in);
  }
}

// --- fragments -------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split (x0, x1), two neighbouring k of one row or column, into NT bf16x2
// terms: a[i][reg] holds the i-th.
template <int NT, int R>
__device__ __forceinline__ void split_into(float x0, float x1, uint32_t (&a)[NT][R], int reg) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const uint32_t u = pack_bf16(x0, x1);
    a[i][reg] = u;
    if (i + 1 < NT) {
      x0 -= __uint_as_float(u << 16);  // exact: x minus its bf16 rounding
      x1 -= __uint_as_float(u & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b, one m16n8k16 bf16 MMA with f32 accumulation.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b over split operands: the term pairs (i, j) with
// i + j < max(NA, NB), the smallest partial products first.  When b is split
// too (f32) the partial products of one 16-deep step are summed from 0 and
// added to c by an f32 add: the MMA's own accumulation rounds toward zero,
// and over a long sum (dk over 2,100 queries, f32) that bias read 1.7e-5
// norm-relative against the 1e-5 limit; a rounded add per step keeps it from
// growing with the depth.  Against a bf16 b (one term) the bias stays far
// below the bf16 rounding of the results, and the MMAs accumulate into c.
template <int NA, int NB>
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
  constexpr int kN = NA > NB ? NA : NB;
  if constexpr (NB == 1) {
#pragma unroll
    for (int i = NA - 1; i >= 0; --i) mma16816(c, a[i], b[0]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = kN - 1; s >= 0; --s)
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (s - i >= 0 && s - i < NB) mma16816(t, a[i], b[s - i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
  }
}

// A operand: the 16 x 16 block X[r0, r0 + 16) x [k0, k0 + 16) of a staged tile.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[1][4], const __nv_bfloat16* X, int r0, int k0) {
  constexpr int kLd = tile_ld<__nv_bfloat16, DH>();
  const int l = threadIdx.x & 31;
  ldsm_x4(a[0], X + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * kLd + k0 + (l >> 4) * 8);
}

template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[kF32Terms][4], const float* X, int r0, int k0) {
  constexpr int kLd = tile_ld<float, DH>();
  const int l = threadIdx.x & 31;
  const float* p = X + (r0 + (l >> 2)) * kLd + k0 + 2 * (l & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kLd);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kLd + 8);
  split_into(v0.x, v0.y, a, 0);
  split_into(v1.x, v1.y, a, 1);
  split_into(v2.x, v2.y, a, 2);
  split_into(v3.x, v3.y, a, 3);
}

// B operands of the n-tiles [n0, n0 + 8) (b0) and [n0 + 8, n0 + 16) (b1) over
// k in [k0, k0 + 16), where B[k][n] = X[n][k]: the tile's rows are the
// product's columns (the B of A X^T).
template <int DH>
__device__ __forceinline__ void load_b(uint32_t (&b0)[1][2], uint32_t (&b1)[1][2],
                                       const __nv_bfloat16* X, int n0, int k0) {
  constexpr int kLd = tile_ld<__nv_bfloat16, DH>();
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, X + (n0 + (l & 7) + ((l >> 4) & 1) * 8) * kLd + k0 + ((l >> 3) & 1) * 8);
  b0[0][0] = r[0];
  b0[0][1] = r[1];
  b1[0][0] = r[2];
  b1[0][1] = r[3];
}

template <int DH>
__device__ __forceinline__ void load_b(uint32_t (&b0)[kF32Terms][2], uint32_t (&b1)[kF32Terms][2],
                                       const float* X, int n0, int k0) {
  constexpr int kLd = tile_ld<float, DH>();
  const int l = threadIdx.x & 31;
  const float* p = X + (n0 + (l >> 2)) * kLd + k0 + 2 * (l & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8 * kLd);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kLd + 8);
  split_into(v0.x, v0.y, b0, 0);
  split_into(v1.x, v1.y, b0, 1);
  split_into(v2.x, v2.y, b1, 0);
  split_into(v3.x, v3.y, b1, 1);
}

// B operands as load_b, where B[k][n] = X[k][n]: the tile's rows are the
// product's depth (the B of A X).
template <int DH>
__device__ __forceinline__ void load_bt(uint32_t (&b0)[1][2], uint32_t (&b1)[1][2],
                                        const __nv_bfloat16* X, int k0, int n0) {
  constexpr int kLd = tile_ld<__nv_bfloat16, DH>();
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4_trans(r, X + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * kLd + n0 + ((l >> 4) & 1) * 8);
  b0[0][0] = r[0];
  b0[0][1] = r[1];
  b1[0][0] = r[2];
  b1[0][1] = r[3];
}

// From an f32 tile in NT terms: NT = 1 where the tile holds values of bf16
// (K2's v in bf16, stored in its f32 workspace), so the one term is exact.
template <int DH, int NT>
__device__ __forceinline__ void load_bt(uint32_t (&b0)[NT][2], uint32_t (&b1)[NT][2],
                                        const float* X, int k0, int n0) {
  constexpr int kLd = tile_ld<float, DH>();
  const int l = threadIdx.x & 31;
  const float* p = X + (k0 + 2 * (l & 3)) * kLd + n0 + (l >> 2);
  split_into(p[0], p[kLd], b0, 0);
  split_into(p[8 * kLd], p[9 * kLd], b0, 1);
  split_into(p[8], p[kLd + 8], b1, 0);
  split_into(p[8 * kLd + 8], p[9 * kLd + 8], b1, 1);
}

// The A operand, in NT terms, of the 16 columns held by two neighbouring
// 8-column accumulator tiles c0, c1 of a warp.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NT][4], const float (&c0)[4], const float (&c1)[4]) {
  split_into(c0[0], c0[1], a, 0);
  split_into(c0[2], c0[3], a, 1);
  split_into(c1[0], c1[1], a, 2);
  split_into(c1[2], c1[3], a, 3);
}

// --- warp products -----------------------------------------------------------------

// s = A_s[r0, r0 + 16) . B_s[c0, c0 + NCOL)^T over DH: a warp's [16, NCOL]
// block of A B^T for two staged [*, DH] tiles.
template <typename T, int DH, int NCOL>
__device__ __forceinline__ void warp_abt(float (&s)[NCOL / 8][4], const T* A_s, int r0, const T* B_s,
                                         int c0) {
  constexpr int NT = kTerms<T>;
#pragma unroll
  for (int n = 0; n < NCOL / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t a[NT][4];
    load_a<DH>(a, A_s, r0, kk);
#pragma unroll
    for (int n = 0; n < NCOL / 8; n += 2) {
      uint32_t b0[NT][2], b1[NT][2];
      load_b<DH>(b0, b1, B_s, c0 + 8 * n, kk);
      mma_split(s[n], a, b0);
      mma_split(s[n + 1], a, b1);
    }
  }
}

// o += P . X_s[k0, k0 + NCOL): P is a warp's [16, NCOL] f32 accumulator, used
// in NTP bf16 terms; X_s a staged [*, DH] tile whose rows are the depth, used
// in NT terms.
template <typename T, int DH, int NCOL, int NTP, int NT = kTerms<T>>
__device__ __forceinline__ void warp_pv(float (&o)[DH / 8][4], const float (&p)[NCOL / 8][4],
                                        const T* X_s, int k0) {
#pragma unroll
  for (int kk = 0; kk < NCOL / 8; kk += 2) {
    uint32_t a[NTP][4];
    acc_to_a(a, p[kk], p[kk + 1]);
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t b0[NT][2], b1[NT][2];
      load_bt<DH>(b0, b1, X_s, k0 + 8 * kk, 8 * n);
      mma_split(o[n], a, b0);
      mma_split(o[n + 1], a, b1);
    }
  }
}

// Zero a warp's accumulator tiles.
template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// --- products over bf16 term planes ------------------------------------------------
//
// An f32 operand split once into NT bf16 planes in shared memory (plane i,
// the i-th term of every element, at X + i * plane: split_rows), read by
// ldmatrix as bf16 tiles: the same terms, fragments and MMAs as warp_abt and
// warp_pv on the f32 tile, which split in registers at every read.

// X_s[i * plane + r * ld + e] = the i-th bf16 term of row t0 + r, column e of
// the f32 operand whose row t sits at x + t * st (zeros past T), for r < ROWS
// and i < NT, by 16-byte loads issued by NTHREADS threads.  x and
// st * sizeof(float) 16-byte aligned; ld = tile_ld<bf16, DH>.
template <int DH, int ROWS, int NT, int NTHREADS>
__device__ __forceinline__ void split_rows(__nv_bfloat16* X_s, int plane, const float* __restrict__ x, int st,
                                           int t0, int T_) {
  constexpr int kChunks = DH / 4;  // 16-byte chunks of a row
  constexpr int kLd = tile_ld<__nv_bfloat16, DH>();
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NTHREADS) {
    const int r = c / kChunks, e = (c % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T_) v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(t0 + r) * st + e);
    uint32_t lo[NT][1], hi[NT][1];
    split_into(v.x, v.y, lo, 0);
    split_into(v.z, v.w, hi, 0);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<uint2*>(X_s + i * plane + r * kLd + e) = make_uint2(lo[i][0], hi[i][0]);
  }
}

// s = A[r0, r0 + 16) . B[c0, c0 + NCOL)^T over DH, as warp_abt, from NA
// planes of A (stride plane_a) and NB of B (stride plane_b); only the
// 16-column blocks that start below `live` are computed, the rest stay 0.
template <int DH, int NCOL, int NA, int NB>
__device__ __forceinline__ void warp_abt_planes(float (&s)[NCOL / 8][4], const __nv_bfloat16* A_s, int plane_a,
                                                int r0, const __nv_bfloat16* B_s, int plane_b, int c0,
                                                int live = NCOL) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    uint32_t a[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      uint32_t t[1][4];
      load_a<DH>(t, A_s + i * plane_a, r0, kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][e] = t[0][e];
    }
#pragma unroll
    for (int n = 0; n < NCOL / 8; n += 2) {
      if (8 * n >= live) break;
      uint32_t b0[NB][2], b1[NB][2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint32_t t0[1][2], t1[1][2];
        load_b<DH>(t0, t1, B_s + i * plane_b, c0 + 8 * n, kk);
        b0[i][0] = t0[0][0], b0[i][1] = t0[0][1], b1[i][0] = t1[0][0], b1[i][1] = t1[0][1];
      }
      mma_split(s[n], a, b0);
      mma_split(s[n + 1], a, b1);
    }
  }
}

// o += P . X[k0, k0 + NCOL), as warp_pv, from NT planes of X (stride plane);
// only the 16-row blocks of X that start below `live` (p is 0 past them).
template <int DH, int NCOL, int NTP, int NT>
__device__ __forceinline__ void warp_pv_planes(float (&o)[DH / 8][4], const float (&p)[NCOL / 8][4],
                                               const __nv_bfloat16* X_s, int plane, int k0, int live = NCOL) {
#pragma unroll
  for (int kk = 0; kk < NCOL / 8; kk += 2) {
    if (8 * kk >= live) break;
    uint32_t a[NTP][4];
    acc_to_a(a, p[kk], p[kk + 1]);
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t b0[NT][2], b1[NT][2];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t t0[1][2], t1[1][2];
        load_bt<DH>(t0, t1, X_s + i * plane, k0 + 8 * kk, 8 * n);
        b0[i][0] = t0[0][0], b0[i][1] = t0[0][1], b1[i][0] = t1[0][0], b1[i][1] = t1[0][1];
      }
      mma_split(o[n], a, b0);
      mma_split(o[n + 1], a, b1);
    }
  }
}

// Reductions over the four lanes of a quad (the lanes that share an
// accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a warp's [16, DH] f32 accumulator, times scale[r] on row r0 + g + 8r,
// as T rows of x (row t at x + t * st), rows at or past T_ skipped.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* __restrict__ x, int st, int r0, int T_,
                                           const float (&o)[DH / 8][4], const float (&scale)[2]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (l >> 2) + 8 * r;
    if (row >= T_) continue;
    T* dst = x + static_cast<size_t>(row) * st + 2 * (l & 3);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const float a = o[n][2 * r] * scale[r], b = o[n][2 * r + 1] * scale[r];
      if constexpr (kIsF32<T>) {
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(a, b);
      }
    }
  }
}

}  // namespace mma
}  // namespace tapclip
