// Warp-level int8 tensor-core tiles: mma.sync m16n8k32 with s8 operands and
// exact s32 accumulation, fed by ldmatrix from K-major int8 tiles in shared
// memory, and the block tile walk built on them (gemm_tile).  Used by S6
// (int8_gemm.cu) and B13 (int8_mlp.cu).
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

// --- the block tile of C = A . Bt^T (S6, B13) -------------------------------------
//
// A block of kGemmThreads (8 warps as 2 rows x 4 columns) owns a BM x kBN
// tile of C[M, N] = A[M, K] . Bt[N, Kp]^T (A row major, lda = K; Bt K-major,
// Kp = kp(K), zeros past K) and walks the depth in kBK-byte stages through a
// kStages-deep cp.async ring (16-byte copies of A's rows when A16: K % 16 ==
// 0 and A 16-byte aligned, 4-byte copies otherwise; Bt always 16-byte, rows
// past N and K as zeros); each warp runs mma.sync m16n8k32 s8 over its
// (BM / 2) x 32 sub-tile from ldmatrix fragments.  Every sum runs in one
// block, in k order; the int32 sums are exact.

constexpr int kGemmThreads = 256;
constexpr int kBN = 128;          // C tile columns
constexpr int kBK = 64;           // depth of a stage, bytes
constexpr int kLd = kBK + 16;     // shared row stride, bytes
constexpr int kStages = 3;
constexpr int kNT = kBN / 4 / 8;  // 8-column tiles of a warp

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

// Rows of a block's C tile: 128 where 128-row tiles give every SM two
// blocks, else 64.
inline int tile_m(int M, int N) {
  const long tiles128 = static_cast<long>((M + 127) / 128) * ((N + kBN - 1) / kBN);
  return tiles128 >= 2L * sm_count() ? 128 : 64;
}

// The depth Kp of a K-major operand: K rounded up to a whole stage.
__host__ __device__ constexpr int kp(int K) { return (K + kBK - 1) / kBK * kBK; }

template <int BM>
constexpr size_t gemm_smem() {
  return static_cast<size_t>(kStages) * (BM + kBN) * kLd;
}

// acc = the block's tile (m0, n0) of A . Bt^T; the warp's [BM / 32][kNT]
// m16n8 accumulators.  smem: gemm_smem<BM>() bytes, 16-byte aligned.
template <int BM, bool A16>
__device__ __forceinline__ void gemm_tile(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, int8_t* smem,
                                          int M, int N, int K, int m0, int n0, int (&acc)[BM / 32][kNT][4]) {
  constexpr int WM = BM / 2;
  constexpr int MT = WM / 16;
  static_assert(BM * (kBK / 16) % kGemmThreads == 0 && kBN * (kBK / 16) % kGemmThreads == 0,
                "whole copies a thread");
  int8_t* a_s = smem;                       // [kStages][BM][kLd]
  int8_t* b_s = smem + kStages * BM * kLd;  // [kStages][kBN][kLd]
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int Kp = kp(K);
  const int nk = Kp / kBK;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    int8_t* as = a_s + s * BM * kLd;
    int8_t* bs = b_s + s * kBN * kLd;
    if (A16) {
#pragma unroll
      for (int it = 0; it < BM * (kBK / 16) / kGemmThreads; ++it) {
        const int i = threadIdx.x + it * kGemmThreads;
        const int r = i / (kBK / 16), e = (i % (kBK / 16)) * 16;
        const bool in = m0 + r < M && k0 + e < K;
        mma::cp_async16(as + r * kLd + e, a + (in ? static_cast<size_t>(m0 + r) * K + k0 + e : 0), in);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BM * (kBK / 4) / kGemmThreads; ++it) {
        const int i = threadIdx.x + it * kGemmThreads;
        const int r = i / (kBK / 4), e = (i % (kBK / 4)) * 4;
        const bool in = m0 + r < M && k0 + e < K;
        mma::cp_async4(as + r * kLd + e, a + (in ? static_cast<size_t>(m0 + r) * K + k0 + e : 0), in);
      }
    }
#pragma unroll
    for (int it = 0; it < kBN * (kBK / 16) / kGemmThreads; ++it) {
      const int i = threadIdx.x + it * kGemmThreads;
      const int r = i / (kBK / 16), e = (i % (kBK / 16)) * 16;
      const bool in = n0 + r < N;
      mma::cp_async16(bs + r * kLd + e, bt + (in ? static_cast<size_t>(n0 + r) * Kp + k0 + e : 0), in);
    }
  };

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    mma::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    mma::cp_commit();
    const int8_t* as = a_s + (kt % kStages) * BM * kLd;
    const int8_t* bs = b_s + (kt % kStages) * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a<kLd>(af[i], as, wm * WM + 16 * i, kk);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t b0[2], b1[2];
        load_b<kLd>(b0, b1, bs, wn * (kBN / 4) + 8 * j, kk);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16832(acc[i][j], af[i], b0);
          mma16832(acc[i][j + 1], af[i], b1);
        }
      }
    }
  }
  mma::cp_wait<0>();
}

// Row of C that accumulator tile i, half h (rows g and g + 8 of each 16-row
// tile) holds in this thread, and the first of its two columns in 8-column
// tile j (2t and 2t + 1).
template <int BM>
__device__ __forceinline__ int acc_row(int m0, int i, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return m0 + (warp >> 2) * (BM / 2) + 16 * i + (lane >> 2) + 8 * h;
}

__device__ __forceinline__ int acc_col(int n0, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return n0 + (warp & 3) * (kBN / 4) + 8 * j + 2 * (lane & 3);
}

}  // namespace mma8
}  // namespace tapclip
