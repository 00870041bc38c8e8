// Softmax attention of one 64-row query tile against all keys, one 64-key
// tile at a time (online softmax): K2's earlier FMA core (attn_core.cuh),
// the device code of the A/B variants S1, S3 and S4.
//
// The JAX kernels hold a whole [T, T] score tile in VMEM.  A Hopper block has
// at most 227 KB of shared memory, so the CUDA kernels keep one [64, 64]
// score tile and carry the row max m and row sum l from key tile to key tile,
// rescaling the partial output by exp2(m_old - m_new).  Scores, m and l stay
// in the log2 domain: s * (scale * log2 e), then exp2, as in the JAX kernels.
// Keys at or past `valid` take the finite -1e30 of the JAX kernels; key slots
// past T (the ragged last tile) take -inf and contribute exactly 0.  The
// 1/l normalisation is deferred past p.v, and p is rounded to the compute
// dtype before p.v (the JAX kernels' `p.astype(v.dtype)`), while l sums the
// unrounded p.
//
// Block: 256 threads as a 16 x 16 grid.  Thread (rg, cg) owns query rows
// rg + 16 i (i < 4), key columns cg + 16 j (j < 4) of the score tile and
// output columns cg + 16 j (j < DH / 16).  The 16 threads of a row group
// share a half warp, so row reductions are half-warp shuffles.
//
// The A/B variants of the attention half-block (scripts/attn_kernel_ab.py,
// scripts/attn_softmax_ab.py) change the softmax's numerics, through two
// template flags whose defaults are the production form above:
//   FORM kNormalized: exp (not exp2) of s * scale - m, p divided by the row
//     sum BEFORE it is rounded and multiplied by v.  The row sum is unknown
//     until the last key tile, so it takes two passes over the keys: scan()
//     carries m and l online, accumulate() forms p / l and o += p.v.
//   FORM kBf16Exp: p = bf16(exp2(bf16(s - m))) against the row's final max
//     and l sums those bf16 values (softmax_opt="bf16"): scan() finds m,
//     accumulate() forms p, l and o; 1/l after p.v as in production.  exp2
//     of a bf16 value is XLA's: exp(bf16(x * bf16(ln 2))), rounded to bf16.
//   SUM_ROUNDED (sum_mxu): l sums p after p is rounded to the compute dtype.
// merge() joins two online states over disjoint keys (tail_split).
#pragma once

#include "common.cuh"

namespace tapclip {

enum AttnForm { kOnline = 0, kNormalized = 1, kBf16Exp = 2 };

constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16

template <typename T, int DH, int FORM = kOnline, bool SUM_ROUNDED = false>
struct AttnTile {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kRows = 64;       // query rows of a tile
  static constexpr int kKeys = 64;       // keys of a tile
  static constexpr int kLd = DH + 1;     // padded row stride of Q_s, K_s, V_s
  static constexpr int kPld = kKeys + 1; // padded row stride of P_s
  static constexpr int kDj = DH / 16;
  // Floats of shared memory for Q_s, K_s, V_s and P_s.
  static constexpr int kSmemFloats = 3 * kRows * kLd + kRows * kPld;

  float m[4], l[4], o[4][kDj];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] = 0.f;
    }
  }

  // Scores of one key tile: s = q.k * scale, keys past n_keys at -inf, keys at
  // or past valid at -1e30.
  __device__ __forceinline__ void scores(const float* Q_s, const float* K_s, float (&s)[4][4],
                                         int kt0, int n_keys, int valid, float scale, int rg,
                                         int cg) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Q_s[(rg + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = K_s[(cg + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kt0 + cg + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = s[i][j] * scale;
        if (key >= n_keys) v = -INFINITY;
        else if (key >= valid) v = kNegBig;
        s[i][j] = v;
      }
    }
  }

  // o += P_s . V_s over the tile's 64 keys, then a barrier (K_s, V_s and P_s
  // are overwritten by the next tile).
  __device__ __forceinline__ void pv(const float* V_s, const float* P_s, int rg, int cg) {
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      float pvv[4], vv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) pvv[i] = P_s[(rg + 16 * i) * kPld + k];
#pragma unroll
      for (int j = 0; j < kDj; ++j) vv[j] = V_s[k * kLd + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(pvv[i], vv[j], o[i][j]);
    }
    __syncthreads();
  }

  // One key tile starting at key kt0 of n_keys (the online form).  K_s/V_s
  // rows past n_keys must hold zeros.
  __device__ __forceinline__ void step(const float* Q_s, const float* K_s,
                                       const float* V_s, float* P_s, int kt0,
                                       int n_keys, int valid, float scale_log2,
                                       int rg, int cg) {
    static_assert(FORM == kOnline, "step() is the online form; the two-pass forms scan() then accumulate()");
    float s[4][4];
    scores(Q_s, K_s, s, kt0, n_keys, valid, scale_log2, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);  // finite: key kt0 < n_keys is in the tile
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        const float pr = round_to<T>(p);
        rs += SUM_ROUNDED ? pr : p;
        P_s[(rg + 16 * i) * kPld + cg + 16 * j] = pr;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] *= alpha;
    }
    pv(V_s, P_s, rg, cg);
  }

  // Pass 1 of the two-pass forms over one key tile: the row max m, and for
  // kNormalized the row sum l of exp(s - m) carried online.
  __device__ __forceinline__ void scan(const float* Q_s, const float* K_s, int kt0, int n_keys,
                                       int valid, float scale, int rg, int cg) {
    static_assert(FORM != kOnline, "scan() is the first pass of a two-pass form");
    float s[4][4];
    scores(Q_s, K_s, s, kt0, n_keys, valid, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mt = half_warp_max(mt);
      const float m_new = fmaxf(m[i], mt);
      if (FORM == kNormalized) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(rs);
      }
      m[i] = m_new;
    }
    __syncthreads();  // K_s is overwritten by the next tile
  }

  // Pass 2 over one key tile, against the final m (and l): p rounded to T into
  // P_s, o += p.v; kBf16Exp also sums l.
  __device__ __forceinline__ void accumulate(const float* Q_s, const float* K_s,
                                             const float* V_s, float* P_s, int kt0,
                                             int n_keys, int valid, float scale, int rg,
                                             int cg) {
    static_assert(FORM != kOnline, "accumulate() is the second pass of a two-pass form");
    float s[4][4];
    scores(Q_s, K_s, s, kt0, n_keys, valid, scale, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p;
        if (FORM == kNormalized) {
          p = __fdiv_rn(expf(s[i][j] - m[i]), l[i]);
        } else {
          // XLA's exp2 of a bf16 value: exp(bf16(x * bf16(ln 2))), rounded.
          const float t = round_to<__nv_bfloat16>(round_to<__nv_bfloat16>(s[i][j] - m[i]) * kLn2Bf16);
          p = round_to<__nv_bfloat16>(expf(t));
          rs += p;
        }
        P_s[(rg + 16 * i) * kPld + cg + 16 * j] = round_to<T>(p);
      }
      if (FORM == kBf16Exp) l[i] += half_warp_sum(rs);
    }
    pv(V_s, P_s, rg, cg);
  }

  // Join the online state b over keys disjoint from this one's.
  __device__ __forceinline__ void merge(const AttnTile& b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], b.m[i]);
      const float a0 = exp2f(m[i] - m_new), a1 = exp2f(b.m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * a0 + b.l[i] * a1;
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] = o[i][j] * a0 + b.o[i][j] * a1;
    }
  }
};

}  // namespace tapclip
