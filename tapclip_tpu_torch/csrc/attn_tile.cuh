// Softmax attention of one 64-row query tile against all keys, one 64-key
// tile at a time (online softmax), shared by the fused attention block (K2,
// attn_block.cu), the attribution attention (K3, attn_aux.cu) and the
// packed-QKV attention core (B6, mha.cu).
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
// unrounded p.  With a causal mask (causal_q0 >= 0, the query index of tile
// row 0) a key after the query takes the same -1e30; key 0 is never masked,
// so every row's max is finite from the first tile on, and a later tile whose
// keys are all masked for a row adds exactly 0 to it (callers skip the tiles
// wholly above the diagonal).
//
// Block: 256 threads as a 16 x 16 grid.  Thread (rg, cg) owns query rows
// rg + 16 i (i < 4), key columns cg + 16 j (j < 4) of the score tile and
// output columns cg + 16 j (j < DH / 16).  The 16 threads of a row group
// share a half warp, so row reductions are half-warp shuffles.
#pragma once

#include "common.cuh"

namespace tapclip {

template <typename T, int DH>
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

  // One key tile starting at key kt0 of n_keys.  K_s/V_s rows past n_keys
  // must hold zeros.  causal_q0 < 0: no causal mask.
  __device__ __forceinline__ void step(const float* Q_s, const float* K_s,
                                       const float* V_s, float* P_s, int kt0,
                                       int n_keys, int valid, float scale_log2,
                                       int rg, int cg, int causal_q0 = -1) {
    float s[4][4];
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
        float v = s[i][j] * scale_log2;
        if (key >= n_keys) v = -INFINITY;
        else if (key >= valid || (causal_q0 >= 0 && key > causal_q0 + rg + 16 * i)) v = kNegBig;
        s[i][j] = v;
      }
    }
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
        rs += p;
        P_s[(rg + 16 * i) * kPld + cg + 16 * j] = round_to<T>(p);
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < kDj; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      float pv[4], vv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = P_s[(rg + 16 * i) * kPld + k];
#pragma unroll
      for (int j = 0; j < kDj; ++j) vv[j] = V_s[k * kLd + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
    __syncthreads();  // K_s, V_s and P_s are overwritten by the next tile
  }
};

}  // namespace tapclip
