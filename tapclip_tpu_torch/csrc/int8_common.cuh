// Shared pieces of the int8 W8A8 kernels: B13 (int8_mlp.cu) and B14
// (int8_attn.cu), the counterparts of tapclip_tpu/ops/int8_mlp.py and
// tapclip_tpu/ops/int8_attn.py.
//
// The scheme is the JAX package's: weights quantized per output column to
// int8 outside the kernel (ops/int8_mlp.py::quantize_cols_int8), packed four
// reduction rows to a 32-bit word ([K / 4, N] int32, ops/int8_mlp.py::pack_k4)
// for __dp4a or laid out K-major ([N, Kp]) for the tensor cores; activations
// quantized per row inside the kernel, q = clip(floor(v / s + u), -127, 127)
// with s = max(amax, 1e-8) / 127 (stochastic) or clip(round(v / s)) (round
// to nearest); int8 x int8 products summed exactly in int32 (__dp4a, four
// products a word, or mma.sync m16n8k32) and dequantized as
// ((acc * s_row) * s_col) + bias.  Every float step is written with the
// round-to-nearest intrinsics (__fdiv_rn, __fmul_rn, __fadd_rn) so that nvcc
// cannot contract a multiply and an add into one FMA: the plain PyTorch
// version performs the same IEEE operations in the same order, so the codes
// agree except where LayerNorm's or erf's last bit differs.
//
// The random bits.  The TPU kernel draws pltpu.prng_random_bits seeded with
// seed + program_id; the card cannot give those bits.  Here a counter-based
// 32-bit hash gives the bits of element (row, col) of quantizer `stream`:
//   key  = mix32(mix32(mix32(seed ^ 0x9e3779b9) ^ stream) ^ row)
//   bits = mix32(key ^ col),  u = (bits >> 8) * 2^-24  (as the TPU kernel)
// with mix32 the "lowbias32" finaliser.  ops/int8_mlp.py::rand_bits computes
// the same bits in torch, so kernel and plain version see identical draws.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace tapclip {

// The quantizers' streams: which of the four activation quantizers a draw is for.
constexpr uint32_t kStreamMlpY = 0;   // B13: LN(x) before the fc product
constexpr uint32_t kStreamMlpH = 1;   // B13: GELU output before the proj product
constexpr uint32_t kStreamAttnY = 2;  // B14: LN(x) before the qkv product
constexpr uint32_t kStreamAttnA = 3;  // B14: attention output before the out product

constexpr int kInt8Threads = 256;
constexpr int kInt8Warps = kInt8Threads / 32;
constexpr int kInt8Rows = 8;  // rows per block: one warp each for the row passes

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7feb352dU;
  h ^= h >> 15;
  h *= 0x846ca68bU;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t stream, uint32_t row) {
  return mix32(mix32(mix32(seed ^ 0x9e3779b9U) ^ stream) ^ row);
}

// u in [0, 1): the top 24 bits of the element's hash, exactly as the TPU kernel.
__device__ __forceinline__ float uniform24(uint32_t key, uint32_t col) {
  return __uint2float_rn(mix32(key ^ col) >> 8) * (1.f / 16777216.f);
}

// LayerNorm of one row by one warp into dst (f32), in the plain version's
// order: ((x - mean) * rsqrt(var + eps)) * gamma + beta.  ROUND rounds the
// result to T (the round-to-nearest mode, where the JAX reference quantizes
// layer_norm's output in the compute dtype).
template <typename T, bool ROUND>
__device__ __forceinline__ void ln_row_warp(const T* __restrict__ xr, const float* __restrict__ gamma,
                                            const float* __restrict__ beta, int W, float eps,
                                            float* dst, int lane) {
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
  const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(W));
  float v = 0.f;
  for (int c = lane; c < W; c += 32) {
    const float d = __fsub_rn(to_f(xr[c]), mean);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(v), static_cast<float>(W));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  for (int c = lane; c < W; c += 32) {
    float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(xr[c]), mean), rstd), gamma[c]), beta[c]);
    if (ROUND) y = round_to<T>(y);
    dst[c] = y;
  }
}

// The scale of a row whose largest magnitude is amax, s = max(amax, 1e-8) /
// 127; with RECIP (the S5 variant of scripts/int8_mlp_ab.py) s = 1 / inv,
// inv = 127 / max(amax, 1e-8).
template <bool RECIP>
__device__ __forceinline__ float row_scale(float amax, float& inv) {
  amax = fmaxf(amax, 1e-8f);
  inv = RECIP ? __fdiv_rn(127.f, amax) : 0.f;
  return RECIP ? __fdiv_rn(1.f, inv) : __fdiv_rn(amax, 127.f);
}

// The int8 code of v, column c of a row with scale s (inv with RECIP) and
// row key `key`.  SR: floor(v / s + u) with the draw of (key, c); else
// round(v / s), half to even (rintf, as torch.round and jnp.round).  RECIP:
// v * inv in place of v / s.
template <bool SR, bool RECIP>
__device__ __forceinline__ int8_t code_of(float v, float scale, float inv, uint32_t key, int c) {
  float t = RECIP ? __fmul_rn(v, inv) : __fdiv_rn(v, scale);
  t = SR ? floorf(__fadd_rn(t, uniform24(key, static_cast<uint32_t>(c)))) : rintf(t);
  return static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
}

// Quantize the n floats of one row (shared or global memory) whose largest
// magnitude is amax into int8 codes q[0, n_pad) (zeros past n), one warp;
// returns the row's scale.
template <bool SR, bool RECIP>
__device__ __forceinline__ float quantize_codes_warp(const float* v, float amax, int n, int n_pad, int8_t* q,
                                                     uint32_t key, int lane) {
  float inv;
  const float scale = row_scale<RECIP>(amax, inv);
  for (int c = lane; c < n_pad; c += 32) q[c] = c < n ? code_of<SR, RECIP>(v[c], scale, inv, key, c) : 0;
  return scale;
}

// As quantize_codes_warp, with the row's amax taken here.
template <bool SR, bool RECIP>
__device__ __forceinline__ float quantize_row_warp(const float* v, int n, int n_pad, int8_t* q,
                                                   uint32_t key, int lane) {
  float amax = 0.f;
  for (int c = lane; c < n; c += 32) amax = fmaxf(amax, fabsf(v[c]));
  return quantize_codes_warp<SR, RECIP>(v, warp_max(amax), n, n_pad, q, key, lane);
}

// Dequantized value of an int32 sum: ((acc * s_row) * s_col) + bias.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col), bias);
}

// The int8 product of RB rows of codes in shared memory (q_s: kw 32-bit
// words a row, kw a multiple of 4, zeros past the reduction length) with
// packed weights w [kw, N] (word k of column j holds rows 4k..4k+3 of column
// j): thread t owns columns t, t + 256, ... (NC of them at a time), walks the
// reduction axis four words at a time (coalesced weight loads, one 16-byte
// broadcast load of each row's codes, 16 __dp4a a row) and hands each exact
// int32 sum to epi(r, j, acc).
template <int RB, int NC, typename Epi>
__device__ __forceinline__ void rows_dot_packed(const int* q_s, int kw, const int* __restrict__ w,
                                                int N, Epi epi) {
  for (int j0 = threadIdx.x; j0 < N; j0 += kInt8Threads * NC) {
    int acc[RB][NC];
    int col[NC];
    bool ok[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      col[c] = j0 + c * kInt8Threads;
      ok[c] = col[c] < N;
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r][c] = 0;
    }
    for (int k = 0; k < kw; k += 4) {
      int wv[4][NC];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wv[kk][c] = ok[c] ? __ldg(w + static_cast<size_t>(k + kk) * N + col[c]) : 0;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int4 a = *reinterpret_cast<const int4*>(q_s + r * kw + k);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = __dp4a(a.x, wv[0][c], acc[r][c]);
          acc[r][c] = __dp4a(a.y, wv[1][c], acc[r][c]);
          acc[r][c] = __dp4a(a.z, wv[2][c], acc[r][c]);
          acc[r][c] = __dp4a(a.w, wv[3][c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (ok[c]) epi(r, col[c], acc[r][c]);
  }
}

}  // namespace tapclip
