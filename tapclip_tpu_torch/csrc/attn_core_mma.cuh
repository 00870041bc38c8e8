// The attention step of K2 (attn_block.cu) and B14 (int8_attn.cu) on the
// tensor cores: softmax_masked(q k^T / sqrt(Dh)) v per (batch row, head,
// query tile) from a packed f32 workspace qkv [B T, 3W] (q, k, v column
// blocks, head h at h Dh in each), keys at or past `valid` masked, never
// causal.
//
// K3's tile walk (flash_mma.cuh): ROWS / 16 warps, 64-key tiles with an
// online softmax in the log2 domain, K and V double-buffered by 16-byte
// cp.async straight from the packed rows (row stride 3W), the score
// accumulator reused in registers as p.  q . k^T splits q and k into three
// bf16 terms (six MMAs: they are f32 values whatever the dtype); p . v takes
// kF32Terms terms of p and v, or one where both are values of bf16 (p
// rounded to bf16, v a bf16 value held in f32: the one term is exact).
//
// Template arguments:
//   PT   the type that sets the roundings of p . v: bf16 where the caller's
//        function rounds p (and v) to bf16 (K2 in bf16, B14 stochastic in
//        bf16), float where it attends in f32 (K2 in f32, B14 in f32 and in
//        its round-to-nearest mode);
//   OT   the type the output rows are stored in (K2: the dtype; B14: f32,
//        the TPU kernel's f32 attention scratch);
//   RMAX whether the epilogue folds each row's largest |out| into rmax[row]
//        (B14: the attention output's quantizer needs the whole row's max,
//        over every head): atomicMax on the bits of a non-negative float,
//        which no order of the blocks changes.
// No other atomics: a call repeats bit for bit.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

// Kernels in a header sit in a named namespace: nvcc's host stub cannot name
// a kernel in an anonymous namespace nested in a named one.
namespace tapclip {
namespace attn {

using namespace tapclip::mma;

// out[b, t, h Dh : (h + 1) Dh] for one (batch row b, head h, query tile).
template <typename PT, typename OT, int DH, int ROWS, bool RMAX>
__global__ void __launch_bounds__(2 * ROWS)
attn_core_mma_kernel(const float* __restrict__ qkv, OT* __restrict__ out, float* __restrict__ rmax, int H,
                     int T_, int W, int valid) {
  constexpr int kThreads = 2 * ROWS;  // ROWS / 16 warps
  constexpr int kLd = tile_ld<float, DH>();
  constexpr int kVTerms = kIsF32<PT> ? kF32Terms : 1;  // v and the rounded p hold values of PT
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Q_s = reinterpret_cast<float*>(smem_raw);
  float* KV_s = Q_s + ROWS * kLd;  // buffer i: K at KV_s + 2 i kTile kLd, then V
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const float* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const float* k = q + W;
  const float* v = q + 2 * W;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;
  const int n_tiles = (T_ + kTile - 1) / kTile;
  const bool active = q0 + r0 < T_;  // the warp holds a row below T

  load_tile<float, DH, ROWS, kThreads>(Q_s, q, st, q0, T_);
  load_tile<float, DH, kTile, kThreads>(KV_s, k, st, 0, T_);
  load_tile<float, DH, kTile, kThreads>(KV_s + kTile * kLd, v, st, 0, T_);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* nxt = KV_s + ((j + 1) & 1) * 2 * kTile * kLd;
      load_tile<float, DH, kTile, kThreads>(nxt, k, st, (j + 1) * kTile, T_);
      load_tile<float, DH, kTile, kThreads>(nxt + kTile * kLd, v, st, (j + 1) * kTile, T_);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* K_s = KV_s + (j & 1) * 2 * kTile * kLd;
    if (active) {
      const int kt0 = j * kTile;
      float s[kTile / 8][4], mt[2] = {-INFINITY, -INFINITY};
      warp_abt<float, DH, kTile>(s, Q_s, r0, K_s, 0);
      if (kt0 + kTile > min(valid, T_)) {  // the tile reaches valid or T: per-key tests
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
            float x = s[n][e] * scale_log2;
            if (key >= T_) x = -INFINITY;
            else if (key >= valid) x = kNegBig;
            s[n][e] = x;
            mt[e >> 1] = fmaxf(mt[e >> 1], x);
          }
      } else {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= scale_log2;
            mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mt[r]));  // finite: key 0 is below T
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;  // this lane's share of the row sum, unrounded p
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      warp_pv<float, DH, kTile, kVTerms, kVTerms>(o, s, K_s + kTile * kLd, 0);
    }
    __syncthreads();  // this buffer is refilled with tile j + 2
  }
  if (!active) return;
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
  const size_t row0 = static_cast<size_t>(b) * T_;
  store_rows<OT, DH>(out + row0 * W + h * DH, W, q0 + r0, T_, o, inv_l);
  if constexpr (RMAX) {  // the stored values' largest magnitude, row by row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = 0.f;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        mx = fmaxf(mx, fmaxf(fabsf(o[n][2 * r] * inv_l[r]), fabsf(o[n][2 * r + 1] * inv_l[r])));
      mx = quad_max(mx);  // the quad's lanes share the row
      const int row = q0 + r0 + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < T_) atomicMax(reinterpret_cast<int*>(rmax + row0 + row), __float_as_int(mx));
    }
  }
}

template <typename PT, typename OT, int DH, int ROWS, bool RMAX>
cudaError_t launch_core(const float* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                        cudaStream_t s) {
  constexpr int kLd = tile_ld<float, DH>();
  const int n_buf = T_ > kTile ? 2 : 1;  // one key tile needs no second buffer
  const size_t smem = (ROWS + n_buf * 2 * kTile) * kLd * sizeof(float);
  auto kernel = attn_core_mma_kernel<PT, OT, DH, ROWS, RMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * ROWS, smem, s>>>(qkv, out, rmax, H, T_, W, valid);
  return cudaGetLastError();
}

// Query-tile height as K3's: 16 rows up to T 32, 32 up to T 128, 64 past.
template <typename PT, typename OT, int DH, bool RMAX>
cudaError_t launch_core_rows(const float* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                             cudaStream_t s) {
  if (T_ <= 32) return launch_core<PT, OT, DH, 16, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
  if (T_ <= 128) return launch_core<PT, OT, DH, 32, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
  return launch_core<PT, OT, DH, 64, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
}

// The attention step over qkv [B T, 3W] f32 into out [B T, W] of OT, head
// dim W / H in {16, 32, 64, 128}; with RMAX, rmax [B T] (zeroed by the
// caller) gathers each row's largest |out|.
template <typename PT, typename OT, bool RMAX = false>
cudaError_t launch_attn_core(const float* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                             cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core_rows<PT, OT, 16, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 32: return launch_core_rows<PT, OT, 32, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 64: return launch_core_rows<PT, OT, 64, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 128: return launch_core_rows<PT, OT, 128, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace tapclip
