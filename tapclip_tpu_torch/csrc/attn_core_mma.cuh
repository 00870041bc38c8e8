// The attention step on the tensor cores of K2 (attn_block.cu), B14
// (int8_attn.cu) and B6 (mha.cu): softmax_masked(q k^T / sqrt(Dh)) v per
// (batch row, head, query tile) from packed rows qkv [B T, 3W] (q, k, v
// column blocks, head h at h Dh in each), keys at or past `valid` masked,
// and with CAUSAL the keys after the query.
//
// K3's tile walk (flash_mma.cuh): ROWS / 16 warps, 64-key tiles with an
// online softmax in the log2 domain, the score accumulator reused in
// registers as p.  Every operand reaches the MMAs as bf16 tiles in shared
// memory, read by ldmatrix straight from the packed rows (row stride 3W):
// bf16 qkv by 16-byte cp.async, K and V double-buffered; f32 qkv split once
// per block into bf16 term planes (split_rows), where each warp would split
// every fragment it reads again (K and V are read by every warp of the
// block).  q . k^T takes three bf16 terms of q and k where they are f32 in
// memory (six MMAs) and one where they are bf16 (one exact MMA); p . v
// takes kF32Terms terms of p and v, or one where both are values of bf16 (p
// rounded to bf16, v a bf16 value in memory of either type: the one term is
// exact).  The terms, fragments and MMAs are those of the in-register split.
//
// Template arguments:
//   In   the type of qkv in memory: float for K2 and B14 (their f32
//        workspace), the dtype for B6 (the caller's qkv);
//   PT   the type that sets the roundings of p . v: bf16 where the caller's
//        function rounds p (and v) to bf16 (K2 and B6 in bf16, B14
//        stochastic in bf16), float where it attends in f32 (K2 and B6 in
//        f32, B14 in f32 and in its round-to-nearest mode);
//   OT   the type the output rows are stored in (K2, B6: the dtype; B14:
//        f32, the TPU kernel's f32 attention scratch);
//   CAUSAL  keys after the query masked (B6 in the text tower): the walk
//        stops at the key tile that holds the block's last query row and
//        masks inside the tiles that reach past a warp's first row; key 0 is
//        visible to every row, so no row is wholly masked;
//   RMAX whether the epilogue folds each row's largest |out| into rmax[row]
//        (B14: the attention output's quantizer needs the whole row's max,
//        over every head): atomicMax on the bits of a non-negative float,
//        which no order of the blocks changes.
// Key tiles wholly at or past `valid` are skipped: their probabilities are
// exactly 0, so the sums do not change.  No other atomics: a call repeats
// bit for bit.
// The kernel's body is a device function of its work item (attn_core_tile:
// batch row, head, first query row), which the kernel calls with blockIdx
// and S1's persistent layer (fused_layer.cu) calls for the items it walks.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

// Kernels in a header sit in a named namespace: nvcc's host stub cannot name
// a kernel in an anonymous namespace nested in a named one.
namespace tapclip {
namespace attn {

using namespace tapclip::mma;

// out[b, t, h Dh : (h + 1) Dh] for one (batch row b, head h, query tile
// from row q0).  All 2 ROWS threads of the block call it; it reads the
// block's dynamic shared memory from its start.
template <typename In, typename PT, typename OT, int DH, int ROWS, bool CAUSAL, bool RMAX>
__device__ __forceinline__ void attn_core_tile(const In* __restrict__ qkv, OT* __restrict__ out,
                                               float* __restrict__ rmax, int T_, int W, int valid, int b, int h,
                                               int q0) {
  static_assert(kIsF32<In> || !kIsF32<PT>, "p is rounded to v's dtype: a bf16 v takes a bf16 p");
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = 2 * ROWS;  // ROWS / 16 warps
  constexpr int kVTerms = kIsF32<PT> ? kF32Terms : 1;  // v and the rounded p hold values of PT
  // f32 qkv is split once per block into bf16 term planes (kQK of q and k,
  // kVTerms of v); bf16 qkv is staged as it is, K and V double-buffered.
  constexpr bool kSplit = kIsF32<In>;
  constexpr int kQK = kSplit ? kF32Terms : 1;
  constexpr int kLd = tile_ld<bf16, DH>();
  constexpr int kQPlane = ROWS * kLd, kKVPlane = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV_s = Q_s + kQK * kQPlane;  // split: K's planes, then V's; else buffer i: K at KV_s + 2 i kKVPlane, then V
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const In* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const In* k = q + W;
  const In* v = q + 2 * W;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;
  // Keys at or past valid add nothing, and causal, keys past the tile's last row.
  const int key_end = CAUSAL ? min(valid, q0 + ROWS) : valid;
  const int n_tiles = (key_end + kTile - 1) / kTile;
  // Causal, key rows past key_end are staged as zeros (never loaded) and the
  // products skip each warp's 16-key blocks past its last row.  The
  // non-causal walk stages every row below T and runs every block: skipping
  // the blocks past valid there moved the output bits of the f32 instance K2
  // shares with B6 (same arithmetic, other compiled code), which K2_BITS pins.
  const int kv_end = CAUSAL ? key_end : T_;
  const bool active = q0 + r0 < T_;  // the warp holds a row below T

  if constexpr (kSplit) {
    split_rows<DH, ROWS, kQK, kThreads>(Q_s, kQPlane, q, st, q0, T_);
  } else {
    load_tile<bf16, DH, ROWS, kThreads>(Q_s, q, st, q0, T_);
    load_tile<bf16, DH, kTile, kThreads>(KV_s, k, st, 0, kv_end);
    load_tile<bf16, DH, kTile, kThreads>(KV_s + kKVPlane, v, st, 0, kv_end);
    cp_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const bf16* K_s;
    if constexpr (kSplit) {
      if (j > 0) __syncthreads();  // every warp is done with tile j - 1's planes
      split_rows<DH, kTile, kQK, kThreads>(KV_s, kKVPlane, k, st, j * kTile, kv_end);
      split_rows<DH, kTile, kVTerms, kThreads>(KV_s + kQK * kKVPlane, kKVPlane, v, st, j * kTile, kv_end);
      K_s = KV_s;
    } else {
      if (j + 1 < n_tiles) {
        bf16* nxt = KV_s + ((j + 1) & 1) * 2 * kKVPlane;
        load_tile<bf16, DH, kTile, kThreads>(nxt, k, st, (j + 1) * kTile, kv_end);
        load_tile<bf16, DH, kTile, kThreads>(nxt + kKVPlane, v, st, (j + 1) * kTile, kv_end);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      K_s = KV_s + (j & 1) * 2 * kKVPlane;
    }
    __syncthreads();
    const bf16* V_s = K_s + kQK * kKVPlane;
    if (active) {
      const int kt0 = j * kTile;
      // Causal, the keys of the tile any row of the warp sees: below valid
      // and not after the warp's last row (the blocks past them have p = 0).
      const int live = CAUSAL ? min(valid, q0 + r0 + 16) - kt0 : kTile;
      float s[kTile / 8][4], mt[2] = {-INFINITY, -INFINITY};
      warp_abt_planes<DH, kTile, kQK, kQK>(s, Q_s, kQPlane, r0, K_s, kKVPlane, 0, live);
      // Per-key tests where the tile reaches valid or T, or (causal) holds a
      // key after the warp's first row.
      if (kt0 + kTile > min(valid, T_) || (CAUSAL && kt0 + kTile - 1 > q0 + r0)) {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
            float x = s[n][e] * scale_log2;
            if (key >= T_) x = -INFINITY;
            else if (key >= valid) x = kNegBig;
            else if (CAUSAL && key > q0 + r0 + (lane >> 2) + 8 * (e >> 1)) x = kNegBig;
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
      warp_pv_planes<DH, kTile, kVTerms, kSplit ? kVTerms : 1>(o, s, V_s, kKVPlane, 0, live);
    }
    if constexpr (!kSplit) __syncthreads();  // this buffer is refilled with tile j + 2
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

template <typename In, typename PT, typename OT, int DH, int ROWS, bool CAUSAL, bool RMAX>
__global__ void __launch_bounds__(2 * ROWS)
attn_core_mma_kernel(const In* __restrict__ qkv, OT* __restrict__ out, float* __restrict__ rmax, int H, int T_,
                     int W, int valid) {
  attn_core_tile<In, PT, OT, DH, ROWS, CAUSAL, RMAX>(qkv, out, rmax, T_, W, valid, blockIdx.x / H, blockIdx.x % H,
                                                     blockIdx.y * ROWS);
}

// Bytes of dynamic shared memory an item takes: f32 qkv, the term planes of
// q, k and v (one key tile); bf16, q, and K and V double-buffered (one key
// tile needs no second buffer).
template <typename In, typename PT, int DH, int ROWS>
__host__ __device__ constexpr size_t core_smem(int T_) {
  return static_cast<size_t>(kIsF32<In> ? kF32Terms * ROWS + (kF32Terms + (kIsF32<PT> ? kF32Terms : 1)) * kTile
                                        : ROWS + (T_ > kTile ? 2 : 1) * 2 * kTile) *
         tile_ld<__nv_bfloat16, DH>() * sizeof(__nv_bfloat16);
}

template <typename In, typename PT, typename OT, int DH, int ROWS, bool CAUSAL, bool RMAX>
cudaError_t launch_core(const In* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                        cudaStream_t s) {
  const size_t smem = core_smem<In, PT, DH, ROWS>(T_);
  auto kernel = attn_core_mma_kernel<In, PT, OT, DH, ROWS, CAUSAL, RMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * ROWS, smem, s>>>(qkv, out, rmax, H, T_, W, valid);
  return cudaGetLastError();
}

// Query-tile height as K3's: 16 rows up to T 32, 32 up to T 128, 64 past.
template <typename In, typename PT, typename OT, int DH, bool CAUSAL, bool RMAX>
cudaError_t launch_core_rows(const In* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                             cudaStream_t s) {
  if (T_ <= 32) return launch_core<In, PT, OT, DH, 16, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
  if (T_ <= 128) return launch_core<In, PT, OT, DH, 32, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
  return launch_core<In, PT, OT, DH, 64, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
}

// The attention step over qkv [B T, 3W] of In into out [B T, W] of OT, head
// dim W / H in {16, 32, 64, 128}; with RMAX, rmax [B T] (zeroed by the
// caller) gathers each row's largest |out|.  qkv 16-byte aligned.
template <typename In, typename PT, typename OT, bool CAUSAL = false, bool RMAX = false>
cudaError_t launch_attn_core(const In* qkv, OT* out, float* rmax, int B, int H, int T_, int W, int valid,
                             cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core_rows<In, PT, OT, 16, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 32: return launch_core_rows<In, PT, OT, 32, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 64: return launch_core_rows<In, PT, OT, 64, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    case 128: return launch_core_rows<In, PT, OT, 128, CAUSAL, RMAX>(qkv, out, rmax, B, H, T_, W, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace tapclip
