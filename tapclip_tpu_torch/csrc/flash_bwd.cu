// The blockwise attention backward: three kernels that run as one chain,
//   lse   = the row log-sum-exp of the masked log2-domain scores,
//   dk, dv over query tiles, one block per key tile,
//   dq     over key tiles,   one block per query tile,
// with delta = rowsum(dO * O) from the forward's output (a plain PyTorch
// pass in the wrapper, as the JAX package computes it outside any kernel).
//
// Replaces tapclip_tpu/ops/flash_attention.py::_blocked_lse_kernel (LSE),
// ::_blocked_bwd_dkv_kernel (dK/dV) and ::_blocked_bwd_dq_kernel (dQ), the
// three pallas_calls of _pallas_attention_bwd_blocked, and with them the
// single-block ::_attn_bwd_kernel: that kernel holds the whole [T, T] f32
// score tile (16 MB at T = 2048, far past the 227 KB of shared memory a
// block can use), so on the card the chain computes its function at every
// T.  The wrapper (tapclip_tpu_torch/ops/flash_attention.py) runs the chain
// as the backward of fused_attention (attn_impl="pallas"), and of the
// packed-QKV core (fused_mha) past the [T, T] tile of attn_bwd_core.cuh.
//
// Math, as the JAX kernels: q, k, v, dO are read as f32 and every product
// accumulates in f32 (flash_attention.py casts to f32 in both backward
// kernels); s2 = q.k^T * Dh^-1/2 * log2 e; keys at or past valid[b], and
// after the query when causal, are masked (-1e30 in the LSE, p = 0 in the
// gradients); p = exp2(s2 - lse2); dv += p^T dO; dp = dO v^T;
// ds = p (dp - delta) Dh^-1/2; dk += ds^T q; dq += ds k.  With kRoundP
// (the packed core's bfloat16 backward, whose TPU kernel rounds p to the
// compute dtype before p^T dO) p is rounded for the dv product only.
// Results go out in the compute dtype.  No atomics: each output row is
// summed by one block in a fixed order, so results repeat bit for bit.
//
// Layout: every [B, H, T, Dh] operand is read through (batch, head, row)
// strides, so the same launches serve contiguous per-head tensors
// (attn_impl="pallas") and the packed [B, T, 3W] qkv with its [B, T, W]
// cotangent (the packed core), writing dq, dk, dv straight into the packed
// gradient.  q, k, v, dq, dk, dv share one stride set, dO another; lse and
// delta are contiguous [B, H, T] f32.
//
// Design: 256 threads as a 16 x 16 grid over a [64, 64] tile, as the
// forward's attn_tile.cuh: thread (rg, cg) computes scores for query rows
// rg + 16 i and keys cg + 16 j (i, j < 4), and accumulates output rows
// rg + 16 i, columns cg + 16 j (j < Dh / 16).  Operand tiles of 64 rows sit
// in shared memory with a padded row stride (Dh + 1); p and ds pass from
// the score layout to the accumulation layout through [64, 65] tiles.
// Causal blocks skip the tiles wholly above the diagonal, and every loop
// stops at valid[b] (a masked key adds exactly 0).
//
// What bounds it on the card: inferred, not measured by a profile.  The
// products run on the FMA units in f32, fed from shared memory (8 loads for
// 16 FMAs in the score products), so an operation bound: at ViT-B/16's text
// shape (8 classes x 8 heads, T 88, valid 82) the whole chain is about
// 0.5 GFLOP, 7 microseconds at the f32 peak; the grid there is 128 blocks of
// one or two tiles each, fewer than the card's SMs hold, so launch latency
// and the serial tile loop dominate.  At T 4096 the grid fills the card and the
// shared-memory feed sets the rate.  Tensor-core MMA (mma.sync / wgmma) on
// bf16 tiles and TMA loads are later work.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows and keys of a tile
constexpr int kPld = kTile + 1; // padded row stride of the [64, 64] p / ds tiles

// Element (b, h, t, d) of an operand sits at b * sb + h * sh + t * st + d.
struct Strides {
  int sb, sh, st;
};

__device__ __forceinline__ size_t row_off(Strides s, int b, int h, int t) {
  return static_cast<size_t>(b) * s.sb + static_cast<size_t>(h) * s.sh +
         static_cast<size_t>(t) * s.st;
}

// X_s[r][d] = x[row t0 + r][d] as f32 (zeros for rows past T).
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* X_s, const T* __restrict__ x, Strides s, int b,
                                          int h, int t0, int T_) {
  for (int e = threadIdx.x; e < kTile * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    X_s[r * (DH + 1) + d] = t0 + r < T_ ? to_f(x[row_off(s, b, h, t0 + r) + d]) : 0.f;
  }
}

// acc[i][j] = A_s[rg + 16 i] . B_s[cg + 16 j]: this thread's 4 x 4 of the
// [64, 64] product A B^T of two staged tiles.
template <int DH>
__device__ __forceinline__ void tile_abt(const float* A_s, const float* B_s, int rg, int cg,
                                         float (&acc)[4][4]) {
  constexpr int kLd = DH + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A_s[(rg + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B_s[(cg + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// Key `key` is visible to query `row` (both below T).
template <bool kCausal>
__device__ __forceinline__ bool visible(int row, int key, int valid) {
  return key < valid && (!kCausal || key <= row);
}

// LSE: one block per (batch row, head, 64-row query tile), over key tiles.
template <typename T, int DH, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides sq,
                 const int* __restrict__ valid_b, float* __restrict__ lse, int H, int T_) {
  constexpr int kLd = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* Q_s = smem;
  float* K_s = Q_s + kTile * kLd;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;

  load_tile<T, DH>(Q_s, q, sq, b, h, q0, T_);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int k_end = kCausal ? min(valid, q0 + kTile) : valid;
  for (int kt0 = 0; kt0 < k_end; kt0 += kTile) {
    load_tile<T, DH>(K_s, k, sq, b, h, kt0, T_);
    __syncthreads();
    float s[4][4];
    tile_abt<DH>(Q_s, K_s, rg, cg, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt0 + cg + 16 * j;
        // Slots past T add nothing (-inf); masked keys take the JAX
        // kernel's -1e30.  Key 0 is visible to every row, so m is finite
        // from the first tile on.
        s[i][j] = key >= T_ ? -INFINITY
                            : (visible<kCausal>(row, key, valid) ? s[i][j] * scale_log2 : kNegBig);
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += exp2f(s[i][j] - m_new);
      l[i] = l[i] * exp2f(m[i] - m_new) + half_warp_sum(rs);
      m[i] = m_new;
    }
    __syncthreads();  // K_s is overwritten by the next tile
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      if (row < T_) lse[static_cast<size_t>(bh) * T_ + row] = m[i] + log2f(fmaxf(l[i], 1e-30f));
    }
  }
}

// p = exp2(s2 - lse) where visible, else 0, and ds = p (dp - delta) scale,
// for this thread's 4 x 4 of a (query tile q0, key tile k0) pair.
template <bool kCausal>
__device__ __forceinline__ void probs_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                             const float* lse_r, const float* delta_r, int q0,
                                             int k0, int rg, int cg, int valid, int T_,
                                             float scale, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + cg + 16 * j;
      const float p = row < T_ && visible<kCausal>(row, key, valid)
                          ? exp2f(s[i][j] * scale_log2 - lse_r[i])
                          : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_r[i]) * scale;
    }
  }
}

// dK/dV: one block per (batch row, head, 64-key tile), over query tiles.
template <typename T, int DH, bool kCausal, bool kRoundP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, Strides sq, Strides sg,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ valid_b, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int T_) {
  constexpr int kLd = DH + 1;
  constexpr int kDj = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* K_s = smem;
  float* V_s = K_s + kTile * kLd;
  float* Q_s = V_s + kTile * kLd;
  float* G_s = Q_s + kTile * kLd;
  float* P_s = G_s + kTile * kLd;  // [query][key]: p (rounded with kRoundP)
  float* S_s = P_s + kTile * kPld; // [query][key]: ds
  float* L_s = S_s + kTile * kPld; // lse of the query tile's rows
  float* D_s = L_s + kTile;        // delta of the query tile's rows
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;

  float dk_acc[4][kDj], dv_acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < valid) {  // a key tile wholly at or past valid has zero gradients
    load_tile<T, DH>(K_s, k, sq, b, h, k0, T_);
    load_tile<T, DH>(V_s, v, sq, b, h, k0, T_);
    // Causal: query tiles before this key tile see none of its keys.
    for (int qt0 = kCausal ? k0 : 0; qt0 < T_; qt0 += kTile) {
      load_tile<T, DH>(Q_s, q, sq, b, h, qt0, T_);
      load_tile<T, DH>(G_s, g, sg, b, h, qt0, T_);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = qt0 + r < T_;
        L_s[r] = in ? lse[static_cast<size_t>(bh) * T_ + qt0 + r] : 0.f;
        D_s[r] = in ? delta[static_cast<size_t>(bh) * T_ + qt0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4], lse_r[4], delta_r[4];
      tile_abt<DH>(Q_s, K_s, rg, cg, s);
      tile_abt<DH>(G_s, V_s, rg, cg, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lse_r[i] = L_s[rg + 16 * i];
        delta_r[i] = D_s[rg + 16 * i];
      }
      probs_and_ds<kCausal>(s, dp, lse_r, delta_r, qt0, k0, rg, cg, valid, T_, scale, scale_log2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (rg + 16 * i) * kPld + cg + 16 * j;
          P_s[e] = kRoundP ? round_to<T>(s[i][j]) : s[i][j];
          S_s[e] = dp[i][j];
        }
      __syncthreads();
      // dv[key][d] += p[query][key] dO[query][d]; dk[key][d] += ds[query][key] q[query][d].
      const int n_rows = min(kTile, T_ - qt0);
#pragma unroll 4
      for (int r = 0; r < n_rows; ++r) {
        float pv[4], sv[4], gv[kDj], qv[kDj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = P_s[r * kPld + rg + 16 * i];
          sv[i] = S_s[r * kPld + rg + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          gv[j] = G_s[r * kLd + cg + 16 * j];
          qv[j] = Q_s[r * kLd + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDj; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
      __syncthreads();  // Q_s, G_s, P_s, S_s are overwritten by the next query tile
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= T_) continue;
    const size_t off = row_off(sq, b, h, key);
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      dk[off + cg + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[off + cg + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// dQ: one block per (batch row, head, 64-row query tile), over key tiles.
template <typename T, int DH, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, Strides sq, Strides sg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ valid_b, T* __restrict__ dq, int H, int T_) {
  constexpr int kLd = DH + 1;
  constexpr int kDj = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* Q_s = smem;
  float* G_s = Q_s + kTile * kLd;
  float* K_s = G_s + kTile * kLd;
  float* V_s = K_s + kTile * kLd;
  float* S_s = V_s + kTile * kLd;  // [query][key]: ds
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;

  load_tile<T, DH>(Q_s, q, sq, b, h, q0, T_);
  load_tile<T, DH>(G_s, g, sg, b, h, q0, T_);
  float lse_r[4], delta_r[4], acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    lse_r[i] = row < T_ ? lse[static_cast<size_t>(bh) * T_ + row] : 0.f;
    delta_r[i] = row < T_ ? delta[static_cast<size_t>(bh) * T_ + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  }
  const int k_end = kCausal ? min(valid, q0 + kTile) : valid;
  for (int kt0 = 0; kt0 < k_end; kt0 += kTile) {
    load_tile<T, DH>(K_s, k, sq, b, h, kt0, T_);
    load_tile<T, DH>(V_s, v, sq, b, h, kt0, T_);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<DH>(Q_s, K_s, rg, cg, s);
    tile_abt<DH>(G_s, V_s, rg, cg, dp);
    probs_and_ds<kCausal>(s, dp, lse_r, delta_r, q0, kt0, rg, cg, valid, T_, scale, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S_s[(rg + 16 * i) * kPld + cg + 16 * j] = dp[i][j];
    __syncthreads();
    // dq[query][d] += ds[query][key] k[key][d].
    const int n_keys = min(kTile, T_ - kt0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float sv[4], kv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = S_s[(rg + 16 * i) * kPld + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kv[j] = K_s[c * kLd + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
    __syncthreads();  // K_s, V_s, S_s are overwritten by the next key tile
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= T_) continue;
    const size_t off = row_off(sq, b, h, row);
#pragma unroll
    for (int j = 0; j < kDj; ++j) dq[off + cg + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// The launch arguments every kernel of the chain shares.
struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int* valid;
  void *dq, *dk, *dv;
  float* lse_out;
  int B, H, T;
  Strides sq, sg;
  cudaStream_t stream;
};

enum class Which { kLse, kDkv, kDq };

template <typename T, int DH, bool kCausal, bool kRoundP>
cudaError_t launch(Which which, const Args& a) {
  constexpr size_t kTileBytes = kTile * (DH + 1) * sizeof(float);
  constexpr size_t kPBytes = kTile * kPld * sizeof(float);
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  cudaError_t err = cudaSuccess;
  if (which == Which::kLse) {
    auto kernel = flash_lse_kernel<T, DH, kCausal>;
    const size_t smem = 2 * kTileBytes;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, a.sq, a.valid, a.lse_out, a.H, a.T);
  } else if (which == Which::kDkv) {
    auto kernel = flash_bwd_dkv_kernel<T, DH, kCausal, kRoundP>;
    const size_t smem = 4 * kTileBytes + 2 * kPBytes + 2 * kTile * sizeof(float);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.sq, a.sg, a.lse, a.delta, a.valid,
                                                static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                a.H, a.T);
  } else {
    auto kernel = flash_bwd_dq_kernel<T, DH, kCausal>;
    const size_t smem = 4 * kTileBytes + kPBytes;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.sq, a.sg, a.lse, a.delta, a.valid,
                                                static_cast<T*>(a.dq), a.H, a.T);
  }
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_flags(Which which, const Args& a, int causal, int round_p) {
  // round_p only matters for the dK/dV kernel in bfloat16 (a no-op in f32).
  if constexpr (!std::is_same<T, float>::value) {
    if (round_p && which == Which::kDkv) {
      return causal ? launch<T, DH, true, true>(which, a) : launch<T, DH, false, true>(which, a);
    }
  }
  return causal ? launch<T, DH, true, false>(which, a) : launch<T, DH, false, false>(which, a);
}

template <typename T>
cudaError_t launch_dh(Which which, const Args& a, int Dh, int causal, int round_p) {
  switch (Dh) {
    case 16: return launch_flags<T, 16>(which, a, causal, round_p);
    case 32: return launch_flags<T, 32>(which, a, causal, round_p);
    case 64: return launch_flags<T, 64>(which, a, causal, round_p);
    case 128: return launch_flags<T, 128>(which, a, causal, round_p);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const Args& a, int Dh, int causal, int round_p, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.T <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dh<float>(which, a, Dh, causal, round_p);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(which, a, Dh, causal, round_p);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared arguments: q, k, v [B, H, T, Dh] read through the strides
// (sq_b, sq_h, sq_t), dO through (sg_b, sg_h, sg_t), all in the compute dtype
// (0 float32, 1 bfloat16); valid [B] int32 (1 <= valid); Dh in
// {16, 32, 64, 128}; causal 0 or 1.

// lse [B, H, T] f32 out.
extern "C" int tapclip_flash_lse(const void* q, const void* k, const void* valid, void* lse,
                                 int B, int H, int T, int Dh, int sq_b, int sq_h, int sq_t,
                                 int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.valid = static_cast<const int*>(valid);
  a.lse_out = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.T = T;
  a.sq = {sq_b, sq_h, sq_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kLse, a, Dh, causal, 0, dtype);
}

// lse, delta [B, H, T] f32 in; dk, dv out through the q strides.  round_p:
// round p to the compute dtype before the dv product.
extern "C" int tapclip_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                     const void* lse, const void* delta, const void* valid,
                                     void* dk, void* dv, int B, int H, int T, int Dh, int sq_b,
                                     int sq_h, int sq_t, int sg_b, int sg_h, int sg_t, int causal,
                                     int round_p, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.valid = static_cast<const int*>(valid);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.T = T;
  a.sq = {sq_b, sq_h, sq_t};
  a.sg = {sg_b, sg_h, sg_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kDkv, a, Dh, causal, round_p, dtype);
}

// lse, delta [B, H, T] f32 in; dq out through the q strides.
extern "C" int tapclip_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                    const void* lse, const void* delta, const void* valid,
                                    void* dq, int B, int H, int T, int Dh, int sq_b, int sq_h,
                                    int sq_t, int sg_b, int sg_h, int sg_t, int causal, int dtype,
                                    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.valid = static_cast<const int*>(valid);
  a.dq = dq;
  a.B = B;
  a.H = H;
  a.T = T;
  a.sq = {sq_b, sq_h, sq_t};
  a.sg = {sg_b, sg_h, sg_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kDq, a, Dh, causal, 0, dtype);
}
