// The attention core's backward on the tensor cores, shared by B4 (the
// attention half-block's backward, attn_block_bwd.cu, step 4 and 5 of its
// chain) and B7 (the packed-QKV core's backward, mha_bwd.cu): per head,
//   s = q k^T * scale log2 e (keys >= valid, and keys > query when causal:
//   masked), p = exp2(s - lse),
//   [o = p v,]  dv = p^T g,  dp = g v^T,  ds = p (dp - sum(dp p)) scale,
//   dq = ds k,  dk = ds^T q,
// with q, k, v read straight from packed [B T, 3W] rows (row stride 3W) at
// their head's column offset and g from [B T, W], and dq, dk, dv written
// straight into their column blocks of the packed [B T, 3W] gradient.
//
// Two launches on flash_mma.cuh's m16n8k16 fragments:
//   rows_kernel, one block per (batch row, head, ROWS-row query tile),
//     walks the key tiles three times: the row LSE of the scores; then
//     delta = sum(dp p) (and o = p v where asked); then dq.  Causal, the
//     walk stops at the tile that holds the query tile's last row and masks
//     inside it.  It writes dq (and o) in T, and lse and delta in f32 for
//   cols_kernel, one block per (batch row, head, ROWS-row key tile), which
//     walks the query tiles (causal: from the one that holds its first key):
//     s^T = k q^T, dp^T = v g^T, p^T and ds^T from the LSE and delta,
//     dv += p^T g, dk += ds^T q; writes dk, dv.
// The block's own tiles are 32 rows up to T 128 and 64 past; the walked
// tiles 64 rows at head dims 16 and 32, 32 at 64 and 128 (64 spilled 1,256
// bytes a thread in the f32 column kernel at head dim 64).
//
// Template arguments: T, the dtype of the outputs and of the TPU kernel's
// roundings; In, the type of q, k, v and g in memory (B4: f32, its
// workspace; B7: T, the saved qkv and the cotangent); CAUSAL; WITH_O (B4,
// where it runs for the weight gradients: o = p v into attn).  An In operand
// takes three bf16 terms when it is f32 and one (exact) when it is bf16;
// where the TPU kernel rounds an operand to T (p and v for o, p and g for
// dv) the product takes its bf16 rounding as its one term in bf16; ds is
// f32 and takes three terms.  Each 16-deep step of a product of two split
// operands is summed from zero and added with a rounded f32 add
// (mma_split).  No atomics: a call repeats bit for bit.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

// Kernels in a header sit in a named namespace: nvcc's host stub cannot name
// a kernel in an anonymous namespace nested in a named one.
namespace tapclip {
namespace attn_bwd {

using namespace tapclip::mma;

// Rows (queries or keys) of a block's own tile: 32 up to T 128, 64 past.
inline int tile_rows(int T) { return T <= 128 ? 32 : 64; }

// Rows of a walked tile: 64 at head dims 16 and 32, 32 at 64 and 128, where
// the walk's [16, walk] score and dp tiles beside the [16, Dh] accumulators
// spilled with 64 (1,256 bytes a thread in the f32 dk/dv kernel at Dh 64).
template <int DH>
__host__ __device__ constexpr int walk_rows() {
  return DH >= 64 ? 32 : 64;
}

// The terms of an operand the TPU kernel rounds to T (p and v for o, p and
// g for dv): its bf16 rounding in bf16, three terms in f32.
template <typename T>
constexpr int kRoundedTerms = kIsF32<T> ? kF32Terms : 1;

// One block per (batch row b, head h, ROWS-row query tile): dq (and o) of
// its rows, and their lse and delta.  q, k, v from qkv [B T, 3W], g from
// gh [B T, W], both In; dq into dqkv [B T, 3W] and o into attn [B T, W]
// (null: no o) in T; lse, delta [B H, T] f32.
template <typename T, typename In, int DH, int ROWS, bool CAUSAL, bool WITH_O>
__global__ void __launch_bounds__(2 * ROWS)
rows_kernel(const In* __restrict__ qkv, const In* __restrict__ gh, T* __restrict__ dqkv, T* __restrict__ attn,
            float* __restrict__ lse, float* __restrict__ delta, int H, int T_, int W, int valid) {
  static_assert(!WITH_O || kIsF32<In>, "o is B4's, from its f32 workspace");
  constexpr int kThreads = 2 * ROWS;
  constexpr int kLd = tile_ld<In, DH>();
  constexpr int kKeys = walk_rows<DH>();
  constexpr int kPV = kRoundedTerms<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* Q_s = reinterpret_cast<In*>(smem_raw);
  In* G_s = Q_s + ROWS * kLd;
  In* KV_s = G_s + ROWS * kLd;  // buffer i: K at KV_s + 2 i kKeys kLd, then V
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const In* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const In* k = q + W;
  const In* v = q + 2 * W;
  const In* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  // Keys at or past valid add nothing, and causal, keys past the tile's last row.
  const int key_end = CAUSAL ? min(valid, q0 + ROWS) : valid;
  const int n_tiles = (key_end + kKeys - 1) / kKeys;
  const bool active = q0 + r0 < T_;  // the warp holds a row below T

  load_tile<In, DH, ROWS, kThreads>(Q_s, q, st, q0, T_);
  load_tile<In, DH, ROWS, kThreads>(G_s, g, W, q0, T_);

  // body(K_s, V_s, first key) for each key tile, K and V double-buffered.
  auto walk = [&](auto&& body) {
    load_tile<In, DH, kKeys, kThreads>(KV_s, k, st, 0, T_);
    load_tile<In, DH, kKeys, kThreads>(KV_s + kKeys * kLd, v, st, 0, T_);
    cp_commit();
    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) {
        In* nxt = KV_s + ((j + 1) & 1) * 2 * kKeys * kLd;
        load_tile<In, DH, kKeys, kThreads>(nxt, k, st, (j + 1) * kKeys, T_);
        load_tile<In, DH, kKeys, kThreads>(nxt + kKeys * kLd, v, st, (j + 1) * kKeys, T_);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const In* K_s = KV_s + (j & 1) * 2 * kKeys * kLd;
      if (active) body(K_s, K_s + kKeys * kLd, j * kKeys);
      __syncthreads();  // this buffer is refilled with tile j + 2
    }
  };
  // Whether key `key` is visible to the row of accumulator element e.
  auto visible = [&](int key, int e) {
    if constexpr (CAUSAL) {
      return key < valid && key <= q0 + r0 + (lane >> 2) + 8 * (e >> 1);
    } else {
      return key < valid;
    }
  };
  // p of the warp's [16, kKeys] scores s (log2 domain after scale_log2),
  // in place, from the rows' lse: 0 where the key is masked.
  auto probs = [&](float (&s)[kKeys / 8][4], const float (&lse_r)[2], int kt0) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = visible(key, e) ? exp2f(s[n][e] * scale_log2 - lse_r[e >> 1]) : 0.f;
      }
  };

  // 1. The row LSE (log2 domain): masked keys at -1e30, keys past T -inf.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  walk([&](const In* K_s, const In*, int kt0) {
    float s[kKeys / 8][4], mt[2] = {-INFINITY, -INFINITY};
    warp_abt<In, DH, kKeys>(s, Q_s, r0, K_s, 0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = key >= T_ ? -INFINITY : (visible(key, e) ? s[n][e] * scale_log2 : kNegBig);
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));  // finite: key 0 is visible to every row
      l[r] *= exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
  });
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = m[r] + log2f(quad_sum(l[r]));

  // 2. delta = sum(dp p), dp = g v^T in f32; o = p v with p and v in kPV terms.
  float o[DH / 8][4], dsum[2] = {0.f, 0.f};
  zero(o);
  const bool want_o = WITH_O && attn != nullptr;
  walk([&](const In* K_s, const In* V_s, int kt0) {
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    warp_abt<In, DH, kKeys>(s, Q_s, r0, K_s, 0);
    warp_abt<In, DH, kKeys>(dp, G_s, r0, V_s, 0);
    probs(s, lse_r, kt0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[n][e] * s[n][e];
    if constexpr (WITH_O) {
      if (want_o) warp_pv<float, DH, kKeys, kPV, kPV>(o, s, V_s, 0);
    }
  });
  float delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) delta_r[r] = quad_sum(dsum[r]);
  const float one[2] = {1.f, 1.f};
  const size_t row0 = static_cast<size_t>(b) * T_;
  if (want_o && active) store_rows<T, DH>(attn + row0 * W + h * DH, W, q0 + r0, T_, o, one);  // o is done

  // 3. dq = ds k, ds = p (dp - delta) scale in f32.
  float dq[DH / 8][4];
  zero(dq);
  walk([&](const In* K_s, const In* V_s, int kt0) {
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    warp_abt<In, DH, kKeys>(s, Q_s, r0, K_s, 0);
    warp_abt<In, DH, kKeys>(dp, G_s, r0, V_s, 0);
    probs(s, lse_r, kt0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - delta_r[e >> 1]) * scale;
    warp_pv<In, DH, kKeys, kF32Terms>(dq, dp, K_s, 0);
  });
  if (!active) return;
  store_rows<T, DH>(dqkv + row0 * st + h * DH, st, q0 + r0, T_, dq, one);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + (lane >> 2) + 8 * r;
      if (row >= T_) continue;
      const size_t off = static_cast<size_t>(blockIdx.x) * T_ + row;
      lse[off] = lse_r[r];
      delta[off] = delta_r[r];
    }
  }
}

// One block per (batch row b, head h, ROWS-row key tile): dk and dv of its
// keys over every query that sees them, from rows_kernel's lse and delta.
// dk, dv into dqkv in T.
template <typename T, typename In, int DH, int ROWS, bool CAUSAL>
__global__ void __launch_bounds__(2 * ROWS)
cols_kernel(const In* __restrict__ qkv, const In* __restrict__ gh, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dqkv, int H, int T_, int W, int valid) {
  constexpr int kThreads = 2 * ROWS;
  constexpr int kLd = tile_ld<In, DH>();
  constexpr int kQn = walk_rows<DH>();
  constexpr int kPV = kRoundedTerms<T>;
  constexpr int kGT = kIsF32<In> ? kPV : 1;  // g's terms in dv: a bf16 g is exact
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* K_s = reinterpret_cast<In*>(smem_raw);
  In* V_s = K_s + ROWS * kLd;
  In* QG_s = V_s + ROWS * kLd;                                 // buffer i: q at QG_s + 2 i kQn kLd, then g
  float* LD_s = reinterpret_cast<float*>(QG_s + 4 * kQn * kLd);  // buffer i: lse, then delta
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const In* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const In* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
  const float* lse_bh = lse + static_cast<size_t>(blockIdx.x) * T_;
  const float* delta_bh = delta + static_cast<size_t>(blockIdx.x) * T_;
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  const bool active = k0 + r0 < T_ && k0 + r0 < valid;  // the warp holds a valid key

  float dk[DH / 8][4], dv[DH / 8][4];
  zero(dk);
  zero(dv);
  if (k0 < valid) {  // a key tile wholly at or past valid has zero gradients
    const int n_q = (T_ + kQn - 1) / kQn;
    const int i0 = CAUSAL ? k0 / kQn : 0;  // causal: no query before the tile's first key sees it
    auto load_queries = [&](int i) {
      const int qt0 = i * kQn;
      In* Q_b = QG_s + (i & 1) * 2 * kQn * kLd;
      float* L_b = LD_s + (i & 1) * 2 * kQn;
      load_tile<In, DH, kQn, kThreads>(Q_b, q, st, qt0, T_);
      load_tile<In, DH, kQn, kThreads>(Q_b + kQn * kLd, g, W, qt0, T_);
      for (int r = threadIdx.x; r < kQn; r += kThreads) {
        const bool in = qt0 + r < T_;
        cp_async4(L_b + r, lse_bh + (in ? qt0 + r : 0), in);
        cp_async4(L_b + kQn + r, delta_bh + (in ? qt0 + r : 0), in);
      }
    };
    load_tile<In, DH, ROWS, kThreads>(K_s, q + W, st, k0, T_);
    load_tile<In, DH, ROWS, kThreads>(V_s, q + 2 * W, st, k0, T_);
    load_queries(i0);
    cp_commit();
    for (int i = i0; i < n_q; ++i) {
      if (i + 1 < n_q) {
        load_queries(i + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (active) {
        const int qt0 = i * kQn;
        const In* Q_b = QG_s + (i & 1) * 2 * kQn * kLd;
        const In* G_b = Q_b + kQn * kLd;
        const float* L_b = LD_s + (i & 1) * 2 * kQn;
        float s[kQn / 8][4], dp[kQn / 8][4];
        warp_abt<In, DH, kQn>(s, K_s, r0, Q_b, 0);   // s^T = k q^T
        warp_abt<In, DH, kQn>(dp, V_s, r0, G_b, 0);  // dp^T = v g^T
#pragma unroll
        for (int n = 0; n < kQn / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
            const int qi = 8 * n + 2 * (lane & 3) + (e & 1);
            bool vis = qt0 + qi < T_ && key < valid;
            if constexpr (CAUSAL) vis = vis && qt0 + qi >= key;
            const float p = vis ? exp2f(s[n][e] * scale_log2 - L_b[qi]) : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - L_b[kQn + qi]) * scale;
          }
        warp_pv<In, DH, kQn, kPV, kGT>(dv, s, G_b, 0);      // dv += p^T g
        warp_pv<In, DH, kQn, kF32Terms>(dk, dp, Q_b, 0);    // dk += ds^T q
      }
      __syncthreads();  // this buffer is refilled with query tile i + 2
    }
  }
  if (k0 + r0 >= T_) return;
  const float one[2] = {1.f, 1.f};
  T* base = dqkv + static_cast<size_t>(b) * T_ * st + h * DH;
  store_rows<T, DH>(base + W, st, k0 + r0, T_, dk, one);
  store_rows<T, DH>(base + 2 * W, st, k0 + r0, T_, dv, one);
}

template <typename T, typename In, int DH, int ROWS, bool CAUSAL, bool WITH_O>
cudaError_t launch_core(const In* qkv, const In* gh, T* dqkv, T* attn, float* lse, float* delta, int B, int H,
                        int T_, int W, int valid, cudaStream_t s) {
  constexpr int kLd = tile_ld<In, DH>();
  constexpr int kWalk = walk_rows<DH>();
  const dim3 grid(B * H, (T_ + ROWS - 1) / ROWS);
  auto rows = rows_kernel<T, In, DH, ROWS, CAUSAL, WITH_O>;
  const size_t rows_smem = (2 * ROWS + 4 * kWalk) * kLd * sizeof(In);
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<grid, 2 * ROWS, rows_smem, s>>>(qkv, gh, dqkv, attn, lse, delta, H, T_, W, valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto cols = cols_kernel<T, In, DH, ROWS, CAUSAL>;
  const size_t cols_smem = (2 * ROWS + 4 * kWalk) * kLd * sizeof(In) + 4 * kWalk * sizeof(float);
  err = allow_smem(cols, cols_smem);
  if (err != cudaSuccess) return err;
  cols<<<grid, 2 * ROWS, cols_smem, s>>>(qkv, gh, lse, delta, dqkv, H, T_, W, valid);
  return cudaGetLastError();
}

template <typename T, typename In, int DH, bool CAUSAL, bool WITH_O>
cudaError_t launch_core_rows(const In* qkv, const In* gh, T* dqkv, T* attn, float* lse, float* delta, int B,
                             int H, int T_, int W, int valid, cudaStream_t s) {
  if (tile_rows(T_) == 32)
    return launch_core<T, In, DH, 32, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
  return launch_core<T, In, DH, 64, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
}

template <typename T, typename In, bool CAUSAL, bool WITH_O>
cudaError_t launch_core_dh(const In* qkv, const In* gh, T* dqkv, T* attn, float* lse, float* delta, int B, int H,
                           int T_, int W, int valid, cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core_rows<T, In, 16, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 32: return launch_core_rows<T, In, 32, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 64: return launch_core_rows<T, In, 64, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 128:
      return launch_core_rows<T, In, 128, CAUSAL, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

// The two launches over qkv [B T, 3W] and gh [B T, W] of In into dqkv [B T,
// 3W] (and, with WITH_O and attn not null, o into attn [B T, W]) of T; lse
// and delta [B H, T] f32 scratch.  Head dim W / H in {16, 32, 64, 128}.
template <typename T, typename In, bool WITH_O>
cudaError_t launch_attn_bwd(const In* qkv, const In* gh, T* dqkv, T* attn, float* lse, float* delta, int B, int H,
                            int T_, int W, int valid, bool causal, cudaStream_t s) {
  if (causal) return launch_core_dh<T, In, true, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
  return launch_core_dh<T, In, false, WITH_O>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
}

}  // namespace attn_bwd
}  // namespace tapclip
