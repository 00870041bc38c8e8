// B4: backward of the fused attention half-block K2,
//   out = x + out_proj(softmax_masked(q k^T / sqrt(Dh)) v),  q, k, v = qkv_proj(LN(x)).
//
// Replaces tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel (the
// pallas_call in _attn_block_bwd_impl), its serial per-head schedule.  Like
// the TPU kernel it recomputes LN, the QKV projection and the probabilities
// from x; it never receives the forward's attention map.
//
// bfloat16 rounds where the TPU kernel rounds: y, the cotangent g, v and p
// for o, p and gh for dv, and o and dqkv on their way out; q and k for the
// scores, gh and v for dp, dp and ds stay f32, and LN statistics are f32
// everywhere.  So the QKV workspace holds v in f32 too (K2's kQkv epilogue
// rounds v, which the TPU forward does and its backward's dp does not), and
// the o product reads v's bf16 rounding as its one term.
//
// What bounds it on the card: the products.  dx alone takes the QKV
// recompute (2 R W 3W), gh = g . w_out^T (2 R W^2), dy = dqkv . w_qkv^T
// (2 R 3W W) and the attention core, 12 T^2 Dh a (batch row, head) over the
// valid keys: at the text shape (8 x 88 rows, W 512, 8 heads, valid 82)
// 2.96 GFLOP, 0.044 ms at the f32 FMA peak, 0.018 ms as the six bf16 MMAs a
// product f32 takes here.  Traces on an H100 80GB HBM3 at 700 W
// (profile_kernels.py), dx at the text shape in f32: the earlier design
// 0.475 ms of kernels (gh and dy on gemm.cu's FMA GEMM 225 us, the [T, T]
// FMA core, one block of 8 warps per (batch row, head), 180 us, the QKV
// product 60 us); this one 0.145 ms (QKV 31 us, gh 18, rows 33, cols 19,
// dy 32, the LayerNorm rows 4 + 7), 0.090 in bf16 (the rows kernel 31 of
// it: q, k, v and gh are f32 values in both dtypes, split into three terms
// in every walk).  At the image shape (8 x 200, W 768, 12 heads) 0.579 ms
// in f32, of which the three products 0.333 (time_half_blocks.py: launches
// 0.156 / 0.587 ms, f32 text / image).  The rows kernel recomputes the
// scores in each of its three walks and dp in two: six or seven products a
// key tile where four would do with the tiles kept in shared memory.
//
// Design: seven launches on the tensor cores behind one wrapper call
// (tapclip_tpu_torch/ops/fused_mha.py::_attn_block_bwd_cuda, which allocates
// the f32 workspace [qkv | gh | dy partials | mean | rstd | lse | delta] and
// the dtype scratch [y | dqkv | attn]):
//   1. LayerNorm rows (ln_rows.cuh): y = LN(x) rounded, mean and rstd.
//   2. qkv = y . w_qkv + b_qkv in f32, K1's GEMM (gemm_mma.cuh, kBias).
//   3. gh = g . w_out^T in f32 (w_out read as the [N, K] B operand, kStore).
//   4. rows (b4_rows_kernel): one block per (batch row, head, query tile)
//      walks the valid keys three times on flash_mma.cuh's m16n8k16
//      fragments: the row LSE of the scores; then o = p v (with weight
//      gradients wanted) and delta = sum(dp p), dp = gh v^T; then
//      dq = ds k with ds = p (dp - delta) scale.  It writes dq, and o, in the
//      dtype, and lse and delta in f32 for step 5.
//   5. cols (b4_cols_kernel): one block per (batch row, head, key tile)
//      walks the queries: s^T = k q^T, dp^T = v gh^T, p^T and ds^T from the
//      LSE and delta, dv += p^T gh and dk += ds^T q; writes dk, dv.
//   6. dy = dqkv . w_qkv^T (w_qkv as the [N, K] B operand, depth 3W), split
//      over the depth by gemm::depth_split (tapclip_attn_block_bwd_split).
//   7. dx = g + LN backward of dy (ln_rows.cuh's ln_bwd_rows_kernel, B5's,
//      summing the partials in order); with weight gradients also its
//      per-16-row partial column sums of dy * n and dy.
// The core's tiles are f32 (q, k, v, gh from the workspace), split into
// three bf16 terms, six MMAs a product, each 16-deep step summed from zero
// and added with a rounded f32 add (mma_split); where the TPU kernel rounds
// an operand to bf16 (p and v for o, p and gh for dv) the product takes one
// term, the operand's bf16 rounding.  The query and key tiles are 32 rows up
// to T 128 and 64 past (192 + 192 blocks at the text shape, 384 + 384 at the
// image shape, where the earlier core ran 64 and 96).  Past the T whose
// [T, T] tile B7's core holds (tapclip_attn_bwd_max_seq) the autograd
// Function differentiates the split composition, as the JAX _attn_block_bwd
// does; this kernel does not refuse longer T itself.
// Weight gradients (only with want_w; off the prompt-tuning path, where the
// CLIP weights are frozen): dW_qkv = y^T . dqkv, dW_out = o^T . g and the
// column sums, by gemm.cu in the wrapper.  No atomics: a call repeats bit for
// bit.  Emulated error of the split products: python -m
// tapclip_tpu_torch.scripts.split_error.
#include <stdint.h>

#include "attn_bwd_core.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::mma;
using gemm::Epi;

constexpr int kMaxSplit = 4;
static_assert(kMaxSplit <= kLnMaxSplits, "ln_bwd_rows_kernel sums every partial");

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
// gh for dv): its bf16 rounding in bf16, three terms in f32.
template <typename T>
constexpr int kRoundedTerms = kIsF32<T> ? kF32Terms : 1;

// One block per (batch row b, head h, ROWS-row query tile): dq (and o) of
// its rows, and their lse and delta.  q, k, v from the f32 qkv [B T, 3W], gh
// from the f32 [B T, W]; dq into dqkv [B T, 3W] and o into attn [B T, W]
// (null: no o) in T; lse, delta [B H, T] f32.
template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(2 * ROWS)
b4_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ gh, T* __restrict__ dqkv,
               T* __restrict__ attn, float* __restrict__ lse, float* __restrict__ delta, int H, int T_, int W,
               int valid) {
  constexpr int kThreads = 2 * ROWS;
  constexpr int kLd = tile_ld<float, DH>();
  constexpr int kKeys = walk_rows<DH>();
  constexpr int kPV = kRoundedTerms<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Q_s = reinterpret_cast<float*>(smem_raw);
  float* G_s = Q_s + ROWS * kLd;
  float* KV_s = G_s + ROWS * kLd;  // buffer i: K at KV_s + 2 i kKeys kLd, then V
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const float* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const float* k = q + W;
  const float* v = q + 2 * W;
  const float* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (valid + kKeys - 1) / kKeys;  // keys at or past valid add nothing
  const bool active = q0 + r0 < T_;                 // the warp holds a row below T

  load_tile<float, DH, ROWS, kThreads>(Q_s, q, st, q0, T_);
  load_tile<float, DH, ROWS, kThreads>(G_s, g, W, q0, T_);

  // body(K_s, V_s, first key) for each key tile, K and V double-buffered.
  auto walk = [&](auto&& body) {
    load_tile<float, DH, kKeys, kThreads>(KV_s, k, st, 0, T_);
    load_tile<float, DH, kKeys, kThreads>(KV_s + kKeys * kLd, v, st, 0, T_);
    cp_commit();
    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) {
        float* nxt = KV_s + ((j + 1) & 1) * 2 * kKeys * kLd;
        load_tile<float, DH, kKeys, kThreads>(nxt, k, st, (j + 1) * kKeys, T_);
        load_tile<float, DH, kKeys, kThreads>(nxt + kKeys * kLd, v, st, (j + 1) * kKeys, T_);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* K_s = KV_s + (j & 1) * 2 * kKeys * kLd;
      if (active) body(K_s, K_s + kKeys * kLd, j * kKeys);
      __syncthreads();  // this buffer is refilled with tile j + 2
    }
  };
  // p of the warp's [16, kKeys] scores s (log2 domain after scale_log2),
  // in place, from the rows' lse: 0 past valid.
  auto probs = [&](float (&s)[kKeys / 8][4], const float (&lse_r)[2], int kt0) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = key < valid ? exp2f(s[n][e] * scale_log2 - lse_r[e >> 1]) : 0.f;
      }
  };

  // 1. The row LSE (log2 domain): keys at or past valid at -1e30, past T -inf.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  walk([&](const float* K_s, const float*, int kt0) {
    float s[kKeys / 8][4], mt[2] = {-INFINITY, -INFINITY};
    warp_abt<float, DH, kKeys>(s, Q_s, r0, K_s, 0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
        s[n][e] = key >= T_ ? -INFINITY : (key < valid ? s[n][e] * scale_log2 : kNegBig);
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));  // finite: key 0 is valid
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

  // 2. delta = sum(dp p), dp = gh v^T in f32; o = p v with p and v in kPV terms.
  float o[DH / 8][4], dsum[2] = {0.f, 0.f};
  zero(o);
  const bool want_o = attn != nullptr;
  walk([&](const float* K_s, const float* V_s, int kt0) {
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    warp_abt<float, DH, kKeys>(s, Q_s, r0, K_s, 0);
    warp_abt<float, DH, kKeys>(dp, G_s, r0, V_s, 0);
    probs(s, lse_r, kt0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[n][e] * s[n][e];
    if (want_o) warp_pv<float, DH, kKeys, kPV, kPV>(o, s, V_s, 0);
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
  walk([&](const float* K_s, const float* V_s, int kt0) {
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    warp_abt<float, DH, kKeys>(s, Q_s, r0, K_s, 0);
    warp_abt<float, DH, kKeys>(dp, G_s, r0, V_s, 0);
    probs(s, lse_r, kt0);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - delta_r[e >> 1]) * scale;
    warp_pv<float, DH, kKeys, kF32Terms>(dq, dp, K_s, 0);
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
// keys over every query, from step 4's lse and delta.  dk, dv into dqkv in T.
template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(2 * ROWS)
b4_cols_kernel(const float* __restrict__ qkv, const float* __restrict__ gh, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dqkv, int H, int T_, int W, int valid) {
  constexpr int kThreads = 2 * ROWS;
  constexpr int kLd = tile_ld<float, DH>();
  constexpr int kQn = walk_rows<DH>();
  constexpr int kPV = kRoundedTerms<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* K_s = reinterpret_cast<float*>(smem_raw);
  float* V_s = K_s + ROWS * kLd;
  float* QG_s = V_s + ROWS * kLd;                       // buffer i: q at QG_s + 2 i kQn kLd, then gh
  float* LD_s = QG_s + 4 * kQn * kLd;                   // buffer i: lse, then delta
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const float* q = qkv + static_cast<size_t>(b) * T_ * st + h * DH;
  const float* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
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
    auto load_queries = [&](int i) {
      const int qt0 = i * kQn;
      float* Q_b = QG_s + (i & 1) * 2 * kQn * kLd;
      float* L_b = LD_s + (i & 1) * 2 * kQn;
      load_tile<float, DH, kQn, kThreads>(Q_b, q, st, qt0, T_);
      load_tile<float, DH, kQn, kThreads>(Q_b + kQn * kLd, g, W, qt0, T_);
      for (int r = threadIdx.x; r < kQn; r += kThreads) {
        const bool in = qt0 + r < T_;
        cp_async4(L_b + r, lse_bh + (in ? qt0 + r : 0), in);
        cp_async4(L_b + kQn + r, delta_bh + (in ? qt0 + r : 0), in);
      }
    };
    load_tile<float, DH, ROWS, kThreads>(K_s, q + W, st, k0, T_);
    load_tile<float, DH, ROWS, kThreads>(V_s, q + 2 * W, st, k0, T_);
    load_queries(0);
    cp_commit();
    for (int i = 0; i < n_q; ++i) {
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
        const float* Q_b = QG_s + (i & 1) * 2 * kQn * kLd;
        const float* G_b = Q_b + kQn * kLd;
        const float* L_b = LD_s + (i & 1) * 2 * kQn;
        float s[kQn / 8][4], dp[kQn / 8][4];
        warp_abt<float, DH, kQn>(s, K_s, r0, Q_b, 0);   // s^T = k q^T
        warp_abt<float, DH, kQn>(dp, V_s, r0, G_b, 0);  // dp^T = v gh^T
#pragma unroll
        for (int n = 0; n < kQn / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
            const int qi = 8 * n + 2 * (lane & 3) + (e & 1);
            const float p = qt0 + qi < T_ && key < valid ? exp2f(s[n][e] * scale_log2 - L_b[qi]) : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - L_b[kQn + qi]) * scale;
          }
        warp_pv<float, DH, kQn, kPV, kPV>(dv, s, G_b, 0);      // dv += p^T gh
        warp_pv<float, DH, kQn, kF32Terms>(dk, dp, Q_b, 0);    // dk += ds^T q
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

template <typename T, int DH, int ROWS>
cudaError_t launch_core(const float* qkv, const float* gh, T* dqkv, T* attn, float* lse, float* delta, int B,
                        int H, int T_, int W, int valid, cudaStream_t s) {
  constexpr int kLd = tile_ld<float, DH>();
  constexpr int kWalk = walk_rows<DH>();
  const dim3 grid(B * H, (T_ + ROWS - 1) / ROWS);
  auto rows = b4_rows_kernel<T, DH, ROWS>;
  const size_t rows_smem = (2 * ROWS + 4 * kWalk) * kLd * sizeof(float);
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<grid, 2 * ROWS, rows_smem, s>>>(qkv, gh, dqkv, attn, lse, delta, H, T_, W, valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto cols = b4_cols_kernel<T, DH, ROWS>;
  const size_t cols_smem = (2 * ROWS + 4 * kWalk) * kLd * sizeof(float) + 4 * kWalk * sizeof(float);
  err = allow_smem(cols, cols_smem);
  if (err != cudaSuccess) return err;
  cols<<<grid, 2 * ROWS, cols_smem, s>>>(qkv, gh, lse, delta, dqkv, H, T_, W, valid);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_core_rows(const float* qkv, const float* gh, T* dqkv, T* attn, float* lse, float* delta,
                             int B, int H, int T_, int W, int valid, cudaStream_t s) {
  if (tile_rows(T_) == 32) return launch_core<T, DH, 32>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
  return launch_core<T, DH, 64>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
}

template <typename T>
cudaError_t launch_core_dh(const float* qkv, const float* gh, T* dqkv, T* attn, float* lse, float* delta, int B,
                           int H, int T_, int W, int valid, cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core_rows<T, 16>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 32: return launch_core_rows<T, 32>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 64: return launch_core_rows<T, 64>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    case 128: return launch_core_rows<T, 128>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int CE>
cudaError_t launch_bwd(const T* x, const T* g, const float* gamma, const float* beta, const T* w_qkv,
                       const float* b_qkv, const T* w_out, T* dx, float* ws, T* wsd, float* part, int B, int T_,
                       int W, int H, int valid, float eps, int S, int want_w, cudaStream_t s) {
  const size_t R = static_cast<size_t>(B) * T_;
  float* qkv = ws;                  // [R, 3W]
  float* gh = qkv + R * 3 * W;      // [R, W]
  float* dy = gh + R * W;           // [S, R, W]
  float* mean = dy + S * R * W;     // [R]
  float* rstd = mean + R;           // [R]
  float* lse = rstd + R;            // [B H, T]
  float* delta = lse + R * H;       // [B H, T]
  T* y = wsd;                       // [R, W]
  T* dqkv = y + R * W;              // [R, 3W]
  T* attn = want_w ? dqkv + R * 3 * W : nullptr;  // [R, W]
  const int M = static_cast<int>(R);
  ln_rows_kernel<T><<<(M + kLnWarps - 1) / kLnWarps, kLnThreads, 0, s>>>(x, gamma, beta, y, mean, rstd, M, W,
                                                                          eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kBias, false, float>(
      y, w_qkv, Epi<T>{b_qkv, nullptr, nullptr, nullptr, 0}, qkv, M, 3 * W, W, s);
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 64, CE, gemm::kStore, true, float>(g, w_out, Epi<T>{}, gh, M, W, W, s);
  if (err != cudaSuccess) return err;
  err = launch_core_dh<T>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, W, valid, s);
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 64, CE, gemm::kStore, true, float>(dqkv, w_qkv, Epi<T>{}, dy, M, W, 3 * W, s, S);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<T><<<(M + kLnBwdRows - 1) / kLnBwdRows, kLnBwdThreads, 0, s>>>(
      x, g, dy, S, R * W, gamma, mean, rstd, dx, part, M, W, want_w);
  return cudaGetLastError();
}

}  // namespace

// Largest sequence length the [T, T]-tile backward core of B7 (and the
// routing of B4's autograd Function) holds at head dim Dh (its [T, T] f32
// tile and one [T, Dh] operand tile in shared memory, at most 32 x 8 keys per
// row), 0 for an unsupported head dim.
extern "C" int tapclip_attn_bwd_max_seq(int Dh) { return bwd_core_max_seq(Dh); }

// The split S of dy's depth that tapclip_attn_block_bwd takes at R rows,
// width W and dtype (0 float32, 1 bfloat16; the wrapper sizes the workspace
// with it).
extern "C" int tapclip_attn_block_bwd_split(int R, int W, int dtype) {
  if (R <= 0 || W <= 0) return 0;
  return gemm::depth_split(R, W, 3 * W, dtype, kMaxSplit);
}

// B4.  dtype: 0 float32, 1 bfloat16.  Head dim W / n_heads in {16, 32, 64,
// 128}; valid in [1, T]; split S in 1..4 (tapclip_attn_block_bwd_split's
// choice, or another); ws an f32 workspace of R (4W + S W + 2 + 2 n_heads)
// floats and wsd a scratch of R (4W + W want_w) elements of the dtype
// (R = B T): y at wsd, dqkv at wsd + R W and, with want_w, o at wsd + 4 R W
// (the operands of the weight gradients), and part [ceil(R / 16), 2W] f32 the
// partial column sums of dy * n and dy; without want_w, part is not touched
// (may be null).  x, g, w_qkv, w_out, ws and wsd 16-byte aligned in float32,
// 8-byte in bfloat16.
extern "C" int tapclip_attn_block_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                                      const void* w_qkv, const void* b_qkv, const void* w_out, void* dx, void* ws,
                                      void* wsd, void* part, int B, int T, int W, int n_heads, int valid, float eps,
                                      int split, int want_w, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || W % 4 || valid < 1 || valid > T || split < 1 ||
      split > kMaxSplit)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(w_qkv) | reinterpret_cast<uintptr_t>(w_out) |
                         reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(wsd);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bq = static_cast<const float*>(b_qkv);
  auto* w32 = static_cast<float*>(ws);
  auto* pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ptrs & 15) return cudaErrorMisalignedAddress;
    return launch_bwd<float, 4>(static_cast<const float*>(x), static_cast<const float*>(g), gm, bt,
                                static_cast<const float*>(w_qkv), bq, static_cast<const float*>(w_out),
                                static_cast<float*>(dx), w32, static_cast<float*>(wsd), pt, B, T, W, n_heads, valid,
                                eps, split, want_w, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (ptrs & 7) return cudaErrorMisalignedAddress;
    const auto* X = static_cast<const bf16*>(x);
    const auto* G = static_cast<const bf16*>(g);
    const auto* Wq = static_cast<const bf16*>(w_qkv);
    const auto* Wo = static_cast<const bf16*>(w_out);
    auto* D = static_cast<bf16*>(dx);
    auto* Wd = static_cast<bf16*>(wsd);
    if ((ptrs & 15) == 0 && W % 8 == 0)
      return launch_bwd<bf16, 8>(X, G, gm, bt, Wq, bq, Wo, D, w32, Wd, pt, B, T, W, n_heads, valid, eps, split,
                                 want_w, s);
    return launch_bwd<bf16, 4>(X, G, gm, bt, Wq, bq, Wo, D, w32, Wd, pt, B, T, W, n_heads, valid, eps, split,
                               want_w, s);
  }
  return cudaErrorInvalidValue;
}
