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
// image shape, where the earlier core ran 64 and 96).  Past the routing
// limit tapclip_attn_bwd_max_seq the autograd Function differentiates the
// split composition, as the JAX _attn_block_bwd does; this kernel does not
// refuse longer T itself.
// Weight gradients (only with want_w; off the prompt-tuning path, where the
// CLIP weights are frozen): dW_qkv = y^T . dqkv, dW_out = o^T . g on
// gemm.cu's tensor-core A^T . B products and the column sums, launched by
// the wrapper.  No atomics: a call repeats bit for
// bit.  Emulated error of the split products: python -m
// tapclip_tpu_torch.scripts.split_error.
// Partial mode, for Megatron tensor parallelism
// (tapclip_attn_block_bwd_partial, then mlp_bwd.cu's tapclip_ln_bwd): the
// rank holds its heads' q, k and v columns (w_qkv [W, 3 Wl], b_qkv [3 Wl],
// laid out [q_j | k_j | v_j]) and w_out's matching rows ([Wl, W]).  Launches
// 1-6 run on them (the LayerNorm over the whole width, qkv [R, 3 Wl], gh =
// g . w_out^T [R, Wl], the attention core over the local heads, dy =
// dqkv . w_qkv^T [S, R, W]), leaving dy as this rank's partial sum over its
// heads.  The caller sums dy's S depth partials in order into one [R, W],
// all-reduces it over the model group (Megatron's identity-forward /
// all-reduce-backward operator, between launch 6 and 7) and launches the
// LayerNorm backward (split 1) on the whole dy: dx = g + LN backward,
// the residual's g added once, dgamma / dbeta complete on every rank.  The
// local weight gradients (dW_qkv, db_qkv, dW_out) are exact; db_out is
// complete on every rank and is not summed over the model group.
#include <stdint.h>

#include "attn_bwd_mma.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using gemm::Epi;

constexpr int kMaxSplit = 4;
static_assert(kMaxSplit <= kLnMaxSplits, "ln_bwd_rows_kernel sums every partial");

// Launches 1-6 over Wl of the heads' width (W, or a rank's Wl in the
// partial mode); dy's S partials, mean and rstd left in ws.
template <typename T, int CE>
cudaError_t launch_front(const T* x, const T* g, const float* gamma, const float* beta, const T* w_qkv,
                         const float* b_qkv, const T* w_out, float* ws, T* wsd, int B, int T_, int W, int Wl, int H,
                         int valid, float eps, int S, int want_w, cudaStream_t s) {
  const size_t R = static_cast<size_t>(B) * T_;
  float* qkv = ws;                  // [R, 3Wl]
  float* gh = qkv + R * 3 * Wl;     // [R, Wl]
  float* dy = gh + R * Wl;          // [S, R, W]
  float* mean = dy + S * R * W;     // [R]
  float* rstd = mean + R;           // [R]
  float* lse = rstd + R;            // [B H, T]
  float* delta = lse + R * H;       // [B H, T]
  T* y = wsd;                       // [R, W]
  T* dqkv = y + R * W;              // [R, 3Wl]
  T* attn = want_w ? dqkv + R * 3 * Wl : nullptr;  // [R, Wl]
  const int M = static_cast<int>(R);
  ln_rows_kernel<T><<<(M + kLnWarps - 1) / kLnWarps, kLnThreads, 0, s>>>(x, gamma, beta, y, mean, rstd, M, W,
                                                                          eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kBias, false, float>(
      y, w_qkv, Epi<T>{b_qkv, nullptr, nullptr, nullptr, 0}, qkv, M, 3 * Wl, W, s);
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 64, CE, gemm::kStore, true, float>(g, w_out, Epi<T>{}, gh, M, Wl, W, s);
  if (err != cudaSuccess) return err;
  err = attn_bwd::launch_core_dh<T, float, false, true>(qkv, gh, dqkv, attn, lse, delta, B, H, T_, Wl, valid, s);
  if (err != cudaSuccess) return err;
  return gemm::launch_pass<T, 64, CE, gemm::kStore, true, float>(dqkv, w_qkv, Epi<T>{}, dy, M, W, 3 * Wl, s, S);
}

template <typename T, int CE>
cudaError_t launch_bwd(const T* x, const T* g, const float* gamma, const float* beta, const T* w_qkv,
                       const float* b_qkv, const T* w_out, T* dx, float* ws, T* wsd, float* part, int B, int T_,
                       int W, int H, int valid, float eps, int S, int want_w, cudaStream_t s) {
  cudaError_t err = launch_front<T, CE>(x, g, gamma, beta, w_qkv, b_qkv, w_out, ws, wsd, B, T_, W, W, H, valid, eps,
                                        S, want_w, s);
  if (err != cudaSuccess) return err;
  const size_t R = static_cast<size_t>(B) * T_;
  const int M = static_cast<int>(R);
  const float* dy = ws + R * 4 * W;
  const float* mean = dy + S * R * W;
  ln_bwd_rows_kernel<T><<<(M + kLnBwdRows - 1) / kLnBwdRows, kLnBwdThreads, 0, s>>>(
      x, g, dy, S, R * W, gamma, mean, mean + R, dx, part, M, W, want_w);
  return cudaGetLastError();
}

}  // namespace

// The routing limit of B4's autograd Function (ops/fused_mha.py::_tile_fits)
// at head dim Dh, 0 for an unsupported head dim: past it the Function
// differentiates the split composition.  It is the longest T whose [T, T]
// f32 tile and one [T, Dh + 1] f32 operand tile fit in 227 KB of shared
// memory (at most 256), the limit of the one-block FMA core B4 ran before
// its row and column kernels (attn_bwd_mma.cuh), which take any T: now only
// a routing limit.
extern "C" int tapclip_attn_bwd_max_seq(int Dh) {
  if (Dh != 16 && Dh != 32 && Dh != 64 && Dh != 128) return 0;
  const auto bytes = [Dh](size_t t) { return (t * t + t * (Dh + 1)) * sizeof(float); };
  int t = 0;
  while (t < 256 && bytes(t + 1) <= 227 * 1024) ++t;
  return t;
}

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

// B4's partial mode, launches 1-6 (see the note at the top): n_heads the
// rank's heads, Wl their width; ws the f32 workspace [qkv (3 Wl) | gh (Wl) |
// dy partials (S W) | mean | rstd | lse | delta] per row, wsd [y (W) | dqkv
// (3 Wl) | attn (Wl) with want_w] per row.  tapclip_ln_bwd ends it.
extern "C" int tapclip_attn_block_bwd_partial(const void* x, const void* g, const void* gamma, const void* beta,
                                              const void* w_qkv, const void* b_qkv, const void* w_out, void* ws,
                                              void* wsd, int B, int T, int W, int Wl, int n_heads, int valid,
                                              float eps, int split, int want_w, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || Wl % n_heads || W % 4 || Wl % 4 || Wl > W || valid < 1 || valid > T ||
      split < 1 || split > kMaxSplit)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(w_qkv) | reinterpret_cast<uintptr_t>(w_out) |
                         reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(wsd);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bq = static_cast<const float*>(b_qkv);
  auto* w32 = static_cast<float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ptrs & 15) return cudaErrorMisalignedAddress;
    return launch_front<float, 4>(static_cast<const float*>(x), static_cast<const float*>(g), gm, bt,
                                  static_cast<const float*>(w_qkv), bq, static_cast<const float*>(w_out), w32,
                                  static_cast<float*>(wsd), B, T, W, Wl, n_heads, valid, eps, split, want_w, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (ptrs & 7) return cudaErrorMisalignedAddress;
    const auto* X = static_cast<const bf16*>(x);
    const auto* G = static_cast<const bf16*>(g);
    const auto* Wq = static_cast<const bf16*>(w_qkv);
    const auto* Wo = static_cast<const bf16*>(w_out);
    auto* Wd = static_cast<bf16*>(wsd);
    if ((ptrs & 15) == 0 && W % 8 == 0 && Wl % 8 == 0)
      return launch_front<bf16, 8>(X, G, gm, bt, Wq, bq, Wo, w32, Wd, B, T, W, Wl, n_heads, valid, eps, split, want_w,
                                   s);
    return launch_front<bf16, 4>(X, G, gm, bt, Wq, bq, Wo, w32, Wd, B, T, W, Wl, n_heads, valid, eps, split, want_w,
                                 s);
  }
  return cudaErrorInvalidValue;
}
