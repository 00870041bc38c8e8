// B14: int8 W8A8 attention half-block of the frozen-tower eval path,
//   out = x + dequant(int8(attn(dequant(int8(LN(x)) . Wqkv_q) + b_qkv)) . Wout_q) + b_out,
// keys at or past `valid` masked, never causal.
//
// Replaces tapclip_tpu/ops/int8_attn.py::_int8_attn_kernel (the pallas_call
// in int8_attn_block) and the round-to-nearest model
// _xla_int8_attn_reference (int8_deterministic): the wrapper
// (tapclip_tpu_torch/ops/int8_attn.py::int8_attn_cuda) makes the same five
// launches in both modes and counts one B14 a call.  Quantization scheme and
// random bits: int8_common.cuh.
//
// Design: five launches on the tensor cores behind one wrapper call, which
// lays the weights out K-major ([N, Kp], Kp = W rounded up to 64; S6's
// transpose kernel) where it quantizes them, and allocates the scratch: the
// f32 workspace qkv [R, 3W], the f32 attention output a [R, W] (the TPU
// kernel's f32 attn_s scratch), codes [R, Kp] int8 (LN's, then a's) and
// scales [3, R] f32 (t1, t2, the rows' |a| max).  Each launch is code B13
// or K2 already runs:
//   1. int8_tiles.cuh's ln_quant_kernel (B13's), one warp a row: LayerNorm
//      (f32 in the stochastic mode, rounded to the dtype in the
//      round-to-nearest one), the codes of quantizer kStreamAttnY and t1;
//      zeroes the rows' |a| max.
//   2. dequant_kernel<kQkv> on int8_mma.cuh's block tile: codes . Wqkv^T
//      (mma.sync m16n8k32 s8, exact int32 sums), dequantized (acc t1) s_qkv
//      + b_qkv into the f32 workspace; in the stochastic mode the v third
//      rounded to the dtype, as the TPU kernel's `.astype(x.dtype)`
//      (int8_attn.py:122).  No draw depends on the tiling, so the workspace
//      equals the earlier __dp4a kernel's bit for bit.
//   3. attn_core_mma.cuh's attention (K2's), one block per (batch row,
//      head, query tile): q . k^T on three bf16 terms of q and k, an online
//      exp2 softmax, p . v on three terms of p and v, or one where the TPU
//      kernel rounds p to bf16 (the stochastic mode in bf16: v is then a
//      bf16 value); the round-to-nearest model attends in f32 throughout.
//      Its epilogue stores a in f32 and folds each row's |a| into the row's
//      max by atomicMax on the non-negative f32 bits (B13's fc trick), so
//      the row's max over every head is exact and order-free.
//   4. quant_rows_kernel (B13's), one block a row: the codes of a
//      (quantizer kStreamAttnA) and t2 from that max.
//   5. proj_kernel (B13's proj): codes . Wout^T on the same tile,
//      dequantized, + b_out + x with one rounding to the dtype.
// No other atomics: a call repeats bit for bit.
//
// What bounds it on the card: by its shape, neither bytes nor operations.
// At ViT-B/16 serving (8 x 200 rows, W 768, 12 heads, valid 197) the two
// products are 8 R W^2 = 7.5 G int8 operations (0.004 ms at 1,979 TOP/s) and
// the attention 4 W a (query, valid key) pair = 0.97 GFLOP (0.014 ms at the
// f32 FMA peak; 0.006 ms as the bf16 MMAs run here, six a product, seven
// for the two in the stochastic mode in bf16); the f32 workspace's round
// trip is 15 MB (0.005 ms).  Traces on an H100 80GB HBM3 at 700 W
// (profile_kernels.py), f32 stochastic at that shape: the earlier design,
// three launches (both products with __dp4a, 8 rows a block, each block
// reading the weights from L2; the attention on the FMA units), took 0.288
// ms (QKV 143 us, attention 72, out 63).  This one 0.135 ms: LayerNorm and
// codes 13 us, QKV 24 (450 tiles of 64 x 128), attention 72 (46 in the
// stochastic mode in bf16), the codes 5, out 16 (150 tiles), plus 6 for the
// wrapper's two weight transposes (time_half_blocks.py: launches alone
// 0.135 ms, 0.109 in bf16).  The attention leads: q and k are f32 values,
// split into three bf16 terms for every key tile.
//
// The partial mode (tensor parallelism over a `model` group of n ranks; the
// wrapper ops/int8_attn.py::int8_attn_block(tp_group=) runs the collectives
// between the entries).  Rank r holds the qkv columns of heads [r H/n, (r+1)
// H/n) (parallel/sharding.py's per-head cut, [q_r | k_r | v_r]), the same
// rows of w_out, and w_out's per-column scales of the whole weight:
//   tapclip_int8_attn_front     launches 1-3 on the rank's heads: the
//                               LayerNorm rows and their codes (replicated),
//                               the QKV product on its 3 W/n columns (v
//                               rounded column by column, so no bit depends
//                               on which columns the rank holds), K2's walk
//                               over its heads into a [R, W/n] and each
//                               row's local |a| max;
//   (all-reduce MAX of the row max over the group)
//   int8_mlp.cu's tapclip_int8_partial_out (quantizer kStreamAttnA, col0 =
//   r W/n: the rank's heads are the attention output's columns [r W/n, (r+1)
//   W/n)), then the all-reduce SUM of the int32 rows, then
//   tapclip_int8_epilogue.
// Every head's walk is the whole kernel's, so the ranks' result is the whole
// kernel's bit for bit.
#include <stdint.h>

#include <type_traits>

#include "attn_core_mma.cuh"
#include "int8_common.cuh"
#include "int8_tiles.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::int8k;

template <typename T, bool SR>
cudaError_t launch_block(const T* x, const float* gamma, const float* beta, const int8_t* w_qkv,
                         const float* s_qkv, const float* b_qkv, const int8_t* w_out, const float* s_out,
                         const float* b_out, T* out, float* qkv, float* a, int8_t* codes, float* scales, int B,
                         int T_, int W, int H, int valid, float eps, uint32_t seed, cudaStream_t s) {
  // p . v rounds p (and reads v) in bf16 only in the stochastic mode in bf16.
  using PT = std::conditional_t<SR && !mma::kIsF32<T>, __nv_bfloat16, float>;
  const int R = B * T_, Wp = mma8::kp(W);
  float* t1 = scales;
  float* t2 = scales + R;
  float* amax = scales + 2 * R;
  cudaError_t err = launch_ln_quant<T, SR>(x, gamma, beta, codes, t1, amax, R, W, Wp, eps, seed, kStreamAttnY, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant<kQkv, T>(codes, w_qkv, t1, s_qkv, b_qkv, qkv, nullptr, R, 3 * W, Wp, SR ? 2 * W : 3 * W, s);
  if (err != cudaSuccess) return err;
  err = attn::launch_attn_core<float, PT, float, false, true>(qkv, a, amax, B, H, T_, W, valid, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_rows<SR>(a, amax, codes, t2, R, W, Wp, 0, seed, kStreamAttnA, s);
  if (err != cudaSuccess) return err;
  return launch_proj<T>(codes, w_out, t2, s_out, b_out, x, out, R, W, Wp, s);
}

template <typename T>
cudaError_t launch_block_mode(int deterministic, const void* x, const float* gamma, const float* beta,
                              const int8_t* w_qkv, const float* s_qkv, const float* b_qkv, const int8_t* w_out,
                              const float* s_out, const float* b_out, void* out, float* qkv, float* a,
                              int8_t* codes, float* scales, int B, int T_, int W, int H, int valid, float eps,
                              uint32_t seed, cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  auto* O = static_cast<T*>(out);
  if (deterministic)
    return launch_block<T, false>(X, gamma, beta, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, O, qkv, a, codes,
                                  scales, B, T_, W, H, valid, eps, seed, s);
  return launch_block<T, true>(X, gamma, beta, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, O, qkv, a, codes, scales,
                               B, T_, W, H, valid, eps, seed, s);
}

}  // namespace

// B14.  x, out [B, T, W] in the compute dtype (0 float32, 1 bfloat16);
// gamma, beta, s_out, b_out [W] and s_qkv, b_qkv [3W] f32; w_qkv [3W, kp(W)]
// and w_out [W, kp(W)] int8, K-major with zeros past W (kp(K) =
// tapclip_int8_gemm_kp(K)); scratch qkv [B T, 3W] and a [B T, W] f32, codes
// [B T, kp(W)] int8 and scales [3, B T] f32, all 16-byte aligned.  Head dim
// W / n_heads in {16, 32, 64, 128}; valid in [1, T].  deterministic 1: round
// to nearest (LN rounded to the dtype, attention in f32); 0: stochastic with
// the draws of `seed` (v and p rounded to the dtype).
extern "C" int tapclip_int8_attn(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                 const void* s_qkv, const void* b_qkv, const void* w_out, const void* s_out,
                                 const void* b_out, void* out, void* qkv, void* a, void* codes, void* scales, int B,
                                 int T, int W, int n_heads, int valid, float eps, unsigned int seed,
                                 int deterministic, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || W % 4 || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w_qkv) | reinterpret_cast<uintptr_t>(w_out) |
                         reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(scales);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* wq = static_cast<const int8_t*>(w_qkv);
  const auto* sq = static_cast<const float*>(s_qkv);
  const auto* bq = static_cast<const float*>(b_qkv);
  const auto* wo = static_cast<const int8_t*>(w_out);
  const auto* so = static_cast<const float*>(s_out);
  const auto* bo = static_cast<const float*>(b_out);
  auto* ws = static_cast<float*>(qkv);
  auto* av = static_cast<float*>(a);
  auto* c8 = static_cast<int8_t*>(codes);
  auto* sc = static_cast<float*>(scales);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block_mode<float>(deterministic, x, g, bt, wq, sq, bq, wo, so, bo, out, ws, av, c8, sc, B, T, W,
                                    n_heads, valid, eps, seed, s);
  if (dtype == 1)
    return launch_block_mode<__nv_bfloat16>(deterministic, x, g, bt, wq, sq, bq, wo, so, bo, out, ws, av, c8, sc, B,
                                            T, W, n_heads, valid, eps, seed, s);
  return cudaErrorInvalidValue;
}

namespace {

template <typename T, bool SR>
cudaError_t launch_front(const T* x, const float* gamma, const float* beta, const int8_t* w_qkv, const float* s_qkv,
                         const float* b_qkv, float* qkv, float* a, int8_t* codes, float* t1, float* amax, int B,
                         int T_, int W, int Wl, int H, int valid, float eps, uint32_t seed, cudaStream_t s) {
  using PT = std::conditional_t<SR && !mma::kIsF32<T>, __nv_bfloat16, float>;
  const int R = B * T_, Wp = mma8::kp(W);
  cudaError_t err = launch_ln_quant<T, SR>(x, gamma, beta, codes, t1, amax, R, W, Wp, eps, seed, kStreamAttnY, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant<kQkv, T>(codes, w_qkv, t1, s_qkv, b_qkv, qkv, nullptr, R, 3 * Wl, Wp, SR ? 2 * Wl : 3 * Wl, s);
  if (err != cudaSuccess) return err;
  return attn::launch_attn_core<float, PT, float, false, true>(qkv, a, amax, B, H, T_, Wl, valid, s);
}

template <typename T>
cudaError_t launch_front_mode(int deterministic, const void* x, const float* gamma, const float* beta,
                              const int8_t* w_qkv, const float* s_qkv, const float* b_qkv, float* qkv, float* a,
                              int8_t* codes, float* t1, float* amax, int B, int T_, int W, int Wl, int H, int valid,
                              float eps, uint32_t seed, cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  if (deterministic)
    return launch_front<T, false>(X, gamma, beta, w_qkv, s_qkv, b_qkv, qkv, a, codes, t1, amax, B, T_, W, Wl, H,
                                  valid, eps, seed, s);
  return launch_front<T, true>(X, gamma, beta, w_qkv, s_qkv, b_qkv, qkv, a, codes, t1, amax, B, T_, W, Wl, H, valid,
                               eps, seed, s);
}

}  // namespace

// B14's partial mode, its front (launches 1-3 on the rank's n_heads heads of
// width Wl in all).  x [B, T, W] in the compute dtype (0 float32, 1
// bfloat16); gamma, beta [W] and s_qkv, b_qkv [3 Wl] f32; w_qkv [3 Wl,
// kp(W)] int8 K-major, the columns [q | k | v] of the rank's heads; out: a
// [B T, Wl] f32 and amax [B T] f32 (each row's local |a| max); scratch qkv
// [B T, 3 Wl] f32, codes [B T, kp(W)] int8, t1 [B T] f32.  Head dim Wl /
// n_heads in {16, 32, 64, 128}; valid in [1, T].  w_qkv, qkv, a, codes
// 16-byte aligned.
extern "C" int tapclip_int8_attn_front(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                       const void* s_qkv, const void* b_qkv, void* qkv, void* a, void* codes,
                                       void* t1, void* amax, int B, int T, int W, int Wl, int n_heads, int valid,
                                       float eps, unsigned int seed, int deterministic, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || Wl <= 0 || Wl % n_heads || Wl % 4 || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w_qkv) | reinterpret_cast<uintptr_t>(qkv) |
                         reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(codes);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* wq = static_cast<const int8_t*>(w_qkv);
  const auto* sq = static_cast<const float*>(s_qkv);
  const auto* bq = static_cast<const float*>(b_qkv);
  auto* ws = static_cast<float*>(qkv);
  auto* av = static_cast<float*>(a);
  auto* c8 = static_cast<int8_t*>(codes);
  auto* t = static_cast<float*>(t1);
  auto* m = static_cast<float*>(amax);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_front_mode<float>(deterministic, x, g, bt, wq, sq, bq, ws, av, c8, t, m, B, T, W, Wl, n_heads,
                                    valid, eps, seed, s);
  if (dtype == 1)
    return launch_front_mode<__nv_bfloat16>(deterministic, x, g, bt, wq, sq, bq, ws, av, c8, t, m, B, T, W, Wl,
                                            n_heads, valid, eps, seed, s);
  return cudaErrorInvalidValue;
}
