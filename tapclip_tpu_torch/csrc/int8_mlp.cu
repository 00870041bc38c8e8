// B13: int8 W8A8 MLP half-block of the frozen-tower eval path,
//   out = x + dequant(int8(gelu(dequant(int8(LN(x)) . Wfc_q) + b_fc)) . Wproj_q) + b_proj,
// with per-row activation codes (stochastic or round-to-nearest) and exact
// int32 sums, on the int8 tensor cores.  Also S5: the erf3 / recipmul
// variants of scripts/int8_mlp_ab.py, as B13's own launches with the switches
// applied (tapclip_int8_mlp_variant).
//
// Replaces tapclip_tpu/ops/int8_mlp.py::_int8_mlp_kernel (the pallas_call in
// int8_mlp_block) and the round-to-nearest model _xla_int8_reference, which
// the JAX package runs under int8_deterministic: the wrapper
// (tapclip_tpu_torch/ops/int8_mlp.py::int8_mlp_cuda) launches it in both
// modes.  S5 replaces scripts/int8_mlp_ab.py's make_kernel.kernel in its
// three variants (ops/int8_mlp.py::int8_mlp_variant).  Quantization scheme
// and random bits: int8_common.cuh.
//
// What bounds it on the card: the products, 4 R W H int8 operations, at
// ViT-B/16 serving (R = 8 x 200 rows, W 768, H 3,072) 15.1 G, 0.0076 ms at
// the tensor cores' 1,979 TOP/s; the bytes (x in and out in f32, 4.7 MB of
// int8 weights) 0.004 ms.  Traces on an H100 80GB HBM3 at 700 W
// (profile_kernels.py), f32 stochastic at that shape: 0.105 ms, the
// LayerNorm rows 11 us, fc 40 (312 tiles of 128 x 128 over 264
// block slots, the GELU epilogue storing 19.7 MB of h), the hidden codes 10,
// proj 36 (150 tiles of 64 x 128, 48 stages deep), plus 8 for the wrapper's
// two weight transposes; launches alone 0.100 ms (time_half_blocks.py).
//
// Design: four launches behind one wrapper call, which lays the weights out
// K-major ([N, Kp], Kp = K rounded up to 64, zeros past K; S6's transpose
// kernel, int8_gemm.cu) where it quantizes them, and allocates the scratch:
// hidden rows h [R, H] f32, codes yq [R, Kp(W)] and hq [R, Kp(H)] int8,
// scales [3, R] f32 (t1, t2, amax of h).  The kernels are int8_tiles.cuh's,
// shared with B14:
//   1. ln_quant_kernel, one warp a row: LayerNorm into shared memory
//      (ln_row_warp), the row's codes and scale t1; zeroes the row's |h| max.
//   2. dequant_kernel<kGeluMax>: yq . Wfc^T on int8_mma.cuh's block tile
//      (mma.sync m16n8k32 s8, 128 x 128 tiles or 64 x 128), its epilogue
//      dequantizing (acc t1) s_fc + b_fc and applying exact GELU (erff),
//      storing h (19.7 MB at the image shape, in L2), and folding the tile's
//      |h| into the row's max: a max over the quad's lanes, then atomicMax
//      on the non-negative f32 bits, which no order of the blocks changes.
//   3. quant_rows_kernel, one block a row: the codes of h and its scale t2
//      from that max (code_of: the draws of (seed, quantizer, row, column),
//      so no tiling moves a draw).
//   4. proj_kernel: hq . Wproj^T on the same tile, its epilogue
//      dequantizing, adding b_proj and the residual with one rounding.
// S5's switches change one device function each, in the same place of the
// same launches: erf3 the fc epilogue's erf (dequant_kernel<kGeluErf3Max>),
// recipmul both row passes' scale and codes (RECIP: v * (127 / amax) in
// place of v / (amax / 127)).  On that card erf3 adds 12 us to the launches
// (an IEEE divide and an expf a value where erff is one polynomial) and
// recipmul takes 4 off (int8_mlp_ab.py).  Every float step is written with the
// round-to-nearest intrinsics and the int32 sums and the row maxima are
// exact, so a variant's output is fixed by its switches, whatever the
// tiling: it equals the earlier __dp4a walk's bit for bit (chip_smoke.py's
// B13_BITS and S5_BITS, digests read from the walk).
//
// The partial mode (tensor parallelism over a `model` group of n ranks; the
// wrapper ops/int8_mlp.py::int8_mlp_block(tp_group=) runs the collectives
// between the entries).  Rank r holds fc's columns [r H/n, (r+1) H/n), the
// same rows of proj, and proj's per-column scales of the whole weight (the
// rank's column max all-reduced MAX before it quantizes):
//   tapclip_int8_mlp_front      launches 1 and 2 on the rank's columns: the
//                               LayerNorm rows and their codes (replicated),
//                               fc + GELU into h [R, H/n] and each row's
//                               local |h| max;
//   (all-reduce MAX of the row max over the group)
//   tapclip_int8_partial_out    launch 3 with the global column index in
//                               the draws (col0 = r H/n), then acc_kernel:
//                               proj's int32 sums over the rank's depth;
//   (all-reduce SUM of the int32 rows: exact, 127^2 H is far below 2^31)
//   tapclip_int8_epilogue       proj_kernel's epilogue on the summed rows.
// Every step is the whole kernel's on the same values, so the ranks' result
// is the whole kernel's bit for bit.  B14's partial mode shares the last two
// entries.  What bounds a rank: half the int8 operations at n = 2.
#include <stdint.h>

#include <initializer_list>

#include "int8_common.cuh"
#include "int8_tiles.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::int8k;

// One call's operands (tapclip_int8_mlp's), cast once.
struct MlpCall {
  const float *gamma, *beta, *s_fc, *b_fc, *s_proj, *b_proj;
  const int8_t *w_fc, *w_proj;
  float *h, *scales;
  int8_t *yq, *hq;
  int R, W, H;
  float eps;
  uint32_t seed;
};

// The four launches.  SR: stochastic codes (else round to nearest); ERF3,
// RECIP: S5's switches.
template <typename T, bool SR, bool ERF3 = false, bool RECIP = false>
cudaError_t launch_mma(const MlpCall& c, const T* x, T* out, cudaStream_t s) {
  const int Wp = mma8::kp(c.W), Hp = mma8::kp(c.H);
  float* t1 = c.scales;
  float* t2 = c.scales + c.R;
  float* hmax = c.scales + 2 * c.R;
  cudaError_t err = launch_ln_quant<T, SR, RECIP>(x, c.gamma, c.beta, c.yq, t1, hmax, c.R, c.W, Wp, c.eps, c.seed,
                                                  kStreamMlpY, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant<ERF3 ? kGeluErf3Max : kGeluMax, float>(c.yq, c.w_fc, t1, c.s_fc, c.b_fc, c.h, hmax, c.R,
                                                              c.H, Wp, c.H, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_rows<SR, RECIP>(c.h, hmax, c.hq, t2, c.R, c.H, Hp, 0, c.seed, kStreamMlpH, s);
  if (err != cudaSuccess) return err;
  return launch_proj<T>(c.hq, c.w_proj, t2, c.s_proj, c.b_proj, x, out, c.R, c.W, Hp, s);
}

// variant (stochastic only): bit 0 erf3, bit 1 recipmul; 0 is B13.
template <typename T>
cudaError_t launch_mode(int deterministic, int variant, const MlpCall& c, const void* x, void* out,
                        cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  auto* O = static_cast<T*>(out);
  if (deterministic) return launch_mma<T, false>(c, X, O, s);
  switch (variant) {
    case 0: return launch_mma<T, true>(c, X, O, s);
    case 1: return launch_mma<T, true, true, false>(c, X, O, s);
    case 2: return launch_mma<T, true, false, true>(c, X, O, s);
    case 3: return launch_mma<T, true, true, true>(c, X, O, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* x, const void* gamma, const void* beta, const void* w_fc, const void* s_fc, const void* b_fc,
        const void* w_proj, const void* s_proj, const void* b_proj, void* out, void* h, void* yq, void* hq,
        void* scales, int R, int W, int H, float eps, unsigned int seed, int deterministic, int variant, int dtype,
        void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || variant < 0 || variant > 3 || (deterministic && variant))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w_fc) | reinterpret_cast<uintptr_t>(w_proj) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(yq) |
                         reinterpret_cast<uintptr_t>(hq) | reinterpret_cast<uintptr_t>(scales);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const MlpCall c{static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const float*>(s_fc),
                  static_cast<const float*>(b_fc), static_cast<const float*>(s_proj), static_cast<const float*>(b_proj),
                  static_cast<const int8_t*>(w_fc), static_cast<const int8_t*>(w_proj), static_cast<float*>(h),
                  static_cast<float*>(scales), static_cast<int8_t*>(yq), static_cast<int8_t*>(hq),
                  R, W, H, eps, seed};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mode<float>(deterministic, variant, c, x, out, s);
  if (dtype == 1) return launch_mode<__nv_bfloat16>(deterministic, variant, c, x, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// B13.  x, out [R, W] in the compute dtype (0 float32, 1 bfloat16); gamma,
// beta [W], s_fc, b_fc [H], s_proj, b_proj [W] f32; w_fc [H, kp(W)] and
// w_proj [W, kp(H)] int8, K-major with zeros past W and H (kp(K) =
// tapclip_int8_gemm_kp(K)); scratch h [R, H] f32, yq [R, kp(W)] and hq
// [R, kp(H)] int8, scales [3, R] f32, all 16-byte aligned.  deterministic 1:
// round to nearest; 0: stochastic with the draws of `seed`.
extern "C" int tapclip_int8_mlp(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
                                const void* b_proj, void* out, void* h, void* yq, void* hq, void* scales, int R,
                                int W, int H, float eps, unsigned int seed, int deterministic, int dtype,
                                void* stream) {
  return run(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, h, yq, hq, scales, R, W, H, eps, seed,
             deterministic, 0, dtype, stream);
}

// S5: B13's launches with the variant's switches.  The arguments of
// tapclip_int8_mlp, then variant: bit 0 erf3 (the fc epilogue's 3-term erf),
// bit 1 recipmul (both row passes quantize by v * (127 / amax)); 0 is B13
// itself.  The switches are stochastic-mode kernels: deterministic with a
// switch returns cudaErrorInvalidValue.
extern "C" int tapclip_int8_mlp_variant(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                        const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
                                        const void* b_proj, void* out, void* h, void* yq, void* hq, void* scales,
                                        int R, int W, int H, float eps, unsigned int seed, int deterministic,
                                        int variant, int dtype, void* stream) {
  return run(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, h, yq, hq, scales, R, W, H, eps, seed,
             deterministic, variant, dtype, stream);
}

namespace {

template <typename T, bool SR>
cudaError_t launch_front(const T* x, const float* gamma, const float* beta, const int8_t* w_fc, const float* s_fc,
                         const float* b_fc, float* h, int8_t* yq, float* t1, float* hmax, int R, int W, int H,
                         float eps, uint32_t seed, cudaStream_t s) {
  const int Wp = mma8::kp(W);
  cudaError_t err = launch_ln_quant<T, SR>(x, gamma, beta, yq, t1, hmax, R, W, Wp, eps, seed, kStreamMlpY, s);
  if (err != cudaSuccess) return err;
  return launch_dequant<kGeluMax, float>(yq, w_fc, t1, s_fc, b_fc, h, hmax, R, H, Wp, H, s);
}

template <typename T>
cudaError_t launch_front_mode(int deterministic, const void* x, const float* gamma, const float* beta,
                              const int8_t* w_fc, const float* s_fc, const float* b_fc, float* h, int8_t* yq,
                              float* t1, float* hmax, int R, int W, int H, float eps, uint32_t seed, cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  if (deterministic)
    return launch_front<T, false>(X, gamma, beta, w_fc, s_fc, b_fc, h, yq, t1, hmax, R, W, H, eps, seed, s);
  return launch_front<T, true>(X, gamma, beta, w_fc, s_fc, b_fc, h, yq, t1, hmax, R, W, H, eps, seed, s);
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits & 15;
}

}  // namespace

// B13's partial mode, its front (launches 1 and 2 on the rank's H hidden
// columns).  x [R, W] in the compute dtype (0 float32, 1 bfloat16); gamma,
// beta [W], s_fc, b_fc [H] f32; w_fc [H, kp(W)] int8 K-major; out: h [R, H]
// f32 and hmax [R] f32 (each row's local |h| max); scratch yq [R, kp(W)]
// int8 and t1 [R] f32.  w_fc, h, yq 16-byte aligned.
extern "C" int tapclip_int8_mlp_front(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                      const void* s_fc, const void* b_fc, void* h, void* yq, void* t1, void* hmax,
                                      int R, int W, int H, float eps, unsigned int seed, int deterministic, int dtype,
                                      void* stream) {
  if (R <= 0 || W <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (misaligned({w_fc, h, yq})) return cudaErrorMisalignedAddress;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* w = static_cast<const int8_t*>(w_fc);
  const auto* sf = static_cast<const float*>(s_fc);
  const auto* bf = static_cast<const float*>(b_fc);
  auto* hh = static_cast<float*>(h);
  auto* q = static_cast<int8_t*>(yq);
  auto* t = static_cast<float*>(t1);
  auto* m = static_cast<float*>(hmax);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_front_mode<float>(deterministic, x, g, bt, w, sf, bf, hh, q, t, m, R, W, H, eps, seed, s);
  if (dtype == 1)
    return launch_front_mode<__nv_bfloat16>(deterministic, x, g, bt, w, sf, bf, hh, q, t, m, R, W, H, eps, seed, s);
  return cudaErrorInvalidValue;
}

// The partial modes' int32 product (B13's proj, B14's out): the codes of
// the rows v [R, K] f32 from their global max rmax [R] (quantizer
// `stream_id`, column c drawing column col0 + c's bits) into codes [R,
// kp(K)] int8 with scales t [R] f32, then acc [R, N] int32 = codes . w^T
// over the rank's depth, w [N, kp(K)] int8 K-major.  v, codes, w 16-byte
// aligned.
extern "C" int tapclip_int8_partial_out(const void* v, const void* rmax, const void* w, void* codes, void* t,
                                        void* acc, int R, int K, int N, int col0, unsigned int seed, int stream_id,
                                        int deterministic, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || col0 < 0 || stream_id < 0 || stream_id > 3) return cudaErrorInvalidValue;
  if (misaligned({v, w, codes})) return cudaErrorMisalignedAddress;
  const auto* V = static_cast<const float*>(v);
  const auto* M = static_cast<const float*>(rmax);
  auto* Q = static_cast<int8_t*>(codes);
  auto* S = static_cast<float*>(t);
  auto s = static_cast<cudaStream_t>(stream);
  const int Kp = mma8::kp(K);
  cudaError_t err = deterministic
                        ? launch_quant_rows<false>(V, M, Q, S, R, K, Kp, col0, seed, stream_id, s)
                        : launch_quant_rows<true>(V, M, Q, S, R, K, Kp, col0, seed, stream_id, s);
  if (err != cudaSuccess) return err;
  return launch_acc(Q, static_cast<const int8_t*>(w), static_cast<int*>(acc), R, N, Kp, s);
}

// The partial modes' epilogue: out [R, N] = (acc t) s_col + b_col + x, one
// rounding to the compute dtype (0 float32, 1 bfloat16), t the scale of the
// row's global max rmax [R]; acc [R, N] int32 summed over the group.
extern "C" int tapclip_int8_epilogue(const void* acc, const void* rmax, const void* s_col, const void* b_col,
                                     const void* x, void* out, int R, int N, int dtype, void* stream) {
  if (R <= 0 || N <= 0) return cudaErrorInvalidValue;
  const auto* A = static_cast<const int*>(acc);
  const auto* M = static_cast<const float*>(rmax);
  const auto* S = static_cast<const float*>(s_col);
  const auto* B = static_cast<const float*>(b_col);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_epilogue<float>(A, M, S, B, static_cast<const float*>(x), static_cast<float*>(out), R, N, s);
  if (dtype == 1)
    return launch_epilogue<__nv_bfloat16>(A, M, S, B, static_cast<const __nv_bfloat16*>(x),
                                          static_cast<__nv_bfloat16*>(out), R, N, s);
  return cudaErrorInvalidValue;
}
