// B13: int8 W8A8 MLP half-block of the frozen-tower eval path,
//   out = x + dequant(int8(gelu(dequant(int8(LN(x)) . Wfc_q) + b_fc)) . Wproj_q) + b_proj,
// with per-row activation codes (stochastic or round-to-nearest) and exact
// int32 sums, on the int8 tensor cores.  Also S5 and its parent: the one-launch
// __dp4a walk (int8_mlp_walk_kernel) with the erf3 / recipmul variants of
// scripts/int8_mlp_ab.py as template flags; its flags-off kernel is the
// earlier B13, which the new one equals bit for bit.
//
// Replaces tapclip_tpu/ops/int8_mlp.py::_int8_mlp_kernel (the pallas_call in
// int8_mlp_block) and the round-to-nearest model _xla_int8_reference, which
// the JAX package runs under int8_deterministic: the wrapper
// (tapclip_tpu_torch/ops/int8_mlp.py::int8_mlp_cuda) launches it in both
// modes.  Quantization scheme and random bits: int8_common.cuh.
//
// What bounds it on the card: the products, 4 R W H int8 operations, at
// ViT-B/16 serving (R = 8 x 200 rows, W 768, H 3,072) 15.1 G, 0.0076 ms at
// the tensor cores' 1,979 TOP/s; the bytes (x in and out in f32, 4.7 MB of
// int8 weights) 0.004 ms.  Traces on an H100 80GB HBM3 at 700 W
// (profile_kernels.py), f32 stochastic at that shape: the walk took 0.549
// ms, both products with __dp4a on the integer units, 8 rows a block, each
// of its 200 blocks reading both weight matrices (4.7 MB) from L2, 0.94 GB
// of L2 reads a call.  This design 0.105 ms: the LayerNorm rows 11 us, fc
// 40 (312 tiles of 128 x 128 over 264 block slots, the GELU epilogue
// storing 19.7 MB of h), the hidden codes 10, proj 36 (150 tiles of 64 x
// 128, 48 stages deep), plus 8 for the wrapper's two weight transposes;
// launches alone 0.100 ms (time_half_blocks.py).
//
// Design: four launches behind one wrapper call, which lays the weights out
// K-major ([N, Kp], Kp = K rounded up to 64, zeros past K; S6's transpose
// kernel, int8_gemm.cu) where it quantizes them, and allocates the scratch:
// hidden rows h [R, H] f32, codes yq [R, Kp(W)] and hq [R, Kp(H)] int8,
// scales [3, R] f32 (t1, t2, amax of h).  The kernels are int8_tiles.cuh's,
// shared with B14:
//   1. ln_quant_kernel, one warp a row: LayerNorm into shared memory
//      (ln_row_warp, as the walk), the row's codes and scale t1; zeroes the
//      row's |h| max.
//   2. dequant_kernel<kGeluMax>: yq . Wfc^T on int8_mma.cuh's block tile
//      (mma.sync m16n8k32 s8, 128 x 128 tiles or 64 x 128), its epilogue
//      dequantizing (acc t1) s_fc + b_fc and applying exact GELU (erff) in
//      the walk's order, storing h (19.7 MB at the image shape, in L2), and
//      folding the tile's |h| into the row's max: a max over the quad's
//      lanes, then atomicMax on the non-negative f32 bits, which no order
//      of the blocks changes.
//   3. quant_rows_kernel, one block a row: the codes of h and its scale t2
//      from that max (code_of: the draws of (seed, quantizer, row, column),
//      so no tiling moves a draw).
//   4. proj_kernel: hq . Wproj^T on the same tile, its epilogue
//      dequantizing, adding b_proj and the residual with one rounding.
// Each float step is the walk's, in the walk's order, and the int32 sums and
// the row maxima are exact: the output equals the walk's bit for bit.
#include <stdint.h>

#include "int8_common.cuh"
#include "int8_tiles.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::int8k;

// --- S5 and its parent: the __dp4a walk ---------------------------------------
//
// A block owns 8 rows and keeps their hidden rows in shared memory as f32
// (8 x 3,072 x 4 B = 96 KB; 128 KB at ViT-L/14): (1) one warp a row,
// LayerNorm into shared memory, its amax and codes; (2) every thread owns
// hidden columns t, t + 256 and walks the reduction over packed int8 weights
// with __dp4a (rows_dot_packed); dequantize, b_fc, GELU into the hidden
// rows; (3) one warp a row, the hidden row's amax and codes; (4) the proj
// product the same way, b_proj and the residual.  One launch a call; rows
// past R (the ragged last block) are computed on zeros and not stored.

struct MlpSmem {
  int hld, wp, hp;
  __host__ __device__ MlpSmem(int W, int H) : hld(((H > W ? H : W) + 3) / 4 * 4), wp(pad16(W)), hp(pad16(H)) {}
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(kInt8Rows) * (hld * sizeof(float) + wp + hp) + 2 * kInt8Rows * sizeof(float);
  }
};

template <typename T, bool SR, bool ERF3, bool RECIP>
__global__ void __launch_bounds__(kInt8Threads)
int8_mlp_walk_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                const int* __restrict__ w_fc, const float* __restrict__ s_fc, const float* __restrict__ b_fc,
                const int* __restrict__ w_proj, const float* __restrict__ s_proj,
                const float* __restrict__ b_proj, T* __restrict__ out, int R, int W, int H, float eps,
                uint32_t seed) {
  constexpr int RB = kInt8Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpSmem lay(W, H);
  float* h_s = reinterpret_cast<float*>(smem);            // [RB][hld]: LN(x), then the hidden rows
  int8_t* yq_s = reinterpret_cast<int8_t*>(h_s + RB * lay.hld);  // [RB][wp] codes of LN(x)
  int8_t* hq_s = yq_s + RB * lay.wp;                      // [RB][hp] codes of the hidden rows
  float* t_s = reinterpret_cast<float*>(hq_s + RB * lay.hp);  // [2][RB] row scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * RB;

  // 1. LayerNorm and the first quantizer, one warp a row.
  for (int r = warp; r < RB; r += kInt8Warps) {
    const int row = row0 + r;
    float* yr = h_s + r * lay.hld;
    if (row < R) {
      ln_row_warp<T, !SR>(x + static_cast<size_t>(row) * W, gamma, beta, W, eps, yr, lane);
    } else {
      for (int c = lane; c < W; c += 32) yr[c] = 0.f;
    }
    __syncwarp();
    const float s = quantize_row_warp<SR, RECIP>(yr, W, lay.wp, yq_s + r * lay.wp,
                                                 row_key(seed, kStreamMlpY, row), lane);
    if (lane == 0) t_s[r] = s;
  }
  __syncthreads();

  // 2. The fc product, dequantized, + b_fc, GELU, into the hidden rows.
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(yq_s), lay.wp / 4, w_fc, H,
                         [&](int r, int j, int acc) {
                           h_s[r * lay.hld + j] = gelu<ERF3>(dequant(acc, t_s[r], s_fc[j], b_fc[j]));
                         });
  __syncthreads();

  // 3. The second quantizer over each whole hidden row.
  for (int r = warp; r < RB; r += kInt8Warps) {
    const float s = quantize_row_warp<SR, RECIP>(h_s + r * lay.hld, H, lay.hp, hq_s + r * lay.hp,
                                                 row_key(seed, kStreamMlpH, row0 + r), lane);
    if (lane == 0) t_s[RB + r] = s;
  }
  __syncthreads();

  // 4. The proj product, dequantized, + b_proj, + the residual.
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(hq_s), lay.hp / 4, w_proj, W,
                         [&](int r, int c, int acc) {
                           const int row = row0 + r;
                           if (row >= R) return;
                           const size_t off = static_cast<size_t>(row) * W + c;
                           out[off] = from_f<T>(__fadd_rn(dequant(acc, t_s[RB + r], s_proj[c], b_proj[c]),
                                                          to_f(x[off])));
                         });
}

template <typename T, bool SR, bool ERF3, bool RECIP>
cudaError_t launch_walk(const void* x, const float* gamma, const float* beta, const int* w_fc,
                   const float* s_fc, const float* b_fc, const int* w_proj, const float* s_proj,
                   const float* b_proj, void* out, int R, int W, int H, float eps, uint32_t seed,
                   cudaStream_t stream) {
  const size_t smem = MlpSmem(W, H).bytes();
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = int8_mlp_walk_kernel<T, SR, ERF3, RECIP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kInt8Rows - 1) / kInt8Rows;
  kernel<<<blocks, kInt8Threads, smem, stream>>>(static_cast<const T*>(x), gamma, beta, w_fc, s_fc, b_fc,
                                                 w_proj, s_proj, b_proj, static_cast<T*>(out), R, W, H,
                                                 eps, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_walk_mode(int deterministic, int variant, const void* x, const float* gamma,
                        const float* beta, const int* w_fc, const float* s_fc, const float* b_fc,
                        const int* w_proj, const float* s_proj, const float* b_proj, void* out, int R,
                        int W, int H, float eps, uint32_t seed, cudaStream_t s) {
#define TAPCLIP_INT8_MLP(SR, E3, RM) \
  launch_walk<T, SR, E3, RM>(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, R, W, H, eps, seed, s)
  if (deterministic) return variant == 0 ? TAPCLIP_INT8_MLP(false, false, false) : cudaErrorInvalidValue;
  switch (variant) {
    case 0: return TAPCLIP_INT8_MLP(true, false, false);
    case 1: return TAPCLIP_INT8_MLP(true, true, false);
    case 2: return TAPCLIP_INT8_MLP(true, false, true);
    case 3: return TAPCLIP_INT8_MLP(true, true, true);
    default: return cudaErrorInvalidValue;
  }
#undef TAPCLIP_INT8_MLP
}

// --- B13 on the int8 tensor cores (int8_tiles.cuh) --------------------------------

template <typename T, bool SR>
cudaError_t launch_mma(const T* x, const float* gamma, const float* beta, const int8_t* w_fc, const float* s_fc,
                       const float* b_fc, const int8_t* w_proj, const float* s_proj, const float* b_proj, T* out,
                       float* h, int8_t* yq, int8_t* hq, float* scales, int R, int W, int H, float eps,
                       uint32_t seed, cudaStream_t s) {
  const int Wp = mma8::kp(W), Hp = mma8::kp(H);
  float* t1 = scales;
  float* t2 = scales + R;
  float* hmax = scales + 2 * R;
  cudaError_t err = launch_ln_quant<T, SR>(x, gamma, beta, yq, t1, hmax, R, W, Wp, eps, seed, kStreamMlpY, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant<kGeluMax, float>(yq, w_fc, t1, s_fc, b_fc, h, hmax, R, H, Wp, H, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_rows<SR>(h, hmax, hq, t2, R, H, Hp, seed, kStreamMlpH, s);
  if (err != cudaSuccess) return err;
  return launch_proj<T>(hq, w_proj, t2, s_proj, b_proj, x, out, R, W, Hp, s);
}

template <typename T>
cudaError_t launch_mma_mode(int deterministic, const void* x, const float* gamma, const float* beta,
                            const int8_t* w_fc, const float* s_fc, const float* b_fc, const int8_t* w_proj,
                            const float* s_proj, const float* b_proj, void* out, float* h, int8_t* yq, int8_t* hq,
                            float* scales, int R, int W, int H, float eps, uint32_t seed, cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  auto* O = static_cast<T*>(out);
  if (deterministic)
    return launch_mma<T, false>(X, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, O, h, yq, hq, scales, R,
                                W, H, eps, seed, s);
  return launch_mma<T, true>(X, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, O, h, yq, hq, scales, R, W,
                             H, eps, seed, s);
}

}  // namespace

// S5 and its parent, the walk: x, out, gamma, beta and the vectors as B13;
// w_fc [pad16(W) / 4, H] and w_proj [pad16(H) / 4, W] packed int8 (int32
// words, ops/int8_mlp.py::pack_k4).  deterministic 1: round to nearest; 0:
// stochastic with the draws of `seed`.  variant (stochastic only): 0 the
// flags-off walk, bit 0 erf3, bit 1 recipmul.  Refuses
// (cudaErrorInvalidValue) shapes whose hidden rows do not fit in shared
// memory.
extern "C" int tapclip_int8_mlp_walk(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                const void* s_fc, const void* b_fc, const void* w_proj,
                                const void* s_proj, const void* b_proj, void* out, int R, int W, int H,
                                float eps, unsigned int seed, int deterministic, int variant, int dtype,
                                void* stream) {
  if (R <= 0 || W <= 0 || H <= 0) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* wf = static_cast<const int*>(w_fc);
  const auto* sf = static_cast<const float*>(s_fc);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* wp = static_cast<const int*>(w_proj);
  const auto* sp = static_cast<const float*>(s_proj);
  const auto* bp = static_cast<const float*>(b_proj);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_walk_mode<float>(deterministic, variant, x, g, bt, wf, sf, bf, wp, sp, bp, out, R, W, H, eps,
                                   seed, s);
  if (dtype == 1)
    return launch_walk_mode<__nv_bfloat16>(deterministic, variant, x, g, bt, wf, sf, bf, wp, sp, bp, out, R, W, H,
                                      eps, seed, s);
  return cudaErrorInvalidValue;
}

// Bytes of shared memory the walk takes at width W and hidden width H (the
// launcher refuses more than 232,448).
extern "C" int tapclip_int8_mlp_walk_smem_bytes(int W, int H) {
  return static_cast<int>(MlpSmem(W, H).bytes());
}

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
  if (R <= 0 || W <= 0 || H <= 0) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w_fc) | reinterpret_cast<uintptr_t>(w_proj) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(yq) |
                         reinterpret_cast<uintptr_t>(hq) | reinterpret_cast<uintptr_t>(scales);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* wf = static_cast<const int8_t*>(w_fc);
  const auto* sf = static_cast<const float*>(s_fc);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* wp = static_cast<const int8_t*>(w_proj);
  const auto* sp = static_cast<const float*>(s_proj);
  const auto* bp = static_cast<const float*>(b_proj);
  auto* hb = static_cast<float*>(h);
  auto* y8 = static_cast<int8_t*>(yq);
  auto* h8 = static_cast<int8_t*>(hq);
  auto* sc = static_cast<float*>(scales);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mma_mode<float>(deterministic, x, g, bt, wf, sf, bf, wp, sp, bp, out, hb, y8, h8, sc, R, W, H,
                                  eps, seed, s);
  if (dtype == 1)
    return launch_mma_mode<__nv_bfloat16>(deterministic, x, g, bt, wf, sf, bf, wp, sp, bp, out, hb, y8, h8, sc, R,
                                          W, H, eps, seed, s);
  return cudaErrorInvalidValue;
}
