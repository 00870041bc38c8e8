// S2: the A/B variants of the fused MLP half-block as configurations of K1
// (fused_mlp.cu: LayerNorm, fc with the kGelu epilogue, proj with kResidual,
// on the tensor cores), each switch of scripts/mlp_kernel_ab.py as its
// nearest counterpart there:
//   base       K1 itself (this file calls tapclip_fused_mlp): the parent;
//   row_tile   512 (rt512) -> 128-row tiles in both products instead of
//              launch_pass's 64 (or 32); the schedule alone, so every
//              output equals K1's bit for bit;
//   erf3       the fc epilogue with common.cuh's 3-term erf (kGeluErf3);
//   ln1pass    one-pass LayerNorm statistics, var = E[x^2] - mean^2;
//   ilv_chunks 2 / 4 -> the hidden dimension in 2 or 4 chunks of H / c
//              columns: launch k runs the fc tiles of chunk k beside the proj
//              tiles of chunk k - 1 (one grid of both, c + 1 launches), each
//              proj a deterministic split of the product's depth
//              (gemm_mma.cuh's kStore partial z of c), and one last launch
//              sums out = round(((x + b_proj) + p_0) + p_1 ...), the TPU
//              kernel's order.
//
// Replaces scripts/mlp_kernel_ab.py::make_kernel.kernel (erf3, ln1pass,
// ilv_chunks, and run_variant's row_tile).  The wrapper is
// tapclip_tpu_torch/ops/fused_mlp.py::fused_mlp_variant.
//
// What bounds it on the card: as K1, the products (15 GFLOP at ViT-B/16
// batch 8: 0.092 ms as six bf16 MMAs a product, 0.015 ms in bf16).  The
// variants ask which lever moves K1: larger tiles (fewer blocks, more MMAs
// per staged byte), a cheaper GELU or LayerNorm, or the fc of one chunk
// overlapping the proj of the last (one wave of both where K1 runs two
// passes, at the price of c f32 partials [R, W] through L2).
// No atomics: a call repeats bit for bit.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

// K1 (fused_mlp.cu), the parent.
extern "C" int tapclip_fused_mlp(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                 const void* b_fc, const void* w_proj, const void* b_proj, void* out, void* ws,
                                 int R, int W, int H, float eps, int dtype, void* stream);

namespace {

using namespace tapclip;
using bf16 = __nv_bfloat16;
using gemm::Epi;

constexpr int kFcN = 128, kProjN = 64;  // K1's tile widths
constexpr int kIlvBM = 64;              // the interleaved steps' tile rows

// One tile of C = epilogue(A . B) (A [M, K], B [K, N] row major): the split
// f32 tile or the bf16 one with CE-element copies.
template <typename T, int CE, int BN, int EPI, typename TC>
__device__ __forceinline__ void tile(const T* A, const T* B, const Epi<T>& e, TC* C, int M, int N, int K, int m0,
                                     int n0, unsigned z, unsigned S) {
  if constexpr (mma::kIsF32<T>) {
    gemm::gemm_f32_tile<kIlvBM, BN, EPI, false>(A, B, e, C, M, N, K, m0, n0, z, S);
  } else {
    gemm::gemm_bf16_tile<kIlvBM, BN, CE, EPI, false, TC>(A, B, e, C, M, N, K, m0, n0, z, S);
  }
}

// Step k of the interleaved walk over c chunks of the hidden dimension: the
// first fc_tiles blocks take the fc tiles of chunk fc_chunk (h = gelu(y .
// w_fc + b_fc) in columns fc_chunk H / c ..), the rest the proj tiles of
// chunk proj_chunk (the f32 partial part[proj_chunk] = h . w_proj over that
// chunk's depth).
template <typename T, int CE, int EPI>
__global__ void __launch_bounds__(gemm::kThreads, 2)
ilv_step_kernel(const T* __restrict__ y, const T* __restrict__ w_fc, const float* __restrict__ b_fc,
                T* __restrict__ h, const T* __restrict__ w_proj, float* __restrict__ part, int R, int W, int H,
                int chunks, int fc_chunk, int fc_tiles, int proj_chunk) {
  const int b = blockIdx.x;
  if (b < fc_tiles) {
    const int tn = H / chunks / kFcN;
    tile<T, CE, kFcN, EPI, T>(y, w_fc, Epi<T>{b_fc, nullptr, nullptr, nullptr, 0}, h, R, H, W, (b / tn) * kIlvBM,
                              fc_chunk * (H / chunks) + (b % tn) * kFcN, 0u, 1u);
  } else {
    const int t = b - fc_tiles, tn = (W + kProjN - 1) / kProjN;
    tile<T, CE, kProjN, gemm::kStore, float>(h, w_proj, Epi<T>{}, part, R, W, H, (t / tn) * kIlvBM,
                                             (t % tn) * kProjN, proj_chunk, chunks);
  }
}

// out = round(((x + b_proj) + part[0]) + part[1] ...), in order.
template <typename T>
__global__ void __launch_bounds__(256)
ilv_sum_kernel(const T* __restrict__ x, const float* __restrict__ b_proj, const float* __restrict__ part,
               T* __restrict__ out, int R, int W, int chunks) {
  const size_t n = static_cast<size_t>(R) * W;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = to_f(x[i]) + b_proj[i % W];
    for (int j = 0; j < chunks; ++j) acc = acc + part[j * n + i];
    out[i] = from_f<T>(acc);
  }
}

struct Switches {
  int row_tile, erf3, ln1pass, chunks;
};

template <typename T, int CE, int EPI>
cudaError_t interleaved(const T* x, const T* y, const T* w_fc, const float* b_fc, const T* w_proj,
                        const float* b_proj, T* h, float* part, T* out, int R, int W, int H, int chunks,
                        cudaStream_t s) {
  auto kernel = ilv_step_kernel<T, CE, EPI>;
  constexpr size_t smem = mma::kIsF32<T> ? gemm::f32_tile_smem<kIlvBM, kFcN, false>()
                                         : gemm::bf16_tile_smem<kIlvBM, kFcN, false>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rt = (R + kIlvBM - 1) / kIlvBM;
  const int fc_tiles = rt * (H / chunks / kFcN), proj_tiles = rt * ((W + kProjN - 1) / kProjN);
  for (int k = 0; k <= chunks; ++k) {
    const int fc = k < chunks ? fc_tiles : 0;
    kernel<<<fc + (k > 0 ? proj_tiles : 0), gemm::kThreads, smem, s>>>(y, w_fc, b_fc, h, w_proj, part, R, W, H,
                                                                       chunks, k, fc, k - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t n = static_cast<size_t>(R) * W;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4 * gemm::sm_count()));
  ilv_sum_kernel<T><<<blocks, 256, 0, s>>>(x, b_proj, part, out, R, W, chunks);
  return cudaGetLastError();
}

// K1's three launches with the switches (every switch but base's).
template <typename T, int CE>
cudaError_t variant(const T* x, const float* gamma, const float* beta, const T* w_fc, const float* b_fc,
                    const T* w_proj, const float* b_proj, T* out, T* ws, float* part, int R, int W, int H, float eps,
                    const Switches& sw, cudaStream_t s) {
  T* h = ws;
  T* y = ws + static_cast<size_t>(R) * H;
  const int ln_blocks = (R + kLnWarps - 1) / kLnWarps;
  if (sw.ln1pass) {
    ln_rows_kernel<T, true><<<ln_blocks, kLnThreads, 0, s>>>(x, gamma, beta, y, nullptr, nullptr, R, W, eps);
  } else {
    ln_rows_kernel<T><<<ln_blocks, kLnThreads, 0, s>>>(x, gamma, beta, y, nullptr, nullptr, R, W, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (sw.chunks > 1) {
    return sw.erf3 ? interleaved<T, CE, gemm::kGeluErf3>(x, y, w_fc, b_fc, w_proj, b_proj, h, part, out, R, W, H,
                                                         sw.chunks, s)
                   : interleaved<T, CE, gemm::kGelu>(x, y, w_fc, b_fc, w_proj, b_proj, h, part, out, R, W, H,
                                                     sw.chunks, s);
  }
  const Epi<T> fc{b_fc, nullptr, nullptr, nullptr, 0}, proj{b_proj, x, nullptr, nullptr, 0};
  if (sw.row_tile == 128) {
    err = gemm::launch_gemm<128, kFcN, CE, gemm::kGelu, false, T>(y, w_fc, fc, h, R, H, W, 1, s);
    if (err != cudaSuccess) return err;
    return gemm::launch_gemm<128, kProjN, CE, gemm::kResidual, false, T>(h, w_proj, proj, out, R, W, H, 1, s);
  }
  err = sw.erf3 ? gemm::launch_pass<T, kFcN, CE, gemm::kGeluErf3>(y, w_fc, fc, h, R, H, W, s)
                : gemm::launch_pass<T, kFcN, CE, gemm::kGelu>(y, w_fc, fc, h, R, H, W, s);
  if (err != cudaSuccess) return err;
  return gemm::launch_pass<T, kProjN, CE, gemm::kResidual>(h, w_proj, proj, out, R, W, H, s);
}

}  // namespace

// As tapclip_fused_mlp (ws: its scratch, R (H + W) elements of the dtype),
// with the switches: row_tile 0 (K1's choice) or 128, erf3 and ln1pass 0 or
// 1, chunks 1, 2 or 4 (part: f32 [chunks, R, W] when chunks > 1; H a
// multiple of 128 chunks).  Every switch off is K1's own call.  Past base,
// one switch at a time but erf3 with chunks, and W and H multiples of 8 and
// every pointer of the dtype 16-byte aligned.
extern "C" int tapclip_fused_mlp_variant(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                         const void* b_fc, const void* w_proj, const void* b_proj, void* out,
                                         void* ws, void* part, int R, int W, int H, float eps, int row_tile,
                                         int erf3, int ln1pass, int chunks, int dtype, void* stream) {
  const Switches sw{row_tile, erf3 != 0, ln1pass != 0, chunks};
  if ((row_tile != 0 && row_tile != 128) || (chunks != 1 && chunks != 2 && chunks != 4) ||
      (chunks > 1 && (H % (128 * chunks) || part == nullptr)) ||
      (sw.row_tile != 0) + sw.ln1pass + (chunks > 1) + (sw.erf3 && chunks == 1) > 1)
    return cudaErrorInvalidValue;
  if (!row_tile && !sw.erf3 && !sw.ln1pass && chunks == 1)
    return tapclip_fused_mlp(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, out, ws, R, W, H, eps, dtype, stream);
  if (R <= 0 || W <= 0 || H <= 0 || W % 8 || H % 8) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_fc) |
                         reinterpret_cast<uintptr_t>(w_proj) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(part);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(part);
#define TAPCLIP_MLP_VARIANT(TT, CE)                                                                                \
  return variant<TT, CE>(static_cast<const TT*>(x), f(gamma), f(beta), static_cast<const TT*>(w_fc), f(b_fc),      \
                         static_cast<const TT*>(w_proj), f(b_proj), static_cast<TT*>(out), static_cast<TT*>(ws), p, \
                         R, W, H, eps, sw, s);
  if (dtype == 0) TAPCLIP_MLP_VARIANT(float, 4)
  if (dtype == 1) TAPCLIP_MLP_VARIANT(bf16, 8)
#undef TAPCLIP_MLP_VARIANT
  return cudaErrorInvalidValue;
}
