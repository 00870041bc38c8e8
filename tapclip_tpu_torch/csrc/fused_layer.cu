// S1: a whole pre-LN ViT layer in one launch,
//   mid = x + out_proj(attention(LN1(x))),  out = mid + mlp(LN2(mid)),
// with the attention output and mid in f32 (only LN1's, LN2's and GELU's
// outputs are rounded to the compute dtype, as in the TPU kernel).
//
// Replaces scripts/fused_layer_ab.py::make_layer_kernel.kernel (the
// pallas_call in run_fused_layer).  The wrapper is
// tapclip_tpu_torch/ops/fused_layer.py::fused_layer.
//
// The TPU kernel holds a whole sequence's mid in VMEM.  A Hopper block
// cannot (one ViT-B/16 sequence's mid is 200 x 768 x 4 = 614 KB against
// 227 KB of shared memory), so the layer is one cooperative launch of a
// persistent grid (as many blocks as the card holds at once: two on each
// SM), 8 warps a block, in seven phases with a grid barrier
// (this_grid().sync()) after each of the first six; each phase walks its
// work items block by block:
//   1. LN1 rows (ln_rows.cuh), one warp a row: y = LN1(x), rounded;
//   2. QKV tiles (gemm_mma.cuh, K2's kQkv epilogue): qkv f32, v rounded;
//   3. attention items (batch row, head, 128-row query tile) on K2's walk
//      (attn_core_mma.cuh) with an f32 output (as B14 instantiates it);
//   4. out-projection tiles: mid = x + (attn . w_out + b_out), f32
//      (kResidual into f32; attn is f32, so in bf16 too this product takes
//      the split f32 tile, on w_out widened to f32: one exact term of it,
//      three MMAs a product);
//   5. LN2 rows of the f32 mid: y2, rounded;
//   6. fc tiles: h = gelu(y2 . w_fc + b_fc), rounded (kGelu);
//   7. proj tiles: out = mid + (h . w_proj + b_proj), one rounding
//      (kResidual with an f32 residual).
// The tiles are the main-path kernels' own tile functions (K1's and K2's
// GEMM, K2's attention walk); f32 operands split into three bf16 terms,
// six MMAs a product.  Each product's tile shape is chosen per dtype
// (Tiles).  qkv, attn, mid, y, y2 and h live in workspaces the
// wrapper allocates (at ViT-B/16 batch 8 in f32: 4.9 MB each for attn and
// mid, 14.7 MB qkv, 19.7 MB h); each is written in one phase and read only
// in later ones, which lets the f32 tile read its operands through the
// read-only path.  A launch the card cannot hold at once (the cooperative
// grid too large) is refused and the wrapper raises.  No atomics: a call
// repeats bit for bit.
//
// What bounds it on the card: the products, 23.6 GFLOP at ViT-B/16 batch 8
// (QKV 5.66, attention 0.98, out-projection 1.89, fc and proj 15.1): 0.143
// ms as six bf16 MMAs a product at 989 TFLOP/s, 0.024 ms in bf16.  Against
// K2 then K1 (seven launches) it saves six launches and their tails, and
// pays six grid barriers, one block shape for every phase (256 threads: the
// attention takes 128-row query tiles, two at T 200, the second 72 rows
// full) and the registers and shared memory of the largest phase.
// Measured on an H100 80GB HBM3 at 700 W (fused_layer_ab.py,
// fused_layer_phases.py; PERF.md): f32 0.758 ms against K2 then K1's 0.670,
// bf16 0.341 against 0.265; the fc and proj phases take 60% of it in f32.
#include <cooperative_groups.h>
#include <stdint.h>

#include "attn_core_mma.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using bf16 = __nv_bfloat16;
using gemm::Epi;

constexpr int kDh = 64;
constexpr int kRows = 128;  // query rows of an attention item: 8 warps of 16
constexpr int kThreads = gemm::kThreads;
static_assert(2 * kRows == kThreads, "an attention item takes the whole block");

// Each product's tile (rows M, columns N) by dtype, the fastest of 64 x 128,
// 64 x 64 and 32 x 64 for each phase (a variant per phase, timed in turns on
// an H100: PERF.md).  An f32 tile costs six MMAs a product, so smaller
// tiles balance the waves of the persistent grid (two blocks on each of 132
// SMs: the out-projection and proj take 600 tiles of 32 x 64, 2.3 waves,
// where 64 x 64 gives 300, 1.1); a bf16 tile costs one, and larger tiles
// move fewer staged bytes a product.
template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int kQkvM = 64, kQkvN = 128, kOutM = 32, kOutN = 64, kFcM = 64, kFcN = 64, kProjM = 32,
                       kProjN = 64;
  static constexpr int kOutWTerms = mma::kF32Terms;  // bf16 terms of w_out in the out-projection
};
template <>
struct Tiles<bf16> {
  static constexpr int kQkvM = 64, kQkvN = 128, kOutM = 64, kOutN = 64, kFcM = 64, kFcN = 128, kProjM = 64,
                       kProjN = 64;
  static constexpr int kOutWTerms = 1;  // w_out holds bf16 values: three MMAs a product
};

// The largest phase's shared memory: the attention item's (PT = the dtype:
// bf16 rounds p) or the largest tile's (f32, 64 x 128).
template <typename T>
constexpr size_t layer_smem() {
  constexpr size_t core = attn::core_smem<float, T, kDh, kRows>(0);
  constexpr size_t f32 = gemm::f32_tile_smem<64, 128, false>();
  constexpr size_t bf = gemm::bf16_tile_smem<64, 128, false>();
  return core > f32 ? (core > bf ? core : bf) : (f32 > bf ? f32 : bf);
}

// The kernel's arguments (one struct: cudaLaunchCooperativeKernel takes an
// array of pointers to them).  w_out32: w_out as f32 (the dtype's values,
// exact); ws: f32 qkv [R, 3W], attn [R, W], mid [R, W]; wsd: the dtype's y
// [R, W], y2 [R, W], h [R, H].
template <typename T>
struct LayerArgs {
  const T* x;
  const float *gamma1, *beta1;
  const T* w_qkv;
  const float* b_qkv;
  const float* w_out32;
  const float *b_out, *gamma2, *beta2;
  const T* w_fc;
  const float* b_fc;
  const T* w_proj;
  const float* b_proj;
  float* ws;
  T* wsd;
  T* out;
  int B, H, seq, W, hidden, valid;
  float eps;
};

// C tile t of an M x N product in BM x BN tiles, n fastest (as a grid's x).
template <int BM, int BN>
__device__ __forceinline__ void tile_at(int t, int N, int& m0, int& n0) {
  const int tn = (N + BN - 1) / BN;
  m0 = (t / tn) * BM;
  n0 = (t % tn) * BN;
}

template <int BM, int BN>
__device__ __forceinline__ int tiles(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// Each phase is a function of its own, called (not inlined) from the kernel:
// ptxas then allocates its registers apart from the other phases', and no
// pointer or count of one phase stays live across the others.  Inlined, the
// f32 kernel read 10% slower, its proj phase 27% (fused_layer_phases.py).

// C = epilogue(A . B) over every BM x BN tile of C the block owns: the f32
// tile when A is f32 (B in NPB terms), the bf16 one (16-byte copies) when
// both are bf16.
template <int BM, int BN, int EPI, int NPB = mma::kF32Terms, typename TA, typename TB, typename TC, typename R>
__device__ __noinline__ void product(const TA* __restrict__ A, const TB* __restrict__ B, const Epi<TB, R> e,
                                    TC* __restrict__ C, int M, int N, int K) {
  const int n = tiles<BM, BN>(M, N);
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    int m0, n0;
    tile_at<BM, BN>(t, N, m0, n0);
    if constexpr (mma::kIsF32<TA>) {
      gemm::gemm_f32_tile<BM, BN, EPI, false, false, R, NPB>(A, B, e, C, M, N, K, m0, n0, 0u, 1u);
    } else {
      gemm::gemm_bf16_tile<BM, BN, 8, EPI, false, TC, false, R>(A, B, e, C, M, N, K, m0, n0, 0u, 1u);
    }
    __syncthreads();  // every warp is done with the tile's shared memory
  }
}

template <typename TI, typename TO>
__device__ __noinline__ void ln_phase(const TI* __restrict__ x, const float* __restrict__ gamma,
                                      const float* __restrict__ beta, TO* __restrict__ y, int R, int W, float eps) {
  const int warps = kThreads / 32;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R; r += gridDim.x * warps)
    ln_row<TI, TO>(x, gamma, beta, y, nullptr, nullptr, r, W, eps, threadIdx.x & 31);
}

// Attention items (batch row, head, query tile of kRows), PT = the dtype.
template <typename T>
__device__ __noinline__ void attn_phase(const float* __restrict__ qkv, float* __restrict__ out, int B, int H,
                                        int T_, int W, int valid) {
  const int nq = (T_ + kRows - 1) / kRows;
  for (int item = blockIdx.x; item < B * H * nq; item += gridDim.x) {
    const int bh = item / nq;
    attn::attn_core_tile<float, T, float, kDh, kRows, false, false>(qkv, out, nullptr, T_, W, valid, bh / H, bh % H,
                                                                    (item % nq) * kRows);
    __syncthreads();  // every warp is done with the item's shared memory
  }
}

// Two blocks an SM (128 registers).  One (255 registers) read 25% slower
// in f32 and 14% in bf16 (fused_layer_phases.py): the tile phases want the
// second block's warps.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fused_layer_kernel(LayerArgs<T> a) {
  auto grid = cooperative_groups::this_grid();
  const int R = a.B * a.seq, W = a.W;
  const size_t RW = static_cast<size_t>(R) * W;
  float* qkv = a.ws;  // [R, 3W], then attn [R, W], then mid [R, W]
  T* y = a.wsd;       // [R, W], then y2 [R, W], then h [R, H]

  using Tl = Tiles<T>;
  ln_phase(a.x, a.gamma1, a.beta1, y, R, W, a.eps);
  grid.sync();
  product<Tl::kQkvM, Tl::kQkvN, gemm::kQkv>(y, a.w_qkv, Epi<T>{a.b_qkv, nullptr, nullptr, nullptr, 2 * W}, qkv, R,
                                            3 * W, W);
  grid.sync();
  attn_phase<T>(qkv, qkv + 3 * RW, a.B, a.H, a.seq, W, a.valid);
  grid.sync();
  product<Tl::kOutM, Tl::kOutN, gemm::kResidual, Tl::kOutWTerms>(
      qkv + 3 * RW, a.w_out32, Epi<float, T>{a.b_out, a.x, nullptr, nullptr, 0}, qkv + 4 * RW, R, W, W);
  grid.sync();
  ln_phase(static_cast<const float*>(qkv + 4 * RW), a.gamma2, a.beta2, y + RW, R, W, a.eps);
  grid.sync();
  product<Tl::kFcM, Tl::kFcN, gemm::kGelu>(y + RW, a.w_fc, Epi<T>{a.b_fc, nullptr, nullptr, nullptr, 0}, y + 2 * RW,
                                           R, a.hidden, W);
  grid.sync();
  product<Tl::kProjM, Tl::kProjN, gemm::kResidual>(y + 2 * RW, a.w_proj,
                                                   Epi<T, float>{a.b_proj, qkv + 4 * RW, nullptr, nullptr, 0}, a.out,
                                                   R, W, a.hidden);
}

template <typename T>
cudaError_t max_grid(int* grid) {
  auto kernel = fused_layer_kernel<T>;
  constexpr size_t smem = layer_smem<T>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  *grid = per_sm * gemm::sm_count();
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(LayerArgs<T> a, int grid, cudaStream_t stream) {
  int fit = 0;
  cudaError_t err = max_grid<T>(&fit);
  if (err != cudaSuccess) return err;
  if (grid <= 0) grid = fit;
  if (grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_layer_kernel<T>), dim3(grid),
                                    dim3(kThreads), args, layer_smem<T>(), stream);
  // A refused launch (a grid the card cannot hold) also records its error as
  // the thread's last error; read it here, or the next wrapper's
  // cudaGetLastError would report it as its own launch's failure.
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out [B, T, W] in the compute dtype (0 float32, 1 bfloat16); w_qkv
// [W, 3W], w_fc [W, H], w_proj [H, W] in it; w_out32 [W, W] f32 (the
// dtype's values); LayerNorm parameters and biases f32.  ws: f32 workspace
// of 5 B T W; wsd: the dtype's of B T (2W + H).  Head dim 64, H a multiple
// of 8; every pointer 16-byte aligned.  grid 0: as many blocks as the card
// holds at once; a larger grid is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int tapclip_fused_layer(const void* x, const void* gamma1, const void* beta1, const void* w_qkv,
                                   const void* b_qkv, const void* w_out32, const void* b_out,
                                   const void* gamma2, const void* beta2, const void* w_fc, const void* b_fc,
                                   const void* w_proj, const void* b_proj, void* ws, void* wsd, void* out,
                                   int B, int T, int W, int n_heads, int H, int valid, float eps, int grid,
                                   int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W != n_heads * kDh || H <= 0 || H % 8 || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_qkv) |
                         reinterpret_cast<uintptr_t>(w_out32) | reinterpret_cast<uintptr_t>(w_fc) |
                         reinterpret_cast<uintptr_t>(w_proj) | reinterpret_cast<uintptr_t>(ws) |
                         reinterpret_cast<uintptr_t>(wsd) | reinterpret_cast<uintptr_t>(out);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define TAPCLIP_LAYER(TT)                                                                                         \
  return launch<TT>(                                                                                  \
      LayerArgs<TT>{static_cast<const TT*>(x), f(gamma1), f(beta1), static_cast<const TT*>(w_qkv), f(b_qkv),      \
                    f(w_out32), f(b_out), f(gamma2), f(beta2), static_cast<const TT*>(w_fc), f(b_fc),              \
                    static_cast<const TT*>(w_proj), f(b_proj), static_cast<float*>(ws), static_cast<TT*>(wsd),     \
                    static_cast<TT*>(out), B, n_heads, T, W, H, valid, eps},                                      \
      grid, s);
  if (dtype == 0) TAPCLIP_LAYER(float)
  if (dtype == 1) TAPCLIP_LAYER(bf16)
#undef TAPCLIP_LAYER
  return cudaErrorInvalidValue;
}

// Blocks of the persistent grid the card holds at once (T and W do not
// change it: every phase's shared memory is fixed by the head dim and the
// tiles), or 0 where not one fits; -1 on an error.
extern "C" int tapclip_fused_layer_max_grid(int T, int W, int dtype) {
  (void)T;
  (void)W;
  int grid = 0;
  cudaError_t err = dtype == 0 ? max_grid<float>(&grid) : dtype == 1 ? max_grid<bf16>(&grid) : cudaErrorInvalidValue;
  return err == cudaSuccess ? grid : -1;
}
