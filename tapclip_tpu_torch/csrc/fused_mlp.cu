// K1: fused MLP half-block, out = x + (gelu(LN(x) @ w_fc + b_fc) @ w_proj + b_proj).
//
// Replaces tapclip_tpu/ops/fused_mlp.py::_mlp_kernel (the pallas_call in
// _fused_mlp_fwd_impl), with its roundings: LayerNorm in f32 with two-pass
// statistics, y rounded to the compute dtype, f32 accumulation, exact GELU
// (erff), h rounded to the compute dtype before the projection, the residual
// and b_proj added in f32 and one rounding at the store.
//
// What bounds it on the card: the products.  At ViT-B/16's image shape
// (R = 8 x 200 rows, W = 768, H = 3,072) it does 2 x 2 R W H = 15 GFLOP
// against 19 MB of f32 weights: 0.225 ms at the f32 FMA peak, 0.092 ms as
// the six bf16 MMAs a product that f32 takes here (below), 0.015 ms in bf16.
//
// Design: three launches on the tensor cores, one K1 call (the wrapper
// allocates the scratch: h [R, H] then y [R, W], in the compute dtype).
//   1. LayerNorm, one warp a row: y = LN(x), rounded to the dtype.
//   2. fc: h = gelu(y . w_fc + b_fc), rounded, in 64 x 128 tiles of h.
//   3. proj: out = x + (h . w_proj + b_proj), in 64 x 64 tiles of out.
// Each product runs 8 warps a block, each a 32 x 32 sub-tile (32 x 16 in
// proj; 32-row tiles, 16-row sub-tiles, when 64-row tiles would not give
// every SM two blocks: the text shapes), the depth in 32-deep stages, zeros
// past every edge, mma.sync m16n8k16 bf16 with f32 accumulation from
// ldmatrix fragments (flash_mma.cuh; .trans for the weights, which are
// [depth, columns] row major).
//   * bf16 (gemm_bf16_kernel): y, h and the weights are exact bf16
//     operands, staged by a three-stage ring of 16-byte cp.async copies
//     (8-byte when a width is not a multiple of 8 or an operand is not
//     16-byte aligned); one MMA a product changes only the order of the f32
//     sums.
//   * f32 (gemm_f32_kernel): each operand splits into three bf16 terms, six
//     MMAs a product (mma::mma_split), and each 16-deep step's partial
//     products are summed from 0 and added with a rounded f32 add: the MMA's
//     own accumulation rounds toward zero, and the projection sums over
//     H = 3,072 (4,096 at ViT-L).  The next stage's f32 tiles are loaded
//     into registers while this stage's products run, and split once per
//     block into three bf16 planes in shared memory (two buffers), so no
//     warp repeats another's split and the fragments load by ldmatrix.
//     Emulated error: python -m tapclip_tpu_torch.scripts.split_error.
// Two tensor-core passes tile both dimensions of both products (600 and 300
// blocks at the image shape) where one fused launch could spread only along
// rows; h makes one round trip through L2 (9.8 MB in bf16, 19.7 MB in f32).
// No atomics: every sum runs in one block in a fixed order, so a call
// repeats bit for bit.
//
// The FMA walk of the earlier K1 (mlp_walk.cuh, fused_mlp.cuh) stays as the
// A/B variants S2 (fused_mlp_variants.cu) and phase B of S1 (fused_layer.cu).
#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace tapclip;
using mma::kIsF32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // depth of a stage
constexpr int kStages = 3;
constexpr int kALd = kBK + 8;  // A tile row stride, bf16 elements (80 bytes: ldmatrix conflict-free)

// The two epilogues.
constexpr int kGelu = 0;      // C = round(gelu(acc + bias))
constexpr int kResidual = 1;  // C = round(resid + (acc + bias))

// y = LN(x) rounded to T, one warp per row (the statistics as the JAX kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
          T* __restrict__ y, int R, int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * W;
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / W;
  float v = 0.f;
  for (int c = lane; c < W; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / W + eps);
  T* yr = y + static_cast<size_t>(r) * W;
  for (int c = lane; c < W; c += 32) yr[c] = from_f<T>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
}

using bf16 = __nv_bfloat16;

// Shared-memory tiles hold bf16: an A tile [BM, kBK] with row stride kALd
// and a B tile [kBK, BN] with row stride BN + 8 (mma::tile_ld, the stride
// mma::load_bt reads), one plane each in bf16, three (the split terms) in f32.
template <int BN>
__host__ __device__ constexpr int b_ld() {
  return mma::tile_ld<bf16, BN>();
}

// 16 or 8 bytes global -> shared; zeros when !in.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16) {
    mma::cp_async16(dst, src, in);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(mma::smem_u32(dst)), "l"(src),
                 "r"(in ? 8 : 0)
                 : "memory");
  }
}

// acc += the warp's [BM / 2, BN / 4] block of one kBK-deep stage, from NP
// bf16 planes of each tile (plane p of A at as + p * BM * kALd, of B at
// bs + p * kBK * b_ld<BN>()): per 16-deep step the warp's B fragments once,
// then each 16-row A fragment against them.  NP = 3: six MMAs a product and
// a rounded f32 add per step (mma::mma_split).
template <int BM, int BN, int NP>
__device__ __forceinline__ void warp_stage(float (&acc)[BM / 32][BN / 32][4], const bf16* as, const bf16* bs,
                                           int wm, int wn) {
  constexpr int MT = BM / 32, NT = BN / 32, WM = BM / 2, WN = BN / 4;
  constexpr int kAPlane = BM * kALd, kBPlane = kBK * b_ld<BN>();
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[NT][NP][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t b0[1][2], b1[1][2];
        mma::load_bt<BN>(b0, b1, bs + p * kBPlane, kk, wn * WN + 8 * j);
        b[j][p][0] = b0[0][0];
        b[j][p][1] = b0[0][1];
        b[j + 1][p][0] = b1[0][0];
        b[j + 1][p][1] = b1[0][1];
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma::ldsm_x4(a[p], as + p * kAPlane + (wm * WM + 16 * i + (l & 7) + ((l >> 3) & 1) * 8) * kALd + kk +
                               (l >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma::mma_split(acc[i][j], a, b[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (kIsF32<T>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  if constexpr (kIsF32<T>) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// C = epilogue(acc) for the warp's accumulators: row g (+ 8) of each 16-row
// tile, columns 2t and 2t + 1 of each 8-column tile; N % 4 == 0, so
// col < N gives col + 1 < N.
template <typename T, int BM, int BN, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BM / 32][BN / 32][4], const float* __restrict__ bias,
                                         const T* __restrict__ resid, T* __restrict__ C, int M, int N, int m0,
                                         int n0, int wm, int wn) {
  constexpr int MT = BM / 32, NT = BN / 32, WM = BM / 2, WN = BN / 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * WN + 8 * j + 2 * t;
    if (col >= N) continue;
    const float bias0 = bias[col], bias1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        float v0 = acc[i][j][2 * h] + bias0, v1 = acc[i][j][2 * h + 1] + bias1;
        if constexpr (EPI == kGelu) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        } else {
          const float2 r = load_pair(resid + off);
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        store_pair(C + off, v0, v1);
      }
  }
}

// bf16: C[M, N] = epilogue(A[M, K] . B[K, N]), all row major; tiles staged
// by a kStages-deep ring of cp.async copies of CE elements (M, N, K
// multiples of 4, and of CE along the copied rows), zeros past every edge.
template <int BM, int BN, int CE, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, const float* __restrict__ bias,
                 const bf16* __restrict__ resid, bf16* __restrict__ C, int M, int N, int K) {
  constexpr int kBLd = b_ld<BN>();
  constexpr int kAChunks = BM * kBK / CE, kBChunks = kBK * BN / CE;
  constexpr int kCopy = CE * 2;  // bytes a cp.async
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][BM][kALd]
  bf16* b_s = a_s + kStages * BM * kALd;          // [kStages][kBK][kBLd]
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warps 2 (rows) x 4 (columns)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    bf16* as = a_s + s * BM * kALd;
    bf16* bs = b_s + s * kBK * kBLd;
#pragma unroll
    for (int it = 0; it < (kAChunks + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (kAChunks % kThreads != 0 && i >= kAChunks) break;
      const int r = i / (kBK / CE), e = (i % (kBK / CE)) * CE;
      const bool in = m0 + r < M && k0 + e < K;
      cp_async<kCopy>(as + r * kALd + e, A + (in ? static_cast<size_t>(m0 + r) * K + k0 + e : 0), in);
    }
#pragma unroll
    for (int it = 0; it < (kBChunks + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (kBChunks % kThreads != 0 && i >= kBChunks) break;
      const int r = i / (BN / CE), e = (i % (BN / CE)) * CE;
      const bool in = k0 + r < K && n0 + e < N;
      cp_async<kCopy>(bs + r * kBLd + e, B + (in ? static_cast<size_t>(k0 + r) * N + n0 + e : 0), in);
    }
  };

  float acc[BM / 32][BN / 32][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    mma::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    mma::cp_commit();
    warp_stage<BM, BN, 1>(acc, a_s + (kt % kStages) * BM * kALd, b_s + (kt % kStages) * kBK * kBLd, wm, wn);
  }
  mma::cp_wait<0>();
  epilogue<bf16, BM, BN, EPI>(acc, bias, resid, C, M, N, m0, n0, wm, wn);
}

// The three bf16 terms of four f32 values (one row of a 16-byte chunk) into
// planes 0, 1, 2 at dst, dst + stride, dst + 2 stride: two bf16x2 words a plane.
__device__ __forceinline__ void split4(const float4 v, bf16* dst, int stride) {
  float x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
#pragma unroll
  for (int p = 0; p < mma::kF32Terms; ++p) {
    const uint32_t u0 = mma::pack_bf16(x0, x1), u1 = mma::pack_bf16(x2, x3);
    *reinterpret_cast<uint2*>(dst + p * stride) = make_uint2(u0, u1);
    if (p + 1 < mma::kF32Terms) {  // exact: x minus its bf16 rounding
      x0 -= __uint_as_float(u0 << 16);
      x1 -= __uint_as_float(u0 & 0xffff0000u);
      x2 -= __uint_as_float(u1 << 16);
      x3 -= __uint_as_float(u1 & 0xffff0000u);
    }
  }
}

// f32: as gemm_bf16_kernel, but each stage's f32 tiles come through
// registers (16-byte loads issued before the current stage's products) and
// are split once per block into three bf16 planes in shared memory (two
// buffers): the fragments then load by ldmatrix, and no warp splits an
// operand that another warp of the block splits too.
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ bias,
                const float* __restrict__ resid, float* __restrict__ C, int M, int N, int K) {
  constexpr int NP = mma::kF32Terms;
  constexpr int kBLd = b_ld<BN>();
  constexpr int kAPlane = BM * kALd, kBPlane = kBK * kBLd, kStage = NP * (kAPlane + kBPlane);
  constexpr int kAV = BM * kBK / 4 / kThreads, kBV = kBK * BN / 4 / kThreads;  // 16-byte loads a thread
  static_assert(kAV * 4 * kThreads == BM * kBK && kBV * 4 * kThreads == kBK * BN, "whole loads a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // [2][NP A planes, NP B planes]
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;
  float4 ra[kAV], rb[kBV];

  auto fetch = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int v = 0; v < kAV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      const int r = i / (kBK / 4), e = (i % (kBK / 4)) * 4;
      ra[v] = (m0 + r < M && k0 + e < K)
                  ? __ldg(reinterpret_cast<const float4*>(A + static_cast<size_t>(m0 + r) * K + k0 + e))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int v = 0; v < kBV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      const int r = i / (BN / 4), e = (i % (BN / 4)) * 4;
      rb[v] = (k0 + r < K && n0 + e < N)
                  ? __ldg(reinterpret_cast<const float4*>(B + static_cast<size_t>(k0 + r) * N + n0 + e))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int buf) {
    bf16* st = planes + buf * kStage;
#pragma unroll
    for (int v = 0; v < kAV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      split4(ra[v], st + (i / (kBK / 4)) * kALd + (i % (kBK / 4)) * 4, kAPlane);
    }
#pragma unroll
    for (int v = 0; v < kBV; ++v) {
      const int i = threadIdx.x + v * kThreads;
      split4(rb[v], st + NP * kAPlane + (i / (BN / 4)) * kBLd + (i % (BN / 4)) * 4, kBPlane);
    }
  };

  float acc[BM / 32][BN / 32][4] = {};
  fetch(0);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);  // in flight during this stage's products
    const bf16* st = planes + (kt & 1) * kStage;
    warp_stage<BM, BN, NP>(acc, st, st + NP * kAPlane, wm, wn);
    if (kt + 1 < nk) put((kt + 1) & 1);  // that buffer was last read before the previous barrier
    __syncthreads();
  }
  epilogue<float, BM, BN, EPI>(acc, bias, resid, C, M, N, m0, n0, wm, wn);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, size_t smem, int BM, int BN, const T* A, const T* B, const float* bias,
                   const T* resid, T* C, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, s>>>(A, B, bias, resid, C, M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int CE, int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias, const bf16* resid, bf16* C, int M, int N,
                        int K, cudaStream_t s) {
  constexpr size_t smem = static_cast<size_t>(kStages) * (BM * kALd + kBK * b_ld<BN>()) * sizeof(bf16);
  return launch(gemm_bf16_kernel<BM, BN, CE, EPI>, smem, BM, BN, A, B, bias, resid, C, M, N, K, s);
}

template <int BM, int BN, int CE, int EPI>
cudaError_t launch_gemm(const float* A, const float* B, const float* bias, const float* resid, float* C, int M,
                        int N, int K, cudaStream_t s) {
  static_assert(CE == 4, "f32 rows load as 16-byte chunks");
  constexpr size_t smem = 2 * mma::kF32Terms * static_cast<size_t>(BM * kALd + kBK * b_ld<BN>()) * sizeof(bf16);
  return launch(gemm_f32_kernel<BM, BN, EPI>, smem, BM, BN, A, B, bias, resid, C, M, N, K, s);
}

// 64-row tiles (fc 64 x 128, proj 64 x 64), or 32-row ones when 64-row tiles
// would not give every SM two blocks (the text shapes).
template <typename T, int BN, int CE, int EPI>
cudaError_t launch_pass(const T* A, const T* B, const float* bias, const T* resid, T* C, int M, int N, int K,
                        cudaStream_t s) {
  const long tiles64 = static_cast<long>((M + 63) / 64) * ((N + BN - 1) / BN);
  if (tiles64 >= 2L * sm_count()) return launch_gemm<64, BN, CE, EPI>(A, B, bias, resid, C, M, N, K, s);
  return launch_gemm<32, BN, CE, EPI>(A, B, bias, resid, C, M, N, K, s);
}

template <typename T, int CE>
cudaError_t launch_mlp(const T* x, const float* gamma, const float* beta, const T* w_fc, const float* b_fc,
                       const T* w_proj, const float* b_proj, T* out, T* ws, int R, int W, int H, float eps,
                       cudaStream_t s) {
  T* h = ws;
  T* y = ws + static_cast<size_t>(R) * H;
  ln_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, s>>>(x, gamma, beta, y, R, W, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_pass<T, 128, CE, kGelu>(y, w_fc, b_fc, nullptr, h, R, H, W, s);
  if (err != cudaSuccess) return err;
  return launch_pass<T, 64, CE, kResidual>(h, w_proj, b_proj, x, out, R, W, H, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  W and H multiples of 4; ws scratch of
// R * (H + W) elements of the dtype; every pointer of the dtype 16-byte
// aligned in float32, 8-byte aligned in bfloat16.
extern "C" int tapclip_fused_mlp(const void* x, const void* gamma, const void* beta,
                                 const void* w_fc, const void* b_fc,
                                 const void* w_proj, const void* b_proj, void* out, void* ws,
                                 int R, int W, int H, float eps, int dtype,
                                 void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_fc) |
                         reinterpret_cast<uintptr_t>(w_proj) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(ws);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* bp = static_cast<const float*>(b_proj);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ptrs & 15) return cudaErrorMisalignedAddress;
    return launch_mlp<float, 4>(static_cast<const float*>(x), g, bt, static_cast<const float*>(w_fc), bf,
                                static_cast<const float*>(w_proj), bp, static_cast<float*>(out),
                                static_cast<float*>(ws), R, W, H, eps, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (ptrs & 7) return cudaErrorMisalignedAddress;
    const auto* X = static_cast<const bf16*>(x);
    const auto* Wf = static_cast<const bf16*>(w_fc);
    const auto* Wp = static_cast<const bf16*>(w_proj);
    if ((ptrs & 15) == 0 && W % 8 == 0 && H % 8 == 0)
      return launch_mlp<bf16, 8>(X, g, bt, Wf, bf, Wp, bp, static_cast<bf16*>(out), static_cast<bf16*>(ws), R, W, H,
                                 eps, s);
    return launch_mlp<bf16, 4>(X, g, bt, Wf, bf, Wp, bp, static_cast<bf16*>(out), static_cast<bf16*>(ws), R, W, H,
                               eps, s);
  }
  return cudaErrorInvalidValue;
}
