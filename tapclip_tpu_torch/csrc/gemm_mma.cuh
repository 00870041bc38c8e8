// The tiled tensor-core GEMM of K1 (fused_mlp.cu), K2 (attn_block.cu), B4
// (attn_block_bwd.cu), B5 (mlp_bwd.cu) and gemm.cu's weight-gradient
// products:  C[M, N] = epilogue(op(A) . op(B)), A row major [M, K] or, when
// TA, [K, M] (the A of A^T X: dW = y^T . dqkv over rows), B either [K, N]
// row major or [N, K] row major (TB: the B of A X^T, as the cotangent
// products g . w_proj^T and dh_pre . w_fc^T read their weights).
//
// A block owns a BM x BN tile of C, 8 warps as Warps<BM, BN> (2 x 4, or
// 4 x 2 for the 128 x 64 tile), each a WM x WN sub-tile (launch_pass picks
// BM 64, or 32 where 64-row tiles would not give every SM two blocks;
// gemm.cu takes 128 x 128 or 128 x 64); the depth runs in 32-deep stages
// with zeros past every edge; mma.sync m16n8k16 bf16 with f32 accumulation
// from ldmatrix fragments (flash_mma.cuh: .trans for a row major [K, N] B
// and for a [K, M] A, plain for a [N, K] B and an [M, K] A).
//   * bf16 (gemm_bf16_kernel): exact bf16 operands staged by a three-stage
//     ring of 16-byte cp.async copies (8-byte when a row length is not a
//     multiple of 8 or an operand is not 16-byte aligned); one MMA a product.
//   * f32 (gemm_f32_kernel): each operand splits into three bf16 terms, six
//     MMAs a product (mma::mma_split), each 16-deep step's partial products
//     summed from 0 and added with a rounded f32 add.  The next stage's f32
//     tiles are loaded into registers while this stage's products run, and
//     split once per block into three bf16 planes in shared memory (two
//     buffers), each plane in the tile's own layout ([kBK, BM] when TA).
// A deterministic split of the depth (gridDim.z = S > 1, kStore only)
// writes S f32 partials [S, M, N], each over whole stages, that the caller
// sums in a fixed order.  No atomics: a call repeats bit for bit.
// Each kernel's body is a device function of its tile (gemm_bf16_tile,
// gemm_f32_tile: the tile's first row and column, the split's index and
// count), which the kernels call with blockIdx / gridDim and a persistent
// kernel (S1, fused_layer.cu; S2's interleaved steps, fused_mlp_variants.cu)
// calls for the tiles it walks.
//
// The epilogues (per element of C, row g (+ 8) of each 16-row tile, columns
// 2t and 2t + 1 of each 8-column tile; N % 4 == 0, so col < N gives
// col + 1 < N):
//   kGelu      C = round(gelu(acc + bias))                 K1 fc
//   kResidual  C = round(resid + (acc + bias))             K1 proj, K2 out-projection
//   kQkv       C (f32) = acc + bias, rounded to the dtype from column col0 on
//                                                          K2's qkv (v rounded, q and k not)
//   kBias      C (f32) = acc + bias                        B5's z = h_pre, B4's qkv
//   kDgelu     C = round(acc * (Phi(z) + z phi(z))), z read from Epi::z;
//              with Epi::h also h = round(z Phi(z)) and z := the unrounded
//              product (for dW_proj and db_fc)             B5's dh_pre
//   kStore     C (f32) = acc, partial blockIdx.z           B5's dy; B4's gh and dy; gemm.cu;
//                                                          S2's interleaved proj
//   kGeluErf3  kGelu with the A&S 3-term erf (common.cuh)  S2's erf3 fc
// kResidual's residual may have another type than the operands (Epi's R):
// S1 adds an f32 mid to a bf16 product and a bf16 x to an f32 one.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "flash_mma.cuh"

// Kernels and their parameter types sit in a named namespace, not an
// anonymous one: nvcc's host stub cannot name a kernel in an anonymous
// namespace nested in a named one.  Each source that includes this header
// instantiates its own templates; the instantiations are identical.
namespace tapclip {
namespace gemm {

using bf16 = __nv_bfloat16;
using mma::kIsF32;

constexpr int kThreads = 256;
constexpr int kBK = 32;  // depth of a stage
constexpr int kStages = 3;
constexpr int kALd = kBK + 8;  // row stride of a [rows, kBK] tile, bf16 elements (80 bytes: ldmatrix conflict-free)

enum Epilogue { kGelu = 0, kResidual = 1, kQkv = 2, kBias = 3, kDgelu = 4, kStore = 5, kGeluErf3 = 6 };

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// What an epilogue reads beside the accumulators (unused members null / 0);
// R: the residual's type (the operands' by default).
template <typename T, typename R = T>
struct Epi {
  const float* bias;  // [N] f32
  const R* resid;     // kResidual: [M, N]
  float* z;           // kDgelu: [M, N] f32 pre-activation (and the unrounded product out, with h)
  T* h;               // kDgelu: round(gelu(z)) [M, N], or null
  int col0;           // kQkv: the first column rounded to T
};

// The 8 warps of a BM x BN tile: kM (rows) x kN (columns), each a WM x WN
// sub-tile of MT 16-row by NT 8-column MMA tiles.  2 x 4, except 4 x 2 for
// a 128-row tile at most 64 wide (32 x 32 sub-tiles, not 64 x 16).
template <int BM, int BN>
struct Warps {
  static constexpr int kM = (BM >= 128 && BN <= 64) ? 4 : 2;
  static constexpr int kN = kThreads / 32 / kM;
  static constexpr int WM = BM / kM, WN = BN / kN;
  static constexpr int MT = WM / 16, NT = WN / 8;
};

// A warp's accumulators.
template <int BM, int BN>
using Acc = float[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4];

// Elements, in bf16, of a staged A tile: [BM, kALd] row major, or
// [kBK, BM + 8] when TA (the tile of A [K, M], read by ldmatrix .trans).
template <int BM, bool TA>
__host__ __device__ constexpr int a_plane() {
  return TA ? kBK * mma::tile_ld<bf16, BM>() : BM * kALd;
}

// Elements, in bf16, of a staged B tile: [kBK, BN + 8] row major
// (mma::load_bt), or [BN, kALd] when TB (mma::load_b).
template <int BN, bool TB>
__host__ __device__ constexpr int b_plane() {
  return TB ? BN * kALd : kBK * mma::tile_ld<bf16, BN>();
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

// acc += the warp's [WM, WN] block of one kBK-deep stage, from NP bf16
// planes of the A tile and NPB of the B tile (plane p of A at as + p *
// a_plane, of B at bs + p * b_plane): per 16-deep step the warp's B
// fragments once, then each 16-row A fragment against them.  NP = NPB = 3:
// six MMAs a product and a rounded f32 add per step; NP = 3, NPB = 1 (B's
// values bf16): three, accumulated in the MMAs (mma::mma_split).
template <int BM, int BN, int NP, bool TB, bool TA, int NPB = NP>
__device__ __forceinline__ void warp_stage(Acc<BM, BN>& acc, const bf16* as, const bf16* bs, int wm, int wn) {
  using Wp = Warps<BM, BN>;
  constexpr int MT = Wp::MT, NT = Wp::NT, WM = Wp::WM, WN = Wp::WN;
  constexpr int kAPlane = a_plane<BM, TA>(), kBPlane = b_plane<BN, TB>();
  constexpr int kATLd = mma::tile_ld<bf16, BM>();
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t b[NT][NPB][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2)
#pragma unroll
      for (int p = 0; p < NPB; ++p) {
        uint32_t b0[1][2], b1[1][2];
        if constexpr (TB) {
          mma::load_b<kBK>(b0, b1, bs + p * kBPlane, wn * WN + 8 * j, kk);
        } else {
          mma::load_bt<BN>(b0, b1, bs + p * kBPlane, kk, wn * WN + 8 * j);
        }
        b[j][p][0] = b0[0][0];
        b[j][p][1] = b0[0][1];
        b[j + 1][p][0] = b1[0][0];
        b[j + 1][p][1] = b1[0][1];
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if constexpr (TA) {  // rows kk.. of the [kBK, BM] tile, transposed: matrix q holds rows 8 (q >> 1)
                             // and columns 8 (q & 1) of the 16 x 16 block, as the A fragment orders them
          mma::ldsm_x4_trans(a[p], as + p * kAPlane + (kk + (l & 7) + ((l >> 4) & 1) * 8) * kATLd + wm * WM +
                                       16 * i + ((l >> 3) & 1) * 8);
        } else {
          mma::ldsm_x4(a[p], as + p * kAPlane + (wm * WM + 16 * i + (l & 7) + ((l >> 3) & 1) * 8) * kALd + kk +
                                 (l >> 4) * 8);
        }
      }
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

// Phi(z) and phi(z) of GELU's derivative, Phi(z) + z phi(z).
__device__ __forceinline__ float dgelu_cdf(float z) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, erff(__fmul_rn(z, kInvSqrt2))));
}

__device__ __forceinline__ float dgelu_pdf(float z) {
  return __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, z), z)), kInvSqrt2Pi);
}

// C = epilogue(acc) for the warp's accumulators (T: the operands' dtype, TC: C's,
// R: the residual's).
template <typename T, typename TC, int BM, int BN, int EPI, typename R = T>
__device__ __forceinline__ void epilogue(const Acc<BM, BN>& acc, const Epi<T, R>& e, TC* __restrict__ C, int M,
                                         int N, int m0, int n0, int wm, int wn) {
  using Wp = Warps<BM, BN>;
  constexpr int MT = Wp::MT, NT = Wp::NT, WM = Wp::WM, WN = Wp::WN;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * WN + 8 * j + 2 * t;
    if (col >= N) continue;
    float bias0 = 0.f, bias1 = 0.f;
    if constexpr (EPI != kDgelu && EPI != kStore) {
      bias0 = e.bias[col];
      bias1 = e.bias[col + 1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (EPI == kGelu) {
          v0 = v0 + bias0;
          v1 = v1 + bias1;
          v0 = 0.5f * v0 * (1.f + erff(v0 * kInvSqrt2));
          v1 = 0.5f * v1 * (1.f + erff(v1 * kInvSqrt2));
        } else if constexpr (EPI == kGeluErf3) {
          v0 = v0 + bias0;
          v1 = v1 + bias1;
          v0 = 0.5f * v0 * (1.f + erf3(v0 * kInvSqrt2));
          v1 = 0.5f * v1 * (1.f + erf3(v1 * kInvSqrt2));
        } else if constexpr (EPI == kResidual) {
          v0 = v0 + bias0;
          v1 = v1 + bias1;
          const float2 r = load_pair(e.resid + off);
          v0 = r.x + v0;
          v1 = r.y + v1;
        } else if constexpr (EPI == kQkv) {
          v0 = v0 + bias0;
          v1 = v1 + bias1;
          if (col >= e.col0) {  // col0 even, so col and col + 1 lie on one side
            v0 = round_to<T>(v0);
            v1 = round_to<T>(v1);
          }
        } else if constexpr (EPI == kBias) {
          v0 = v0 + bias0;
          v1 = v1 + bias1;
        } else if constexpr (EPI == kDgelu) {
          // Each step rounded on its own (no contraction into an fma), so
          // dh_pre is the same whether or not h is wanted too.
          const float2 z = *reinterpret_cast<const float2*>(e.z + off);
          const float c0 = dgelu_cdf(z.x), c1 = dgelu_cdf(z.y);
          v0 = __fmul_rn(v0, __fadd_rn(c0, __fmul_rn(z.x, dgelu_pdf(z.x))));
          v1 = __fmul_rn(v1, __fadd_rn(c1, __fmul_rn(z.y, dgelu_pdf(z.y))));
          if (e.h != nullptr) {
            store_pair(e.h + off, __fmul_rn(z.x, c0), __fmul_rn(z.y, c1));
            *reinterpret_cast<float2*>(e.z + off) = make_float2(v0, v1);
          }
        }
        store_pair(C + off, v0, v1);
      }
  }
}

// The stages [kt0, kt1) of split z of S of the depth (all of them when S
// is 1).  Unsigned as blockIdx.z and gridDim.z, so the kernels compute it as
// they did before their bodies became tile functions.
__device__ __forceinline__ void depth_range(int K, unsigned z, unsigned S, int& kt0, int& kt1) {
  const int nk = (K + kBK - 1) / kBK;
  const int per = (nk + S - 1) / S;
  kt0 = z * per;
  kt1 = min(nk, kt0 + per);
}

// bf16: the BM x BN tile of C at (m0, n0) = epilogue(op(A) . op(B)) over
// split z of S of the depth; tiles staged by a kStages-deep ring of cp.async
// copies of CE elements (N and the stored operands' row lengths multiples of
// 4, and of CE along the copied rows), zeros past every edge.  All kThreads
// threads of the block call it; it reads the block's dynamic shared memory
// from its start.
template <int BM, int BN, int CE, int EPI, bool TB, typename TC, bool TA = false, typename R = bf16>
__device__ __forceinline__ void gemm_bf16_tile(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                               const Epi<bf16, R>& e, TC* __restrict__ C, int M, int N, int K,
                                               int m0, int n0, unsigned z, unsigned S) {
  constexpr int kAPlane = a_plane<BM, TA>(), kBPlane = b_plane<BN, TB>();
  constexpr int kATLd = mma::tile_ld<bf16, BM>(), kBLd = mma::tile_ld<bf16, BN>();
  constexpr int kAChunks = BM * kBK / CE, kBChunks = kBK * BN / CE;
  constexpr int kCopy = CE * 2;  // bytes a cp.async
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][A plane]
  bf16* b_s = a_s + kStages * kAPlane;            // [kStages][B plane]
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Warps<BM, BN>::kN, wn = warp % Warps<BM, BN>::kN;
  int kt0, kt1;
  depth_range(K, z, S, kt0, kt1);
  const int nk = kt1 - kt0;
  if (EPI == kStore) C += static_cast<size_t>(z) * M * N;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    bf16* as = a_s + s * kAPlane;
    bf16* bs = b_s + s * kBPlane;
#pragma unroll
    for (int it = 0; it < (kAChunks + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (kAChunks % kThreads != 0 && i >= kAChunks) break;
      if constexpr (TA) {  // A [K, M]: rows k0.., columns m0..
        const int r = i / (BM / CE), c = (i % (BM / CE)) * CE;
        const bool in = k0 + r < K && m0 + c < M;
        cp_async<kCopy>(as + r * kATLd + c, A + (in ? static_cast<size_t>(k0 + r) * M + m0 + c : 0), in);
      } else {  // A [M, K]: rows m0.., columns k0..
        const int r = i / (kBK / CE), c = (i % (kBK / CE)) * CE;
        const bool in = m0 + r < M && k0 + c < K;
        cp_async<kCopy>(as + r * kALd + c, A + (in ? static_cast<size_t>(m0 + r) * K + k0 + c : 0), in);
      }
    }
#pragma unroll
    for (int it = 0; it < (kBChunks + kThreads - 1) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (kBChunks % kThreads != 0 && i >= kBChunks) break;
      if constexpr (TB) {  // B [N, K]: rows n0.., columns k0..
        const int r = i / (kBK / CE), c = (i % (kBK / CE)) * CE;
        const bool in = n0 + r < N && k0 + c < K;
        cp_async<kCopy>(bs + r * kALd + c, B + (in ? static_cast<size_t>(n0 + r) * K + k0 + c : 0), in);
      } else {  // B [K, N]: rows k0.., columns n0..
        const int r = i / (BN / CE), c = (i % (BN / CE)) * CE;
        const bool in = k0 + r < K && n0 + c < N;
        cp_async<kCopy>(bs + r * kBLd + c, B + (in ? static_cast<size_t>(k0 + r) * N + n0 + c : 0), in);
      }
    }
  };

  Acc<BM, BN> acc = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, kt0 + s);
    mma::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, kt0 + nxt);
    mma::cp_commit();
    warp_stage<BM, BN, 1, TB, TA>(acc, a_s + (kt % kStages) * kAPlane, b_s + (kt % kStages) * kBPlane, wm, wn);
  }
  mma::cp_wait<0>();
  epilogue<bf16, TC, BM, BN, EPI, R>(acc, e, C, M, N, m0, n0, wm, wn);
}

template <int BM, int BN, int CE, int EPI, bool TB, typename TC, bool TA = false>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, Epi<bf16> e, TC* __restrict__ C, int M,
                 int N, int K) {
  gemm_bf16_tile<BM, BN, CE, EPI, TB, TC, TA>(A, B, e, C, M, N, K, blockIdx.y * BM, blockIdx.x * BN, blockIdx.z,
                                              gridDim.z);
}

// The NT (three) bf16 terms of four f32 values (one row of a 16-byte chunk)
// into planes 0, 1, 2 at dst, dst + stride, dst + 2 stride: two bf16x2 words
// a plane.
template <int NT = mma::kF32Terms>
__device__ __forceinline__ void split4(const float4 v, bf16* dst, int stride) {
  float x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
#pragma unroll
  for (int p = 0; p < NT; ++p) {
    const uint32_t u0 = mma::pack_bf16(x0, x1), u1 = mma::pack_bf16(x2, x3);
    *reinterpret_cast<uint2*>(dst + p * stride) = make_uint2(u0, u1);
    if (p + 1 < NT) {  // exact: x minus its bf16 rounding
      x0 -= __uint_as_float(u0 << 16);
      x1 -= __uint_as_float(u0 & 0xffff0000u);
      x2 -= __uint_as_float(u1 << 16);
      x3 -= __uint_as_float(u1 & 0xffff0000u);
    }
  }
}

// f32: as gemm_bf16_tile, but each stage's f32 tiles come through
// registers (16-byte loads issued before the current stage's products) and
// are split once per block into three bf16 planes in shared memory (two
// buffers): the fragments then load by ldmatrix, and no warp splits an
// operand that another warp of the block splits too.  A and B are read
// through the read-only path (__ldg): a persistent caller writes them in an
// earlier phase, behind a grid barrier, and never reads them before.  NPB,
// B's terms: three, or one where B holds bf16 values (S1's out-projection in
// bf16: three MMAs a product).
template <int BM, int BN, int EPI, bool TB, bool TA = false, typename R = float, int NPB = mma::kF32Terms>
__device__ __forceinline__ void gemm_f32_tile(const float* __restrict__ A, const float* __restrict__ B,
                                              const Epi<float, R>& e, float* __restrict__ C, int M, int N, int K,
                                              int m0, int n0, unsigned z, unsigned S) {
  constexpr int NP = mma::kF32Terms;
  constexpr int kATLd = mma::tile_ld<bf16, BM>(), kBLd = mma::tile_ld<bf16, BN>();
  constexpr int kAPlane = a_plane<BM, TA>(), kBPlane = b_plane<BN, TB>(), kStage = NP * kAPlane + NPB * kBPlane;
  constexpr int kAV = BM * kBK / 4 / kThreads, kBV = kBK * BN / 4 / kThreads;  // 16-byte loads a thread
  static_assert(kAV * 4 * kThreads == BM * kBK && kBV * 4 * kThreads == kBK * BN, "whole loads a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* planes = reinterpret_cast<bf16*>(smem_raw);  // [2][NP A planes, NP B planes]
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Warps<BM, BN>::kN, wn = warp % Warps<BM, BN>::kN;
  int kt0, kt1;
  depth_range(K, z, S, kt0, kt1);
  const int nk = kt1 - kt0;
  if (EPI == kStore) C += static_cast<size_t>(z) * M * N;
  float4 ra[kAV], rb[kBV];

  // Row and column of an A chunk in its tile: [BM, kBK], or [kBK, BM] when TA.
  auto a_rc = [](int i, int& r, int& c) {
    if constexpr (TA) {
      r = i / (BM / 4);
      c = (i % (BM / 4)) * 4;
    } else {
      r = i / (kBK / 4);
      c = (i % (kBK / 4)) * 4;
    }
  };
  // Row and column of a B chunk in its tile: [kBK, BN], or [BN, kBK] when TB.
  auto b_rc = [](int i, int& r, int& c) {
    if constexpr (TB) {
      r = i / (kBK / 4);
      c = (i % (kBK / 4)) * 4;
    } else {
      r = i / (BN / 4);
      c = (i % (BN / 4)) * 4;
    }
  };
  auto fetch = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int v = 0; v < kAV; ++v) {
      int r, c;
      a_rc(threadIdx.x + v * kThreads, r, c);
      const bool in = TA ? (k0 + r < K && m0 + c < M) : (m0 + r < M && k0 + c < K);
      const size_t off = TA ? static_cast<size_t>(k0 + r) * M + m0 + c : static_cast<size_t>(m0 + r) * K + k0 + c;
      ra[v] = in ? __ldg(reinterpret_cast<const float4*>(A + off)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int v = 0; v < kBV; ++v) {
      int r, c;
      b_rc(threadIdx.x + v * kThreads, r, c);
      const bool in = TB ? (n0 + r < N && k0 + c < K) : (k0 + r < K && n0 + c < N);
      const size_t off = TB ? static_cast<size_t>(n0 + r) * K + k0 + c : static_cast<size_t>(k0 + r) * N + n0 + c;
      rb[v] = in ? __ldg(reinterpret_cast<const float4*>(B + off)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&](int buf) {
    bf16* st = planes + buf * kStage;
#pragma unroll
    for (int v = 0; v < kAV; ++v) {
      int r, c;
      a_rc(threadIdx.x + v * kThreads, r, c);
      split4(ra[v], st + r * (TA ? kATLd : kALd) + c, kAPlane);
    }
#pragma unroll
    for (int v = 0; v < kBV; ++v) {
      int r, c;
      b_rc(threadIdx.x + v * kThreads, r, c);
      split4<NPB>(rb[v], st + NP * kAPlane + r * (TB ? kALd : kBLd) + c, kBPlane);
    }
  };

  Acc<BM, BN> acc = {};
  if (nk > 0) {
    fetch(kt0);
    put(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt0 + kt + 1);  // in flight during this stage's products
    const bf16* st = planes + (kt & 1) * kStage;
    warp_stage<BM, BN, NP, TB, TA, NPB>(acc, st, st + NP * kAPlane, wm, wn);
    if (kt + 1 < nk) put((kt + 1) & 1);  // that buffer was last read before the previous barrier
    __syncthreads();
  }
  epilogue<float, float, BM, BN, EPI, R>(acc, e, C, M, N, m0, n0, wm, wn);
}

template <int BM, int BN, int EPI, bool TB, bool TA = false>
__global__ void __launch_bounds__(kThreads, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, Epi<float> e, float* __restrict__ C,
                int M, int N, int K) {
  gemm_f32_tile<BM, BN, EPI, TB, TA>(A, B, e, C, M, N, K, blockIdx.y * BM, blockIdx.x * BN, blockIdx.z, gridDim.z);
}

// Bytes of dynamic shared memory a tile function takes.
template <int BM, int BN, bool TB, bool TA = false>
__host__ __device__ constexpr size_t bf16_tile_smem() {
  return static_cast<size_t>(kStages) * (a_plane<BM, TA>() + b_plane<BN, TB>()) * sizeof(bf16);
}

template <int BM, int BN, bool TB, bool TA = false, int NPB = mma::kF32Terms>
__host__ __device__ constexpr size_t f32_tile_smem() {
  return 2 * static_cast<size_t>(mma::kF32Terms * a_plane<BM, TA>() + NPB * b_plane<BN, TB>()) * sizeof(bf16);
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

// The split of a kStore product's depth K, the least power of two (at most
// max_split, each part at least 256 deep) that gives every SM two blocks of
// 64 x 64 over C [M, N] in bf16 and four in f32 (dtype 0 float32, 1
// bfloat16).  An f32 tile costs six MMAs a product, so a grid's last
// part-wave costs more there than the partials' round trip through L2
// (time_half_blocks.py on an H100 80GB HBM3 at 700 W, B5's dy at R 1,600,
// W 768, 300 tiles: S 2 took 0.551 ms in f32 against 0.593 for S 1, while in
// bf16 S 1 took 0.209 against 0.217).  B4's dy and B5's dy take it.
inline int depth_split(int M, int N, int K, int dtype, int max_split) {
  const long tiles = static_cast<long>((M + 63) / 64) * ((N + 63) / 64);
  const long want = (dtype == 0 ? 4L : 2L) * sm_count();
  int S = 1;
  while (S < max_split && tiles * S < want && K / (2 * S) >= 256) S *= 2;
  return S;
}

template <typename Kernel, typename T, typename TC>
cudaError_t launch(Kernel kernel, size_t smem, int BM, int BN, int S, const T* A, const T* B, const Epi<T>& e,
                   TC* C, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  kernel<<<grid, kThreads, smem, s>>>(A, B, e, C, M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int CE, int EPI, bool TB, typename TC, bool TA = false>
cudaError_t launch_gemm(const bf16* A, const bf16* B, const Epi<bf16>& e, TC* C, int M, int N, int K, int S,
                        cudaStream_t s) {
  constexpr size_t smem = bf16_tile_smem<BM, BN, TB, TA>();
  return launch(gemm_bf16_kernel<BM, BN, CE, EPI, TB, TC, TA>, smem, BM, BN, S, A, B, e, C, M, N, K, s);
}

template <int BM, int BN, int CE, int EPI, bool TB, typename TC, bool TA = false>
cudaError_t launch_gemm(const float* A, const float* B, const Epi<float>& e, TC* C, int M, int N, int K, int S,
                        cudaStream_t s) {
  static_assert(CE == 4, "f32 rows load as 16-byte chunks");
  static_assert(kIsF32<TC>, "f32 operands give an f32 C");
  constexpr size_t smem = f32_tile_smem<BM, BN, TB, TA>();
  return launch(gemm_f32_kernel<BM, BN, EPI, TB, TA>, smem, BM, BN, S, A, B, e, C, M, N, K, s);
}

// C = epilogue(A . B) in BM x BN tiles: 64-row tiles, or 32-row ones when
// 64-row tiles would not give every SM two blocks (S: the depth split,
// gridDim.z; kStore only).
template <typename T, int BN, int CE, int EPI, bool TB = false, typename TC = T>
cudaError_t launch_pass(const T* A, const T* B, const Epi<T>& e, TC* C, int M, int N, int K, cudaStream_t s,
                        int S = 1) {
  if (S < 1 || (S > 1 && EPI != kStore)) return cudaErrorInvalidValue;
  const long tiles64 = static_cast<long>((M + 63) / 64) * ((N + BN - 1) / BN) * S;
  if (tiles64 >= 2L * sm_count()) return launch_gemm<64, BN, CE, EPI, TB, TC>(A, B, e, C, M, N, K, S, s);
  return launch_gemm<32, BN, CE, EPI, TB, TC>(A, B, e, C, M, N, K, S, s);
}

}  // namespace gemm
}  // namespace tapclip
