// The launches that B13 (int8_mlp.cu) and B14 (int8_attn.cu) share on the
// int8 tensor cores: the row passes that quantize activations and the two
// products with their dequantizing epilogues.
//
//   ln_quant_kernel    one warp a row: LayerNorm into shared memory
//                      (ln_row_warp), the row's codes and scale; zeroes the
//                      row's max of the next quantizer's input.
//   dequant_kernel     codes . W^T on int8_mma.cuh's block tile (mma.sync
//                      m16n8k32 s8), dequantized (acc t_row) s_col + b_col
//                      into f32 rows: with kGeluMax B13's fc (exact GELU,
//                      each row's |h| max by atomicMax on the non-negative
//                      f32 bits, which no order of the blocks changes), with
//                      kGeluErf3Max the same with the 3-term erf (S5's
//                      erf3); with kQkv B14's QKV product (the columns from
//                      `round_from` on, the v third in the stochastic mode,
//                      rounded to the compute dtype).
//   quant_rows_kernel  one block a row: the codes of a row and its scale
//                      from that max (code_of: the draws of (seed, stream,
//                      row, column), so no tiling moves a draw).
//   proj_kernel        codes . W^T on the same tile, dequantized, + bias +
//                      the residual with one rounding to the dtype.
// The partial modes of tensor parallelism (a rank's hidden columns or heads,
// int8_mlp.cu's tapclip_int8_partial_out / tapclip_int8_epilogue) split
// proj_kernel in two around the all-reduce of its int32 sums:
//   acc_kernel         codes . W^T on the same tile, the int32 sums stored
//                      as they are (the rank's depth; no epilogue).
//   epilogue_kernel    proj_kernel's epilogue alone, elementwise over the
//                      summed int32 rows: the row's scale from its max
//                      (row_scale, as quant_rows_kernel stores it), then
//                      dequant + bias + the residual, one rounding.
// quant_rows_kernel takes `col0`, the global index of the rows' column 0:
// a rank's codes draw the bits of the columns the whole kernel gives them.
// The quantizer's stream (int8_common.cuh) is an argument of the row passes.
// RECIP, a template parameter of the two row passes, is S5's recipmul
// (int8_common.cuh::row_scale); it defaults to off, so B13's and B14's
// instantiations are the kernels they were.  Every float step is the one
// the plain version takes (ops/int8_mlp.py), in its order, and the int32 sums
// and the row maxima are exact.
#pragma once

#include <stdint.h>

#include <algorithm>

#include "int8_common.cuh"
#include "int8_mma.cuh"

// Kernels in a header sit in a named namespace: nvcc's host stub cannot name
// a kernel in an anonymous namespace nested in a named one.
namespace tapclip {
namespace int8k {

// Exact GELU in the plain version's order: (0.5 v) (1 + erf(v / sqrt 2)).
template <bool ERF3>
__device__ __forceinline__ float gelu(float v) {
  const float z = __fmul_rn(v, 0.70710678118654752f);
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, ERF3 ? erf3(z) : erff(z)));
}

// The rows' LayerNorm, codes q [R, Wp] and scale t [R] of quantizer
// `stream`; rmax := 0.  One warp a row; shared memory: kInt8Warps rows of W
// floats.
template <typename T, bool SR, bool RECIP = false>
__global__ void __launch_bounds__(kInt8Threads)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                int8_t* __restrict__ q, float* __restrict__ t, float* __restrict__ rmax, int R, int W, int Wp,
                float eps, uint32_t seed, uint32_t stream) {
  extern __shared__ __align__(16) float y_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kInt8Warps + warp;
  if (row >= R) return;
  float* yr = y_s + static_cast<size_t>(warp) * W;
  ln_row_warp<T, !SR>(x + static_cast<size_t>(row) * W, gamma, beta, W, eps, yr, lane);
  __syncwarp();
  const float s = quantize_row_warp<SR, RECIP>(yr, W, Wp, q + static_cast<size_t>(row) * Wp,
                                                row_key(seed, stream, row), lane);
  if (lane == 0) {
    t[row] = s;
    rmax[row] = 0.f;
  }
}

// The epilogues of dequant_kernel.
constexpr int kGeluMax = 0;      // B13's fc: GELU, each row's |h| max into rmax
constexpr int kQkv = 1;          // B14's QKV: columns from round_from on rounded to T
constexpr int kGeluErf3Max = 2;  // S5's erf3: as kGeluMax with the 3-term erf

// out = epi((a . bt^T) t_row s_col + b_col) [R, N] f32; a [R, Kp], bt [N, Kp]
// K-major int8.
template <int EPI, typename T, int BM>
__global__ void __launch_bounds__(mma8::kGemmThreads, 2)
dequant_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, const float* __restrict__ t_row,
               const float* __restrict__ s_col, const float* __restrict__ b_col, float* __restrict__ out,
               float* __restrict__ rmax, int R, int N, int Kp, int round_from) {
  extern __shared__ __align__(16) int8_t tile_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * mma8::kBN;
  int acc[BM / 32][mma8::kNT][4];
  mma8::gemm_tile<BM, true>(a, bt, tile_smem, R, N, Kp, m0, n0, acc);
  auto epi = [&](int acc_v, float tr, int col) {
    const float v = dequant(acc_v, tr, s_col[col], b_col[col]);
    if constexpr (EPI != kQkv) {
      return gelu<EPI == kGeluErf3Max>(v);
    } else {
      return col >= round_from ? round_to<T>(v) : v;
    }
  };
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mma8::acc_row<BM>(m0, i, hh);
      const bool in = row < R;
      const float tr = in ? t_row[row] : 0.f;
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < mma8::kNT; ++j) {
        const int col = mma8::acc_col(n0, j);
        if (!in || col >= N) continue;
        float* hr = out + static_cast<size_t>(row) * N + col;
        const float v0 = epi(acc[i][j][2 * hh], tr, col);
        m = fmaxf(m, fabsf(v0));
        if (col + 1 >= N) {
          hr[0] = v0;
          continue;
        }
        const float v1 = epi(acc[i][j][2 * hh + 1], tr, col + 1);
        m = fmaxf(m, fabsf(v1));
        if (N & 1) {
          hr[0] = v0;
          hr[1] = v1;
        } else {  // col even: 8-byte aligned
          *reinterpret_cast<float2*>(hr) = make_float2(v0, v1);
        }
      }
      if constexpr (EPI != kQkv) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the quad's lanes share the row
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (in && (threadIdx.x & 3) == 0) atomicMax(reinterpret_cast<int*>(rmax + row), __float_as_int(m));
      }
    }
}

// The codes q [R, Np] of the rows v [R, N] f32 and their scales t (zeros
// past N) from rmax, the rows' largest |v|, for quantizer `stream`; one block
// a row, four columns a thread at a time (one 16-byte load of v where N % 4
// == 0, one 4-byte store of codes).  Column c draws the bits of column
// col0 + c (0 for a whole row).
template <bool SR, bool RECIP = false>
__global__ void __launch_bounds__(kInt8Threads)
quant_rows_kernel(const float* __restrict__ v, const float* __restrict__ rmax, int8_t* __restrict__ q,
                  float* __restrict__ t, int N, int Np, int col0, uint32_t seed, uint32_t stream) {
  const int row = blockIdx.x;
  float inv;
  const float scale = row_scale<RECIP>(rmax[row], inv);
  const uint32_t key = row_key(seed, stream, row);
  const float* vr = v + static_cast<size_t>(row) * N;
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * Np);
  const bool vec = (N & 3) == 0;
  for (int c = 4 * threadIdx.x; c < Np; c += 4 * kInt8Threads) {
    float x[4];
    if (vec && c < N) {
      const float4 f = *reinterpret_cast<const float4*>(vr + c);
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = c + e < N ? vr[c + e] : 0.f;
    }
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t code = c + e < N ? code_of<SR, RECIP>(x[e], scale, inv, key, col0 + c + e) : 0;
      word |= static_cast<uint32_t>(static_cast<uint8_t>(code)) << (8 * e);
    }
    qr[c / 4] = word;
  }
  if (threadIdx.x == 0) t[row] = scale;
}

// out = (a . bt^T) t_row s_col + b_col + x [R, N], one rounding to T; a [R,
// Kp], bt [N, Kp] K-major int8.
template <typename T, int BM>
__global__ void __launch_bounds__(mma8::kGemmThreads, 2)
proj_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, const float* __restrict__ t_row,
            const float* __restrict__ s_col, const float* __restrict__ b_col, const T* __restrict__ x,
            T* __restrict__ out, int R, int N, int Kp) {
  extern __shared__ __align__(16) int8_t tile_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * mma8::kBN;
  int acc[BM / 32][mma8::kNT][4];
  mma8::gemm_tile<BM, true>(a, bt, tile_smem, R, N, Kp, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mma8::acc_row<BM>(m0, i, hh);
      if (row >= R) continue;
      const float tr = t_row[row];
#pragma unroll
      for (int j = 0; j < mma8::kNT; ++j) {
        const int col = mma8::acc_col(n0, j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          const size_t off = static_cast<size_t>(row) * N + col + e;
          out[off] = from_f<T>(
              __fadd_rn(dequant(acc[i][j][2 * hh + e], tr, s_col[col + e], b_col[col + e]), to_f(x[off])));
        }
      }
    }
}

// acc = a . bt^T [R, N] int32, the sums as they are; a [R, Kp], bt [N, Kp]
// K-major int8.
template <int BM>
__global__ void __launch_bounds__(mma8::kGemmThreads, 2)
acc_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, int* __restrict__ out, int R, int N,
           int Kp) {
  extern __shared__ __align__(16) int8_t tile_smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * mma8::kBN;
  int acc[BM / 32][mma8::kNT][4];
  mma8::gemm_tile<BM, true>(a, bt, tile_smem, R, N, Kp, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mma8::acc_row<BM>(m0, i, hh);
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < mma8::kNT; ++j) {
        const int col = mma8::acc_col(n0, j);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < N) out[static_cast<size_t>(row) * N + col + e] = acc[i][j][2 * hh + e];
      }
    }
}

// out = (acc t_row) s_col + b_col + x [R, N], one rounding to T, with t_row
// the scale row_scale gives the row's max rmax (proj_kernel's epilogue on
// summed int32 rows); a grid-stride loop over the elements.
template <typename T>
__global__ void __launch_bounds__(kInt8Threads)
epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ rmax, const float* __restrict__ s_col,
                const float* __restrict__ b_col, const T* __restrict__ x, T* __restrict__ out, int R, int N) {
  const size_t n = static_cast<size_t>(R) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(kInt8Threads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kInt8Threads) {
    const int row = static_cast<int>(i / N), col = static_cast<int>(i % N);
    float inv;
    const float tr = row_scale<false>(rmax[row], inv);
    out[i] = from_f<T>(__fadd_rn(dequant(acc[i], tr, s_col[col], b_col[col]), to_f(x[i])));
  }
}

// Launch one of the tile kernels over an [M, N] output with BM-row tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, int BM, int M, int N, cudaStream_t s, Args... args) {
  const size_t smem = BM == 128 ? mma8::gemm_smem<128>() : mma8::gemm_smem<64>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + mma8::kBN - 1) / mma8::kBN, (M + BM - 1) / BM);
  kernel<<<grid, mma8::kGemmThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T, bool SR, bool RECIP = false>
cudaError_t launch_ln_quant(const T* x, const float* gamma, const float* beta, int8_t* q, float* t, float* rmax,
                            int R, int W, int Wp, float eps, uint32_t seed, uint32_t stream, cudaStream_t s) {
  auto kernel = ln_quant_kernel<T, SR, RECIP>;
  const size_t smem = static_cast<size_t>(kInt8Warps) * W * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(R + kInt8Warps - 1) / kInt8Warps, kInt8Threads, smem, s>>>(x, gamma, beta, q, t, rmax, R, W, Wp, eps,
                                                                        seed, stream);
  return cudaGetLastError();
}

template <bool SR, bool RECIP = false>
cudaError_t launch_quant_rows(const float* v, const float* rmax, int8_t* q, float* t, int R, int N, int Np,
                              int col0, uint32_t seed, uint32_t stream, cudaStream_t s) {
  quant_rows_kernel<SR, RECIP><<<R, kInt8Threads, 0, s>>>(v, rmax, q, t, N, Np, col0, seed, stream);
  return cudaGetLastError();
}

// acc = a . bt^T as int32 at the row tile mma8::tile_m picks.
inline cudaError_t launch_acc(const int8_t* a, const int8_t* bt, int* acc, int R, int N, int Kp, cudaStream_t s) {
  return mma8::tile_m(R, N) == 128 ? launch_tiles(acc_kernel<128>, 128, R, N, s, a, bt, acc, R, N, Kp)
                                   : launch_tiles(acc_kernel<64>, 64, R, N, s, a, bt, acc, R, N, Kp);
}

template <typename T>
cudaError_t launch_epilogue(const int* acc, const float* rmax, const float* s_col, const float* b_col, const T* x,
                            T* out, int R, int N, cudaStream_t s) {
  const size_t n = static_cast<size_t>(R) * N;
  const int blocks = static_cast<int>(std::min<size_t>((n + kInt8Threads - 1) / kInt8Threads, 4096));
  epilogue_kernel<T><<<blocks, kInt8Threads, 0, s>>>(acc, rmax, s_col, b_col, x, out, R, N);
  return cudaGetLastError();
}

// out = (a . bt^T) t_row s_col + b_col + x at the row tile mma8::tile_m picks.
template <typename T>
cudaError_t launch_proj(const int8_t* a, const int8_t* bt, const float* t_row, const float* s_col,
                        const float* b_col, const T* x, T* out, int R, int N, int Kp, cudaStream_t s) {
  return mma8::tile_m(R, N) == 128
             ? launch_tiles(proj_kernel<T, 128>, 128, R, N, s, a, bt, t_row, s_col, b_col, x, out, R, N, Kp)
             : launch_tiles(proj_kernel<T, 64>, 64, R, N, s, a, bt, t_row, s_col, b_col, x, out, R, N, Kp);
}

// out = epi((a . bt^T) t_row s_col + b_col) at the row tile mma8::tile_m picks.
template <int EPI, typename T>
cudaError_t launch_dequant(const int8_t* a, const int8_t* bt, const float* t_row, const float* s_col,
                           const float* b_col, float* out, float* rmax, int R, int N, int Kp, int round_from,
                           cudaStream_t s) {
  return mma8::tile_m(R, N) == 128
             ? launch_tiles(dequant_kernel<EPI, T, 128>, 128, R, N, s, a, bt, t_row, s_col, b_col, out, rmax, R,
                            N, Kp, round_from)
             : launch_tiles(dequant_kernel<EPI, T, 64>, 64, R, N, s, a, bt, t_row, s_col, b_col, out, rmax, R, N,
                            Kp, round_from);
}

}  // namespace int8k
}  // namespace tapclip
