// Shared products and reductions of the backward kernels B4 (attn_block_bwd.cu)
// and B5 (mlp_bwd.cu).
//
// Replaces the in-body products and the grid-resident weight-gradient
// accumulators of tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel and
// tapclip_tpu/ops/fused_mlp.py::_mlp_bwd_kernel.  On a TPU those kernels add
// each row tile's dW into an f32 block that stays in VMEM across the
// sequential grid.  Hopper blocks run in no order, so the reduction over rows
// is a second, deterministic pass:
//
//   gemm_f32:  C[M, N] = op(A) @ op(B) (+ bias[N]) in f32, with op = identity
//              or transpose on either side.  With A transposed it is the
//              A^T . B over rows that gives every dW (y^T . dqkv, o^T . g,
//              y^T . dh_pre, h^T . g); with B transposed it gives the
//              cotangent products (g . w_out^T, dqkv . w_qkv^T); plain, the
//              recomputed QKV projection.  One block owns a 64 x 64 tile of C
//              and walks the whole reduction axis in order, so the sums do
//              not depend on scheduling.
//   col_sum:   out[c, N] = sum over a chunk of rows of in[R, N], one thread
//              per column, rows in order; run twice (row chunks, then the
//              chunk partials) for the bias, gamma and beta gradients.
//
// What bounds it on the card: inferred, not measured (no profile yet).  By
// its shape a dW product (K = rows = 704 at the text shape) is arithmetic on
// the FMA units in f32, like K2's out-projection (gemm_bias_residual in
// attn_block.cu, same 64 x 64 tiling), which a block-count probe found held
// back by too few warps per SM.  Tensor-core MMA for bf16 and split-K for the
// small dW_out grid (64 tiles at W = 512) are later work.
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;
constexpr int kTile = 64;   // output tile edge
constexpr int kKTile = 32;  // reduction depth per staged tile

// C[M, N] = op(A)[M, K] @ op(B)[K, N] + bias.  A is [M, K] (or [K, M] when
// TRANS_A), B is [K, N] (or [N, K] when TRANS_B).
template <typename T, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ bias, float* __restrict__ c, int M,
                int N, int K) {
  __shared__ float a_s[kTile][kKTile + 1];
  __shared__ float b_s[kKTile][kTile + 1];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    // Stage A: neighbouring threads read neighbouring addresses either way.
    for (int e = tid; e < kTile * kKTile; e += kThreads) {
      int r, kk;
      if (TRANS_A) {
        kk = e / kTile;
        r = e % kTile;
      } else {
        r = e / kKTile;
        kk = e % kKTile;
      }
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K)
        v = to_f(TRANS_A ? a[static_cast<size_t>(k) * M + m] : a[static_cast<size_t>(m) * K + k]);
      a_s[r][kk] = v;
    }
    for (int e = tid; e < kKTile * kTile; e += kThreads) {
      int kk, col;
      if (TRANS_B) {
        col = e / kKTile;
        kk = e % kKTile;
      } else {
        kk = e / kTile;
        col = e % kTile;
      }
      const int n = n0 + col, k = k0 + kk;
      float v = 0.f;
      if (n < N && k < K)
        v = to_f(TRANS_B ? b[static_cast<size_t>(n) * K + k] : b[static_cast<size_t>(k) * N + n]);
      b_s[kk][col] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKTile; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[rg + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cg + 16 * j;
      if (n >= N) continue;
      c[static_cast<size_t>(m) * N + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// out[chunk, n] = sum of in[r, n] over the chunk's rows, in row order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
col_sum_kernel(const T* __restrict__ in, float* __restrict__ out, int R, int N,
               int rows_per_chunk) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(in[static_cast<size_t>(r) * N + n]);
  out[static_cast<size_t>(blockIdx.y) * N + n] = s;
}

template <typename T>
cudaError_t launch_gemm(const void* a, const void* b, const float* bias, float* c,
                        int M, int N, int K, int trans_a, int trans_b,
                        cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (!trans_a && !trans_b) gemm_f32_kernel<T, false, false><<<grid, kThreads, 0, s>>>(A, B, bias, c, M, N, K);
  else if (!trans_a && trans_b) gemm_f32_kernel<T, false, true><<<grid, kThreads, 0, s>>>(A, B, bias, c, M, N, K);
  else if (trans_a && !trans_b) gemm_f32_kernel<T, true, false><<<grid, kThreads, 0, s>>>(A, B, bias, c, M, N, K);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// C[M, N] (f32) = op(A) @ op(B) + bias (bias may be null).  A and B share the
// dtype: 0 float32, 1 bfloat16.  trans_a: A is stored [K, M]; trans_b: B is
// stored [N, K].  Both transposed is refused.
extern "C" int tapclip_gemm_f32(const void* a, const void* b, const void* bias,
                                void* c, int M, int N, int K, int trans_a,
                                int trans_b, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const auto* bs = static_cast<const float*>(bias);
  auto* out = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gemm<float>(a, b, bs, out, M, N, K, trans_a, trans_b, s);
  if (dtype == 1) return launch_gemm<__nv_bfloat16>(a, b, bs, out, M, N, K, trans_a, trans_b, s);
  return cudaErrorInvalidValue;
}

// out[ceil(R / rows_per_chunk), N] (f32): column sums of in[R, N] over each
// chunk of rows_per_chunk rows.  dtype 0 float32, 1 bfloat16.
extern "C" int tapclip_col_sum(const void* in, void* out, int R, int N,
                               int rows_per_chunk, int dtype, void* stream) {
  if (R <= 0 || N <= 0 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, (R + rows_per_chunk - 1) / rows_per_chunk);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    col_sum_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(in), o, R, N, rows_per_chunk);
  } else if (dtype == 1) {
    col_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in), o, R, N, rows_per_chunk);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
