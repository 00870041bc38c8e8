// S6: the bare int8 product C[M, N] = A[M, K] . B[K, N], int8 x int8 summed
// exactly in int32, returned as int32 or as its f32 value.
//
// Replaces scripts/int8_probe.py::mm_kernel, the probe that timed the int8
// product (int8 -> int32 and int8 -> f32, make_mm) that B13 (int8_mlp.cu)
// and B14 (int8_attn.cu) are built from.  The wrapper is
// tapclip_tpu_torch/ops/int8_gemm.py::int8_gemm; nothing on the serving path
// calls it (B13 and B14 carry their products inside their own kernels).
//
// Design: one block of 256 threads owns a 64 x 64 tile of C and walks K in
// steps of 64: A's tile is copied as 32-bit words (four k a word, K % 4 == 0),
// B's tile is read a byte at a time (neighbouring threads on neighbouring
// columns) and packed four k rows to a word in shared memory; each thread
// sums a 4 x 4 patch of C with __dp4a, four products an instruction.  No
// atomics: a tile's sums run in k order, bit for bit repeatable.
//
// What bounds it on the card: at the probe's shape (M 51,200, K 768, N 3,072)
// it does 2 M N K = 242 G int8 operations (0.12 ms at the tensor cores'
// 1,979 TOP/s) and writes a 629 MB int32 C (0.19 ms at 3.35 TB/s), so the
// bound is the bytes; __dp4a runs on the integer units, far below either.
// Tensor-core int8 MMA (mma.sync m16n8k32, then wgmma) is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // C tile edge
constexpr int kKWords = 16;  // 64 k a step, four a word

template <bool F32>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, void* __restrict__ c, int M,
                 int N, int K) {
  __shared__ int a_s[kTile][kKWords + 1];
  __shared__ int b_s[kKWords][kTile + 1];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < K; k0 += 4 * kKWords) {
    for (int e = tid; e < kTile * kKWords; e += kThreads) {
      const int r = e / kKWords, kw = e % kKWords;
      const int m = m0 + r, k = k0 + 4 * kw;
      a_s[r][kw] = (m < M && k < K) ? *reinterpret_cast<const int*>(a + static_cast<size_t>(m) * K + k) : 0;
    }
    for (int e = tid; e < kKWords * kTile; e += kThreads) {
      const int kw = e / kTile, col = e % kTile;
      const int n = n0 + col, k = k0 + 4 * kw;
      uint32_t v = 0;
      if (n < N && k < K) {
        const int8_t* bp = b + static_cast<size_t>(k) * N + n;
        v = static_cast<uint8_t>(bp[0]) | (static_cast<uint32_t>(static_cast<uint8_t>(bp[N])) << 8) |
            (static_cast<uint32_t>(static_cast<uint8_t>(bp[2 * static_cast<size_t>(N)])) << 16) |
            (static_cast<uint32_t>(static_cast<uint8_t>(bp[3 * static_cast<size_t>(N)])) << 24);
      }
      b_s[kw][col] = static_cast<int>(v);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKWords; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[rg + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kw][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
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
      const size_t off = static_cast<size_t>(m) * N + n;
      if (F32) static_cast<float*>(c)[off] = __int2float_rn(acc[i][j]);
      else static_cast<int*>(c)[off] = acc[i][j];
    }
  }
}

}  // namespace

// a [M, K], b [K, N] int8, row major, K a multiple of 4; c [M, N] int32
// (out_f32 0) or float32 (out_f32 1).
extern "C" int tapclip_int8_gemm(const void* a, const void* b, void* c, int M, int N, int K, int out_f32,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4) return cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  if (out_f32) int8_gemm_kernel<true><<<grid, kThreads, 0, s>>>(A, B, c, M, N, K);
  else int8_gemm_kernel<false><<<grid, kThreads, 0, s>>>(A, B, c, M, N, K);
  return cudaGetLastError();
}
