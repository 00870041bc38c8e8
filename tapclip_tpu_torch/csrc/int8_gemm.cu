// S6: the bare int8 product C[M, N] = A[M, K] . B[K, N], int8 x int8 summed
// exactly in int32, returned as int32 or as its f32 value.
//
// Replaces scripts/int8_probe.py::mm_kernel, the probe that timed the int8
// product (int8 -> int32 and int8 -> f32, make_mm) that B13 (int8_mlp.cu)
// and B14 (int8_attn.cu) are built from.  The wrapper is
// tapclip_tpu_torch/ops/int8_gemm.py::int8_gemm; nothing on the serving path
// calls it (B13 runs the same block tile walk, int8_mma.cuh's gemm_tile,
// inside its own kernels).
//
// What bounds it on the card: at the probe's shape (M 51,200, K 768, N 3,072)
// it does 2 M N K = 242 G int8 operations (0.12 ms at the tensor cores'
// 1,979 TOP/s) and writes a 629 MB int32 C (0.19 ms at 3.35 TB/s), so the
// bound is the bytes: C is 94% of them.
//
// Design: two launches.
//   1. B [K, N] row major is transposed to Bt [N, Kp] (K-major, Kp = K
//      rounded up to 64, zeros past K): the tensor cores take an int8 B
//      operand K-major only, and ldmatrix .trans cannot transpose bytes.  A
//      block moves a 64 x 64 tile through shared memory, 32-bit words in and
//      out.  Bt's rows are 16-byte aligned whatever N and K are.
//   2. The product on the int8 tensor cores (int8_mma.cuh's gemm_tile): a
//      block of 8 warps owns a 128 x 128 tile of C (64 x 128 when 128-row
//      tiles would not give every SM two blocks) and walks K in 64-byte
//      steps through a three-stage cp.async ring (16-byte copies of A's rows when K % 16 == 0,
//      4-byte copies otherwise; Bt always 16-byte); each warp runs
//      mma.sync m16n8k32 s8 over its 64 x 32 (or 32 x 32) sub-tile, from
//      ldmatrix fragments.  The epilogue stores the fragment's 8-byte pairs
//      with streaming stores: the four lanes of a quad write one 32-byte
//      sector of a row.
// No atomics: every sum runs in one block, in k order; the int32 sums are
// exact, so the result is the same bit for bit whatever the order.
#include <stdint.h>

#include "common.cuh"
#include "int8_mma.cuh"

namespace {

using namespace tapclip;

using mma8::kBN;
using mma8::kGemmThreads;

constexpr int kThreads = kGemmThreads;
constexpr int kTr = 64;  // transpose tile edge

// bt[n][k] = b[k][n] for k < K, 0 for K <= k < Kp.  W4: N % 4 == 0, so B's
// rows are read as aligned 32-bit words.
template <bool W4>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int K, int N, int Kp) {
  __shared__ uint32_t tile[kTr][kTr / 4 + 1];  // [k][n / 4], byte n % 4 of each word
  const int n0 = blockIdx.x * kTr, k0 = blockIdx.y * kTr;
  if (W4) {
    for (int i = threadIdx.x; i < kTr * kTr / 4; i += kThreads) {
      const int k = i / (kTr / 4), w = i % (kTr / 4);
      const int n = n0 + 4 * w;
      tile[k][w] = (k0 + k < K && n < N)
                       ? *reinterpret_cast<const uint32_t*>(b + static_cast<size_t>(k0 + k) * N + n)
                       : 0u;
    }
  } else {
    auto* bytes = reinterpret_cast<uint8_t*>(&tile[0][0]);
    for (int i = threadIdx.x; i < kTr * kTr; i += kThreads) {
      const int k = i / kTr, n = i % kTr;
      bytes[k * 4 * (kTr / 4 + 1) + n] =
          (k0 + k < K && n0 + n < N) ? static_cast<uint8_t>(b[static_cast<size_t>(k0 + k) * N + n0 + n]) : 0;
    }
  }
  __syncthreads();
  const auto* bytes = reinterpret_cast<const uint8_t*>(&tile[0][0]);
  constexpr int kRow = 4 * (kTr / 4 + 1);  // bytes of a tile row
  for (int i = threadIdx.x; i < kTr * kTr / 4; i += kThreads) {
    const int n = i / (kTr / 4), w = i % (kTr / 4);
    if (n0 + n >= N) continue;
    const uint8_t* col = bytes + 4 * w * kRow + n;
    const uint32_t v = col[0] | (static_cast<uint32_t>(col[kRow]) << 8) |
                       (static_cast<uint32_t>(col[2 * kRow]) << 16) | (static_cast<uint32_t>(col[3 * kRow]) << 24);
    *reinterpret_cast<uint32_t*>(bt + static_cast<size_t>(n0 + n) * Kp + k0 + 4 * w) = v;
  }
}

// C[M, N] = A[M, K] . Bt[N, Kp]^T (mma8::gemm_tile).  A16: K % 16 == 0 and A
// 16-byte aligned.
template <int BM, bool A16, bool F32>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, void* __restrict__ c, int M,
                 int N, int K) {
  constexpr int MT = BM / 32;
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  int acc[MT][mma8::kNT][4];
  mma8::gemm_tile<BM, A16>(a, bt, smem, M, N, K, m0, n0, acc);

  // The epilogue stores the fragment's 8-byte pairs with streaming stores.
  const bool pairs = (N & 1) == 0;  // then col even and col < N give col + 1 < N, 8-byte aligned
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mma8::acc_row<BM>(m0, i, h);
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < mma8::kNT; ++j) {
        const int col = mma8::acc_col(n0, j);
        if (col >= N) continue;
        const int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t off = static_cast<size_t>(row) * N + col;
        if (F32) {
          float* cp = static_cast<float*>(c) + off;
          if (pairs) {
            __stcs(reinterpret_cast<float2*>(cp), make_float2(__int2float_rn(v0), __int2float_rn(v1)));
          } else {
            cp[0] = __int2float_rn(v0);
            if (col + 1 < N) cp[1] = __int2float_rn(v1);
          }
        } else {
          int* cp = static_cast<int*>(c) + off;
          if (pairs) {
            __stcs(reinterpret_cast<int2*>(cp), make_int2(v0, v1));
          } else {
            cp[0] = v0;
            if (col + 1 < N) cp[1] = v1;
          }
        }
      }
    }
}

template <int BM, bool A16, bool F32>
cudaError_t launch_gemm(const int8_t* a, const int8_t* bt, void* c, int M, int N, int K, cudaStream_t s) {
  auto kernel = int8_gemm_kernel<BM, A16, F32>;
  constexpr size_t smem = mma8::gemm_smem<BM>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, s>>>(a, bt, c, M, N, K);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_gemm(const int8_t* a, const int8_t* bt, void* c, int M, int N, int K, bool a16, bool f32,
                        cudaStream_t s) {
  if (a16) return f32 ? launch_gemm<BM, true, true>(a, bt, c, M, N, K, s)
                      : launch_gemm<BM, true, false>(a, bt, c, M, N, K, s);
  return f32 ? launch_gemm<BM, false, true>(a, bt, c, M, N, K, s)
             : launch_gemm<BM, false, false>(a, bt, c, M, N, K, s);
}

// Launch 1: bt [N, Kp] = b [K, N]^T, zeros past K.
cudaError_t launch_transpose(const int8_t* b, int8_t* bt, int K, int N, int Kp, cudaStream_t s) {
  const dim3 tgrid((N + kTr - 1) / kTr, Kp / kTr);
  const bool w4 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  if (w4) transpose_kernel<true><<<tgrid, kThreads, 0, s>>>(b, bt, K, N, Kp);
  else transpose_kernel<false><<<tgrid, kThreads, 0, s>>>(b, bt, K, N, Kp);
  return cudaGetLastError();
}

}  // namespace

// B [K, N] int8 row major into Bt [N, tapclip_int8_gemm_kp(K)], K-major with
// zeros past K (16-byte aligned): S6's first launch, and the layout of B13's
// weights (ops/int8_mlp.py::k_major).
extern "C" int tapclip_int8_transpose(const void* b, void* bt, int K, int N, void* stream) {
  if (K <= 0 || N <= 0 || (reinterpret_cast<uintptr_t>(bt) & 15)) return cudaErrorInvalidValue;
  return launch_transpose(static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), K, N, mma8::kp(K),
                          static_cast<cudaStream_t>(stream));
}

// Bytes of the wrapper's scratch for Bt [N, Kp]: N * tapclip_int8_gemm_kp(K).
extern "C" int tapclip_int8_gemm_kp(int K) { return mma8::kp(K); }

// a [M, K], b [K, N] int8, row major, K a multiple of 4 and a 4-byte aligned;
// bt scratch of N * tapclip_int8_gemm_kp(K) bytes, 16-byte aligned; c [M, N]
// int32 (out_f32 0) or float32 (out_f32 1).
extern "C" int tapclip_int8_gemm(const void* a, const void* b, void* bt, void* c, int M, int N, int K, int out_f32,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || (reinterpret_cast<uintptr_t>(a) & 3) ||
      (reinterpret_cast<uintptr_t>(bt) & 15))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  auto* Bt = static_cast<int8_t*>(bt);
  cudaError_t err = launch_transpose(B, Bt, K, N, mma8::kp(K), s);
  if (err != cudaSuccess) return err;
  const bool a16 = K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool f32 = out_f32 != 0;
  if (mma8::tile_m(M, N) == 128) return launch_gemm<128>(A, Bt, c, M, N, K, a16, f32, s);
  return launch_gemm<64>(A, Bt, c, M, N, K, a16, f32, s);
}
