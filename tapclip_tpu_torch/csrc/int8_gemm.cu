// S6: the bare int8 product C[M, N] = A[M, K] . B[K, N], int8 x int8 summed
// exactly in int32, returned as int32 or as its f32 value.
//
// Replaces scripts/int8_probe.py::mm_kernel, the probe that timed the int8
// product (int8 -> int32 and int8 -> f32, make_mm) that B13 (int8_mlp.cu)
// and B14 (int8_attn.cu) are built from.  The wrapper is
// tapclip_tpu_torch/ops/int8_gemm.py::int8_gemm; nothing on the serving path
// calls it (B13 and B14 carry their products inside their own kernels).
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
//   2. The product on the int8 tensor cores (int8_mma.cuh): a block of 8
//      warps owns a 128 x 128 tile of C (64 x 128 when 128-row tiles would
//      not give every SM two blocks) and walks K in 64-byte steps through a
//      three-stage cp.async ring (16-byte copies of A's rows when K % 16 == 0,
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

constexpr int kThreads = 256;
constexpr int kBN = 128;           // C tile columns
constexpr int kBK = 64;            // depth of a stage, bytes
constexpr int kLd = kBK + 16;      // shared row stride, bytes
constexpr int kStages = 3;
constexpr int kTr = 64;            // transpose tile edge

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

template <int BM>
constexpr size_t gemm_smem() {
  return static_cast<size_t>(kStages) * (BM + kBN) * kLd;
}

// C[M, N] = A[M, K] . Bt[N, Kp]^T.  A16: K % 16 == 0 and A 16-byte aligned.
template <int BM, bool A16, bool F32>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, void* __restrict__ c, int M,
                 int N, int K, int Kp) {
  constexpr int WM = BM / 2;  // warps 2 (rows) x 4 (columns)
  constexpr int MT = WM / 16;
  constexpr int NT = kBN / 4 / 8;
  static_assert(BM * (kBK / 16) % kThreads == 0 && kBN * (kBK / 16) % kThreads == 0, "whole copies a thread");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* a_s = smem;                          // [kStages][BM][kLd]
  int8_t* b_s = smem + kStages * BM * kLd;     // [kStages][kBN][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int nk = Kp / kBK;

  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * kBK;
    int8_t* as = a_s + s * BM * kLd;
    int8_t* bs = b_s + s * kBN * kLd;
    if (A16) {
#pragma unroll
      for (int it = 0; it < BM * (kBK / 16) / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / (kBK / 16), e = (i % (kBK / 16)) * 16;
        const bool in = m0 + r < M && k0 + e < K;
        mma::cp_async16(as + r * kLd + e, a + (in ? static_cast<size_t>(m0 + r) * K + k0 + e : 0), in);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BM * (kBK / 4) / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int r = i / (kBK / 4), e = (i % (kBK / 4)) * 4;
        const bool in = m0 + r < M && k0 + e < K;
        mma::cp_async4(as + r * kLd + e, a + (in ? static_cast<size_t>(m0 + r) * K + k0 + e : 0), in);
      }
    }
#pragma unroll
    for (int it = 0; it < kBN * (kBK / 16) / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (kBK / 16), e = (i % (kBK / 16)) * 16;
      const bool in = n0 + r < N;
      mma::cp_async16(bs + r * kLd + e, bt + (in ? static_cast<size_t>(n0 + r) * Kp + k0 + e : 0), in);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    const int8_t* as = a_s + (kt % kStages) * BM * kLd;
    const int8_t* bs = b_s + (kt % kStages) * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma8::load_a<kLd>(af[i], as, wm * WM + 16 * i, kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b0[2], b1[2];
        mma8::load_b<kLd>(b0, b1, bs, wn * (kBN / 4) + 8 * j, kk);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma8::mma16832(acc[i][j], af[i], b0);
          mma8::mma16832(acc[i][j + 1], af[i], b1);
        }
      }
    }
  }
  mma::cp_wait<0>();

  // Row g (+ 8) of each 16-row tile, columns 2t and 2t + 1 of each 8-column tile.
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (N & 1) == 0;  // then col even and col < N give col + 1 < N, 8-byte aligned
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + 16 * i + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * (kBN / 4) + 8 * j + 2 * t;
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

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}

template <int BM, bool A16, bool F32>
cudaError_t launch_gemm(const int8_t* a, const int8_t* bt, void* c, int M, int N, int K, int Kp, cudaStream_t s) {
  auto kernel = int8_gemm_kernel<BM, A16, F32>;
  cudaError_t err = allow_smem(kernel, gemm_smem<BM>());
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, gemm_smem<BM>(), s>>>(a, bt, c, M, N, K, Kp);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_gemm(const int8_t* a, const int8_t* bt, void* c, int M, int N, int K, int Kp, bool a16,
                        bool f32, cudaStream_t s) {
  if (a16) return f32 ? launch_gemm<BM, true, true>(a, bt, c, M, N, K, Kp, s)
                      : launch_gemm<BM, true, false>(a, bt, c, M, N, K, Kp, s);
  return f32 ? launch_gemm<BM, false, true>(a, bt, c, M, N, K, Kp, s)
             : launch_gemm<BM, false, false>(a, bt, c, M, N, K, Kp, s);
}

}  // namespace

// Bytes of the wrapper's scratch for Bt [N, Kp]: N * tapclip_int8_gemm_kp(K).
extern "C" int tapclip_int8_gemm_kp(int K) { return (K + kBK - 1) / kBK * kBK; }

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
  const int Kp = tapclip_int8_gemm_kp(K);
  const dim3 tgrid((N + kTr - 1) / kTr, Kp / kTr);
  const bool w4 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  if (w4) transpose_kernel<true><<<tgrid, kThreads, 0, s>>>(B, Bt, K, N, Kp);
  else transpose_kernel<false><<<tgrid, kThreads, 0, s>>>(B, Bt, K, N, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool a16 = K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool f32 = out_f32 != 0;
  const long tiles128 = static_cast<long>((M + 127) / 128) * ((N + kBN - 1) / kBN);
  if (tiles128 >= 2L * sm_count()) return launch_gemm<128>(A, Bt, c, M, N, K, Kp, a16, f32, s);
  return launch_gemm<64>(A, Bt, c, M, N, K, Kp, a16, f32, s);
}
