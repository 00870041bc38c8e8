// Weight-gradient products and reductions of the backward kernels B4
// (attn_block_bwd.cu) and B5 (mlp_bwd.cu), run by their wrappers only when a
// weight gradient is wanted (never on the prompt-tuning path, where the CLIP
// weights are frozen).
//
// Replaces the grid-resident weight-gradient accumulators of
// tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel and
// tapclip_tpu/ops/fused_mlp.py::_mlp_bwd_kernel.  On a TPU those kernels add
// each row tile's dW into an f32 block that stays in VMEM across the
// sequential grid.  Hopper blocks run in no order, so the reduction over rows
// is a deterministic pass of its own:
//
//   gemm_f32:  C[M, N] = op(A) @ op(B) (+ bias[N]) in f32, op = identity or
//              transpose on one side.  With A transposed it is the A^T . B
//              over rows that gives every dW (y^T . dqkv, o^T . g, y^T . dh_pre,
//              h^T . g).  A dispatcher onto gemm_mma.cuh's tensor-core kernels
//              (TA for a transposed A, TB for a transposed B): bf16 operands
//              exact, one MMA a product; f32 operands in three bf16 terms, six
//              MMAs a product with a rounded f32 add per 16-deep step.  The
//              rows (the depth) split S ways into f32 partials [S, M, N] in a
//              workspace the wrapper allocates, each part over whole 32-row
//              stages; sum_parts adds them in the order s = 0, 1, ... and the
//              bias after them.  No atomics: a call repeats bit for bit.
//   col_sum:   out[c, N] = sum over a chunk of rows of in[R, N], one thread
//              per column, rows in order; run twice (row chunks, then the
//              chunk partials) for the bias, gamma and beta gradients.
//
// What bounds it on the card: the tensor cores.  A dW product at the
// pretraining image shape (ViT-B/16, batch 32: 6,400 rows, W 768) is
// 2 x 6,400 x 768 x 2,304 to 3,072 operations, 23 to 30 GFLOP: 0.023 to
// 0.031 ms of bf16 MMAs at 989 TFLOP/s, six times that in f32; its bytes
// (operands read once, C written once) take a third of that time.  So the
// tiles are large, 128 x 128 in bf16 and 128 x 64 in f32 (the operands
// re-read from L2 half as often as with 64 x 64), and the split of the rows
// fills the card where the tiles alone are few (o^T . g at W 768: 36 tiles of
// 128 x 128, split 7 ways).  tile_n and split_for pick them from
// time_half_blocks.py --kernels dW,dWgrid.  Measured there on an H100 80GB
// HBM3 at 700 W, at 6,400 rows: bf16 0.10-0.15 ms (about 220 TFLOP/s of
// MMAs, 3x torch.mm's time), f32 0.17-0.63 ms (torch.mm's f32 time:
// six MMAs a product at about 300 TFLOP/s).  A ring of 3, 4 or 5 stages, and
// 128 x 256 tiles of 64 x 64 warp tiles at one block an SM, read the same in
// bf16: neither the copies' latency nor ldmatrix's share of the shared
// memory sets the pace; wgmma and TMA are the levers.
#include <stdint.h>

#include "common.cuh"
#include "gemm_mma.cuh"

namespace {

using namespace tapclip;
using gemm::bf16;

constexpr int kColThreads = 256;  // col_sum: a thread per column
constexpr int kSumThreads = 256;  // sum_parts: four columns a thread
constexpr int kMaxSplit = 8;      // parts of the rows at most
constexpr int kMinStages = 8;     // 32-row stages a part at least (256 rows)

// The split's cost model, fitted to time_half_blocks.py --kernels dWgrid on
// an H100 80GB HBM3 at 700 W (the four image products at 6,400 rows, the
// two text ones at 2,560): us a 32-row stage takes with the block alone on
// its SM and with two sharing it (bf16 on 128 x 128 tiles, f32 on 128 x 64),
// and each part past the first: its partial written and read again (8
// bytes an element of C at about 3.5 TB/s) and the sum's launch.  A wave
// count alone (the least S of the fewest stages on the busiest SM) lands up
// to 14% past each shape's best there, gemm_mma.cuh's depth_split rule up to
// 40%; this model within 2% (PERF.md, PR 18).
struct StageUs {
  double alone, pair;
};
constexpr StageUs kStageUs[2] = {{1.69, 2.65}, {0.57, 0.90}};  // float32, bfloat16
constexpr double kPartUsPerElem = 8.0 / 3.5e6;
constexpr double kSumUs = 3.0;

// c[e] = parts[0][e] + parts[1][e] + ... + parts[S - 1][e] (+ bias[col]), in
// that order, four columns of one row a thread (N % 4 == 0).  parts may be
// c itself (S 1: the bias alone).
__global__ void __launch_bounds__(kSumThreads)
sum_parts_kernel(const float* parts, int S, const float* __restrict__ bias, float* c, size_t quads, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= quads) return;
  const float4* p = reinterpret_cast<const float4*>(parts) + i;
  float4 v = p[0];
  for (int s = 1; s < S; ++s) {
    const float4 w = p[s * quads];
    v.x += w.x;
    v.y += w.y;
    v.z += w.z;
    v.w += w.w;
  }
  if (bias != nullptr) {
    const int col = static_cast<int>((4 * i) % N);
    v.x += bias[col];
    v.y += bias[col + 1];
    v.z += bias[col + 2];
    v.w += bias[col + 3];
  }
  reinterpret_cast<float4*>(c)[i] = v;
}

// out[chunk, n] = sum of in[r, n] over the chunk's rows, in row order.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_sum_kernel(const T* __restrict__ in, float* __restrict__ out, int R, int N, int rows_per_chunk) {
  const int n = blockIdx.x * kColThreads + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(in[static_cast<size_t>(r) * N + n]);
  out[static_cast<size_t>(blockIdx.y) * N + n] = s;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Elements a copy of a staged row takes (8 or 4 in bf16, 4 in f32), or 0
// where the kernels refuse the operands: both transposed, N or a stored row
// length (A's: K, or M when TA; B's: N, or K when TB) not a multiple of 4,
// an operand not 16-byte (f32) or 8-byte (bf16) aligned.
int copy_elems(const void* a, const void* b, int M, int N, int K, int ta, int tb, int dtype) {
  const int la = ta ? M : K, lb = tb ? K : N;
  if ((ta && tb) || N % 4 || la % 4 || lb % 4) return 0;
  if (dtype == 0) return aligned(a, 16) && aligned(b, 16) ? 4 : 0;
  if (la % 8 == 0 && lb % 8 == 0 && aligned(a, 16) && aligned(b, 16)) return 8;
  return aligned(a, 8) && aligned(b, 8) ? 4 : 0;
}

// The tile of C a dtype takes (dtype 0 float32, 1 bfloat16): 128 x 128 in
// bf16; in f32 128 x 64, whose 128 registers a thread hold its accumulators
// without spilling (128 x 128 spills about 250 bytes, and reads 5-14%
// slower at the pretraining shapes: PERF.md, PR 18).
constexpr int kTileM = 128;
constexpr int tile_n(int dtype) { return dtype == 0 ? 64 : 128; }

// The split of the rows: the S in [1, kMaxSplit], each part at least
// kMinStages stages deep, of the least modelled time: the busiest SM's
// blocks (tiles x S over the SMs, two at a time) times a part's stages, plus
// the partials' cost; ties go to the smaller S.
int split_for(int M, int N, int K, int dtype) {
  const long tiles = static_cast<long>((M + kTileM - 1) / kTileM) * ((N + tile_n(dtype) - 1) / tile_n(dtype));
  const long sms = gemm::sm_count();
  const long nk = (K + gemm::kBK - 1) / gemm::kBK;
  const StageUs& t = kStageUs[dtype == 0 ? 0 : 1];
  int best = 1;
  double best_us = 0.0;
  for (int S = 1; S <= kMaxSplit && (S == 1 || nk / S >= kMinStages); ++S) {
    const long n = (tiles * S + sms - 1) / sms;  // blocks on the busiest SM
    double us = static_cast<double>((nk + S - 1) / S) * ((n / 2) * t.pair + (n % 2) * t.alone);
    if (S > 1) us += kSumUs + (S - 1) * kPartUsPerElem * M * N;
    if (S == 1 || us < best_us) {
      best = S;
      best_us = us;
    }
  }
  return best;
}

template <typename T, int BM, int BN, int CE>
cudaError_t launch_layout(const T* A, const T* B, float* out, int M, int N, int K, int ta, int tb, int S,
                          cudaStream_t s) {
  const gemm::Epi<T> e{};
  if (ta) return gemm::launch_gemm<BM, BN, CE, gemm::kStore, false, float, true>(A, B, e, out, M, N, K, S, s);
  if (tb) return gemm::launch_gemm<BM, BN, CE, gemm::kStore, true, float>(A, B, e, out, M, N, K, S, s);
  return gemm::launch_gemm<BM, BN, CE, gemm::kStore, false, float>(A, B, e, out, M, N, K, S, s);
}

}  // namespace

// The split of the rows (the depth K) that tapclip_gemm_f32_ws takes for
// C[M, N] in a dtype (0 float32, 1 bfloat16).
extern "C" int tapclip_gemm_f32_split(int M, int N, int K, int dtype) { return split_for(M, N, K, dtype); }

// C[M, N] (f32) = op(A) @ op(B) + bias (bias may be null), the rows split S
// ways (ws: f32 [S, M, N] when S > 1, else unused).  A and B share the
// dtype: 0 float32, 1 bfloat16.  trans_a: A is stored [K, M]; trans_b: B is
// stored [N, K].  cudaErrorInvalidValue for what the kernels refuse
// (copy_elems).
extern "C" int tapclip_gemm_f32_ws(const void* a, const void* b, const void* bias, void* c, void* ws, int M, int N,
                                   int K, int trans_a, int trans_b, int dtype, int S, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || S < 1 || S > kMaxSplit || (S > 1 && ws == nullptr) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int ce = copy_elems(a, b, M, N, K, trans_a, trans_b, dtype);
  if (ce == 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(S > 1 ? ws : c);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_layout<float, kTileM, tile_n(0), 4>(static_cast<const float*>(a), static_cast<const float*>(b), out,
                                                       M, N, K, trans_a, trans_b, S, s);
  } else if (ce == 8) {
    err = launch_layout<bf16, kTileM, tile_n(1), 8>(static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, M,
                                                      N, K, trans_a, trans_b, S, s);
  } else {
    err = launch_layout<bf16, kTileM, tile_n(1), 4>(static_cast<const bf16*>(a), static_cast<const bf16*>(b), out, M,
                                                      N, K, trans_a, trans_b, S, s);
  }
  if (err != cudaSuccess || (S == 1 && bias == nullptr)) return err;
  const size_t quads = static_cast<size_t>(M) * N / 4;
  sum_parts_kernel<<<static_cast<unsigned>((quads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, s>>>(
      out, S, static_cast<const float*>(bias), static_cast<float*>(c), quads, N);
  return cudaGetLastError();
}

// tapclip_gemm_f32_ws with the whole depth in every block (S 1): the
// interface of the FMA design before it, for timing trees against each
// other.
extern "C" int tapclip_gemm_f32(const void* a, const void* b, const void* bias, void* c, int M, int N, int K,
                                int trans_a, int trans_b, int dtype, void* stream) {
  return tapclip_gemm_f32_ws(a, b, bias, c, nullptr, M, N, K, trans_a, trans_b, dtype, 1, stream);
}

// out[ceil(R / rows_per_chunk), N] (f32): column sums of in[R, N] over each
// chunk of rows_per_chunk rows.  dtype 0 float32, 1 bfloat16.
extern "C" int tapclip_col_sum(const void* in, void* out, int R, int N, int rows_per_chunk, int dtype,
                               void* stream) {
  if (R <= 0 || N <= 0 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kColThreads - 1) / kColThreads, (R + rows_per_chunk - 1) / rows_per_chunk);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    col_sum_kernel<float><<<grid, kColThreads, 0, s>>>(static_cast<const float*>(in), o, R, N, rows_per_chunk);
  } else if (dtype == 1) {
    col_sum_kernel<__nv_bfloat16><<<grid, kColThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in), o, R, N, rows_per_chunk);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
