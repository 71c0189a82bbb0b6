// The matrix products of the backward sublayers (K6, K7, K8) as launchers
// over gemm.cuh's kernel, the one bf16 GEMM design:
//
//   launch_gemm_nt      C (M, N) = A B^T, A (M, K), B stored (N, K): dm = dy
//                       Wp^T (bf16 out), dxn = dqkv Wqkv^T and dhp W1^T (fp32
//                       out), and with accumulate C += A B^T (K8's dxn
//                       slices after the first);
//   launch_weight_grad  out (M, N) fp32 = A^T B, A stored (K, M), B stored
//                       (K, N): dWp = merged^T dy, dWqkv = xn^T dqkv,
//                       dW2 = hgb^T dy, dW1 = xn^T dhp over all K = B*L rows.
//
// Replaces: the jax.lax.dot_general contractions of duodiff_tpu/ops/
// pallas_block.py _attn_bwd_kernel (dm = dy Wp^T :283, the weight gradients
// dWp = merged^T dy :347 and dWqkv = xn^T dqkv :351, dxn = dqkv Wqkv^T :360)
// and _mlp_bwd_kernel (dW2 = hgb^T dy :1079, dW1 = xn^T dhp :1092,
// dxn = dhp W1^T :1097), and the `dxn + dxn_s` of _mlp_sublayer_bwd_split
// (:1334).
//
// Bound: the weight gradients contract over all B*L rows (32,896 at batch
// 128) into outputs of only 16 to 144 128x128 tiles, too few to fill 132
// SMs. So the rows are split (weight_grad_splits) and gemm.cuh's
// SplitSumEpilogue adds the splits' fp32 tiles in split order, each split
// waiting on a per-tile flag that the one before sets: the deterministic
// replacement of the Pallas kernels' fp32 VMEM accumulators, which sum
// across a grid that runs in order. Hopper's blocks run in no order, and no
// floating-point atomic is used anywhere, so a repeat call gives the same
// bits. The only scratch is the flags, one int a tile (weight_grad_flags).
#pragma once

#include "common.cuh"
#include "gemm.cuh"

namespace duodiff {
namespace {

constexpr int kMaxSplits = 16;  // row splits of a weight gradient at most

inline int gemm_tiles(int M, int N) {
  return ((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
}

// What one more row split costs, in the time of one 64-row slab of a tile's
// products: the ordered sum passes each tile from split to split (flag,
// fence, one read and one write of the fp32 tile from L2), ~5.5 us a link
// on an H100 beside ~0.3 us a slab (chip_smoke.py's check_gemm_t times each
// weight gradient at batch 128 with forced split counts beside this choice).
constexpr int kSplitCostSlabs = 18;

// Row splits of a weight gradient with an (M, N) output over K rows, at most
// kMaxSplits and never more than the K slabs: the count that minimises the
// waves of units on the card's SMs times each unit's slabs, plus
// kSplitCostSlabs a split (the fewest on a tie). At 32,896 rows on 132 SMs:
// 16 tiles take 5, 36 take 3, 48 and 64 take 2, 108 take 1, 144 take 6.
inline int weight_grad_splits(int M, int N, int K) {
  const int tiles = gemm_tiles(M, N);
  const int slabs = (K + kGemmBK - 1) / kGemmBK;
  const int sms = sm_count();
  const int most = slabs < kMaxSplits ? slabs : kMaxSplits;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= most; ++s) {
    const long long waves = (static_cast<long long>(tiles) * s + sms - 1) / sms;
    const long long cost = waves * ((slabs + s - 1) / s) + 1LL * kSplitCostSlabs * s;
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Bytes of the flags a weight gradient with an (M, N) output takes.
inline size_t weight_grad_flags(int M, int N) {
  return static_cast<size_t>(gemm_tiles(M, N)) * sizeof(int);
}

// C (M, N) = A (M, K) B^T with B stored (N, K), row pitches lda and ldb:
// bf16 C rounded once, or fp32 C stored or (accumulate) added to.
template <typename OutT>
inline cudaError_t launch_gemm_nt(const bf16* A, int lda, const bf16* B, int ldb, OutT* C, int M,
                                  int N, int K, cudaStream_t stream) {
  if (misaligned16(C)) return cudaErrorMisalignedAddress;
  return launch_gemm_form<false, true>(A, lda, B, ldb, M, N, K, 1,
                                       RowEpilogue<bf16, OutT>{C, nullptr, nullptr, kGeluNone},
                                       stream);
}

inline cudaError_t launch_gemm_nt_accumulate(const bf16* A, int lda, const bf16* B, int ldb,
                                             float* C, int M, int N, int K,
                                             cudaStream_t stream) {
  if (misaligned16(C)) return cudaErrorMisalignedAddress;
  return launch_gemm_form<false, true>(A, lda, B, ldb, M, N, K, 1,
                                       SplitSumEpilogue{C, nullptr, 1}, stream);
}

// out (M, N) fp32 = A(m, k) B(k, n) over all K rows, A stored (K, M), B
// stored (K, N), both packed; `flags` holds weight_grad_flags(M, N) bytes
// and is zeroed here on the stream. splits 0 takes weight_grad_splits.
inline cudaError_t launch_weight_grad(const bf16* A, const bf16* B, float* out, int* flags, int M,
                                      int N, int K, cudaStream_t stream, int splits = 0) {
  if (misaligned16(A) || misaligned16(B) || misaligned16(out)) return cudaErrorMisalignedAddress;
  if (splits <= 0) splits = weight_grad_splits(M, N, K);
  const int slabs = (K + kGemmBK - 1) / kGemmBK;
  splits = splits < slabs ? splits : slabs;
  if (splits > 1) {
    if (flags == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(flags, 0, weight_grad_flags(M, N), stream);
    if (err != cudaSuccess) return err;
  }
  return launch_gemm_form<true, false>(A, M, B, N, M, N, K, splits > 1 ? splits : 1,
                                       SplitSumEpilogue{out, flags, 0}, stream);
}

}  // namespace
}  // namespace duodiff
