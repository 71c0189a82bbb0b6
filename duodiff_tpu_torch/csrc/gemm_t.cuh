// The matrix products of the backward sublayers (K6, K7, K8) as launchers
// over gemm.cuh's kernel, the one bf16 GEMM design:
//
//   launch_gemm_nt      C (M, N) = A B^T, A (M, K), B stored (N, K): dm = dy
//                       Wp^T (bf16 out), dxn = dqkv Wqkv^T and dhp W1^T (fp32
//                       out); launch_gemm_nt_accumulate C += A B^T (the
//                       measuring entry's form 3);
//   launch_weight_grad  out (M, N) fp32 = A^T B, A stored (K, M), B stored
//                       (K, N): dWp = merged^T dy, dWqkv = xn^T dqkv,
//                       dW2 = hgb^T dy, dW1 = xn^T dhp over all K = B*L rows;
//   launch_weight_grad_pair  two of them in one launch, K8's dW2 and dW1
//                       over one row chunk, added to the chunks before.
//
// Replaces: the jax.lax.dot_general contractions of duodiff_tpu/ops/
// pallas_block.py _attn_bwd_kernel (dm = dy Wp^T :283, the weight gradients
// dWp = merged^T dy :347 and dWqkv = xn^T dqkv :351, dxn = dqkv Wqkv^T :360)
// and _mlp_bwd_kernel (dW2 = hgb^T dy :1079, dW1 = xn^T dhp :1092,
// dxn = dhp W1^T :1097), and the same products of _mlp_bwd_partial_kernel.
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

// Row splits of weight gradients with `tiles` output tiles in all over K
// rows, at most kMaxSplits and never more than the K slabs: the count that
// minimises the waves of units on the card's SMs times each unit's slabs,
// plus kSplitCostSlabs a split (the fewest on a tie). At 32,896 rows on 132
// SMs: 16 tiles take 5, 36 take 3, 48 and 64 take 2, 108 take 1, 144 take 6.
inline int weight_grad_splits_for(int tiles, int K) {
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

// The same for one weight gradient with an (M, N) output.
inline int weight_grad_splits(int M, int N, int K) {
  return weight_grad_splits_for(gemm_tiles(M, N), K);
}

// Bytes of the flags a weight gradient with an (M, N) output takes.
inline size_t weight_grad_flags(int M, int N) {
  return static_cast<size_t>(gemm_tiles(M, N)) * sizeof(int);
}

// C (M, N) = A (M, K) B^T with B stored (N, K), row pitches lda and ldb:
// bf16 C rounded once, or fp32 C stored or (accumulate) added to.
template <typename OutT>
inline cudaError_t launch_gemm_nt(const bf16* A, int lda, const bf16* B, int ldb, OutT* C, int M,
                                  int N, int K, cudaStream_t stream, bool pdl = false) {
  if (misaligned16(C)) return cudaErrorMisalignedAddress;
  return launch_gemm_form<false, true>(A, lda, B, ldb, M, N, K, 1,
                                       RowEpilogue<bf16, OutT>{C, nullptr, nullptr, kGeluNone},
                                       stream, pdl);
}

inline cudaError_t launch_gemm_nt_accumulate(const bf16* A, int lda, const bf16* B, int ldb,
                                             float* C, int M, int N, int K,
                                             cudaStream_t stream) {
  if (misaligned16(C)) return cudaErrorMisalignedAddress;
  return launch_gemm_form<false, true>(A, lda, B, ldb, M, N, K, 1,
                                       SplitSumEpilogue{{C, nullptr}, nullptr, 1}, stream);
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
                                       SplitSumEpilogue{{out, nullptr}, flags, 0}, stream);
}

// Two weight gradients over the same K rows in one launch, out0 (M0, N0) =
// A0^T B0 and out1 (M1, N1) = A1^T B1, each A stored (K, M), each B (K, N),
// all packed: the units of both share the card's waves, where each alone
// fills too few tiles. With accumulate, split 0 adds to what out0 / out1
// hold (the sum over K8's row chunks, in chunk order). `flags` holds
// weight_grad_flags(M0, N0) + weight_grad_flags(M1, N1) bytes, zero on entry,
// and the launch leaves them zero (the last split of a tile clears its
// flag), so that a chain of these launches needs one clearing before it.
inline cudaError_t launch_weight_grad_pair(const bf16* A0, const bf16* B0, float* out0,
                                           const bf16* A1, const bf16* B1, float* out1,
                                           int* flags, int M0, int N0, int M1, int N1, int K,
                                           bool accumulate, cudaStream_t stream,
                                           bool pdl = false) {
  if (K == 0) return cudaSuccess;
  if (misaligned16(out0) || misaligned16(out1)) return cudaErrorMisalignedAddress;
  GemmProblems<2> pr;
  cudaError_t err = gemm_problem<true, false>(pr, 0, A0, M0, B0, N0, M0, N0, K);
  if (err == cudaSuccess) err = gemm_problem<true, false>(pr, 1, A1, M1, B1, N1, M1, N1, K);
  if (err != cudaSuccess) return err;
  const int slabs = (K + kGemmBK - 1) / kGemmBK;
  int splits = weight_grad_splits_for(gemm_tiles(M0, N0) + gemm_tiles(M1, N1), K);
  splits = splits < slabs ? splits : slabs;
  if (splits > 1 && flags == nullptr) return cudaErrorInvalidValue;
  return launch_gemm_problems<true, false>(
      pr, K, splits, SplitSumEpilogue{{out0, out1}, flags, accumulate ? 1 : 0}, stream, pdl);
}

}  // namespace
}  // namespace duodiff
