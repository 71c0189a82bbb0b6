// LayerNorm over the rows of a bf16 (M, D) matrix, the first stage of both
// sublayers (K1 and K2 below), or of an fp32 one (the whole-block kernel K5,
// whose second LayerNorm reads the unrounded fp32 residual stream).
//
// Replaces: the in-kernel LayerNorm of duodiff_tpu/ops/pallas_block.py
// (_ln_fwd, called from _kernel_v2 and _mlp_kernel): fp32 two-pass
// statistics (mean, then the mean of squared deviations), eps inside the
// rsqrt, affine in fp32, one rounding to bf16 on the way out (the
// ``xn.astype(x_ref.dtype)`` of _kernel_v2 and _mlp_kernel).
//
// Bound: memory. Per row it reads D bf16 values and writes D, with a few
// flops per byte, far below the card's ~295 flop/byte balance point.
// Design: one warp per row, 16-byte vector loads (8 bf16 per lane per
// trip), the row re-read from L1 for the second and third pass instead of
// being held in registers, so any D that is a multiple of 8 works.
#pragma once

#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kLnThreads = 256;  // 8 warps = 8 rows per block

template <typename InT>
__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const InT* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ y,
                      int M, int D, float eps) {
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const InT* xr = x + static_cast<size_t>(row) * D;
  bf16* yr = y + static_cast<size_t>(row) * D;
  float v[kVec];

  float sum = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    load_row8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += v[e];
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);

  float sq = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    load_row8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);

  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    load_row8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = (v[e] - mean) * rstd * gamma[c + e] + beta[c + e];
    *reinterpret_cast<uint4*>(yr + c) = pack8(v);
  }
}

template <typename InT>
inline cudaError_t launch_layernorm(const InT* x, const float* gamma, const float* beta,
                                    bf16* y, int M, int D, float eps, cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  const int blocks = (M + rows_per_block - 1) / rows_per_block;
  layernorm_rows_kernel<<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y, M, D, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
