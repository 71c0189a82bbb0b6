// The hidden-activation stage of the MLP sublayer's backward, shared by the
// monolithic kernel K7 (mlp_sublayer_bwd.cu) and the hidden-split kernel K8
// (mlp_sublayer_bwd_split.cu): for each (128 rows, 128 hidden columns) tile,
// h_pre = xn W1 + b1 and dh = dy W2^T in two fp32 accumulators, and in the
// epilogue hgb = bf16(gelu(h_pre)), dhp = dh * gelu'(h_pre) stored as bf16,
// and the tile's fp32 column sums of dhp (db1 partials).
//
// Replaces: the h_pre / hgb / dh / dhp chain of duodiff_tpu/ops/
// pallas_block.py _mlp_bwd_kernel (:1074-1091) and _mlp_bwd_partial_kernel
// (:1206-1220). Hd is the number of hidden columns of THIS call: the whole
// hidden width for K7, one slice for K8, whose w1 then points at the slice's
// first column (row pitch ld_w1 = the whole width), b1 at its first entry
// and w2 at its first row; hgb, dhp (M, Hd) and db1_part (row tiles, Hd)
// are the call's own.
#pragma once

#include "common.cuh"
#include "gemm_t.cuh"

namespace duodiff {
namespace {

// d gelu(h) / dh in fp32 for both forms (pallas_block._gelu_grad).
__device__ __forceinline__ float gelu_grad(float h, int mode) {
  if (mode == kGeluTanh) {
    const float c = 0.79788456080286536f, a = 0.044715f;
    const float t = tanhf(c * (h + a * h * h * h));
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * c * (1.f + 3.f * a * h * h);
  }
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  return cdf + h * phi;
}

__global__ void __launch_bounds__(kTThreads)
mlp_bwd_hidden_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ w1, int ld_w1,
                      const float* __restrict__ b1, const bf16* __restrict__ dy,
                      const bf16* __restrict__ w2, bf16* __restrict__ hgb,
                      bf16* __restrict__ dhp, float* __restrict__ db1_part, int M, int D, int Hd,
                      int gelu_mode) {
  __shared__ __align__(128) GemmSmem sm;
  __shared__ float col_s[2][kTBN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  Acc acc_h[4][2], acc_d[4][2];
  gemm_mainloop<false, false>(sm, acc_h, xn, D, w1, ld_w1, M, Hd, m0, n0, 0, D);
  // W2 (Hd, D) is the (N, K) layout of W2^T
  gemm_mainloop<false, true>(sm, acc_d, dy, D, w2, D, M, Hd, m0, n0, 0, D);

  float* cs_h = reinterpret_cast<float*>(sm.a) + warp * 512;
  float* cs_d = cs_h + 256;
  const int r = lane >> 1, c0 = (lane & 1) * kVec;
  float colp[2][kVec];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) colp[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs_h, acc_h[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(cs_d, acc_d[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < Hd) {
        float hv[kVec], dv[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float h = cs_h[r * 16 + c0 + e] + b1[gc + e];
          hv[e] = gelu(h, gelu_mode);
          dv[e] = cs_d[r * 16 + c0 + e] * gelu_grad(h, gelu_mode);
          colp[j][e] += dv[e];
        }
        const size_t off = static_cast<size_t>(gr) * Hd + gc;
        *reinterpret_cast<uint4*>(hgb + off) = pack8(hv);
        *reinterpret_cast<uint4*>(dhp + off) = pack8(dv);
      }
      __syncwarp();
    }
  }
  // column sums over the warp's 64 rows: lanes of equal parity hold the
  // same 8 columns of 4 rows each
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float v = colp[j][e];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < 2) col_s[wm][wn * 32 + j * 16 + c0 + e] = v;
    }
  }
  __syncthreads();
  const int col = n0 + threadIdx.x;
  if (threadIdx.x < kTBN && col < Hd)
    db1_part[static_cast<size_t>(blockIdx.y) * Hd + col] = col_s[0][threadIdx.x] + col_s[1][threadIdx.x];
}

inline int row_tiles(int M) { return (M + kTBM - 1) / kTBM; }

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

inline cudaError_t launch_mlp_bwd_hidden(const bf16* xn, const bf16* w1, int ld_w1,
                                         const float* b1, const bf16* dy, const bf16* w2,
                                         bf16* hgb, bf16* dhp, float* db1_part, int M, int D,
                                         int Hd, int gelu_mode, cudaStream_t stream) {
  const dim3 grid((Hd + kTBN - 1) / kTBN, row_tiles(M));
  mlp_bwd_hidden_kernel<<<grid, kTThreads, 0, stream>>>(xn, w1, ld_w1, b1, dy, w2, hgb, dhp,
                                                        db1_part, M, D, Hd, gelu_mode);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
