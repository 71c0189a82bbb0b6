// The row-wise ends of the backward sublayers (K6, K7): LayerNorm backward
// fused with the residual and the dgamma / dbeta partial sums, and the
// column sums of the bias gradients.
//
// Replaces: _ln_bwd_dx (duodiff_tpu/ops/pallas_block.py:224) with
// ``dx = dx + dy`` and the dg/db accumulations of _attn_bwd_kernel
// (:364-369) and _mlp_bwd_kernel (:1101-1106), and the bias-gradient sums
// (dbp :281, dbqkv :357, db2 :1070).
//
// Bound: memory. Each row reads x (bf16), dxn (fp32) and dy (bf16) and
// writes dx (bf16), a few flops per byte.
// Determinism: the Pallas kernels add these sums across a grid that runs in
// order. Here each block sums a fixed range of rows into a partial, in row
// order within each warp and then warp by warp, and sum_partials_kernel
// (gemm_t.cuh) adds the partials in block order: two passes, no atomics.
#pragma once

#include "common.cuh"
#include "gemm_t.cuh"

namespace duodiff {
namespace {

constexpr int kLnbThreads = 256;                 // 8 warps, one row each at a time
constexpr int kLnbWarps = kLnbThreads / 32;
constexpr int kLnbRows = 64;                     // rows per block
constexpr int kColRows = 256;                    // rows per column-sum chunk

__device__ __forceinline__ void load8f(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// dx = rstd * (dxh - mean(dxh) - x_hat * mean(dxh * x_hat)) + dy, with
// dxh = dxn * gamma and the forward's fp32 two-pass statistics recomputed
// from x; part_dg / part_db[block][c] = the block's sums of dxn * x_hat and
// dxn. Dynamic shared memory: 2 * kLnbWarps * D floats.
__global__ void __launch_bounds__(kLnbThreads)
layernorm_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                     const float* __restrict__ gamma, const bf16* __restrict__ dy,
                     bf16* __restrict__ dx, float* __restrict__ part_dg,
                     float* __restrict__ part_db, int M, int D, float eps) {
  extern __shared__ float acc_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* my_dg = acc_s + warp * D;
  float* my_db = acc_s + (kLnbWarps + warp) * D;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) my_dg[c + e] = my_db[c + e] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  const int row_end = min(M, (blockIdx.x + 1) * kLnbRows);
  for (int row = blockIdx.x * kLnbRows + warp; row < row_end; row += kLnbWarps) {
    const bf16* xr = x + static_cast<size_t>(row) * D;
    const float* gr = dxn + static_cast<size_t>(row) * D;
    float v[kVec], g[kVec];
    float sum = 0.f;
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[e];
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
      load8f(gr + c, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float x_hat = (v[e] - mean) * rstd;
        const float dxh = g[e] * gamma[c + e];
        m1 += dxh;
        m2 += dxh * x_hat;
        my_dg[c + e] += g[e] * x_hat;
        my_db[c + e] += g[e];
      }
    }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
    bf16* dxr = dx + static_cast<size_t>(row) * D;
    const bf16* dyr = dy + static_cast<size_t>(row) * D;
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      float d[kVec];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
      unpack8(*reinterpret_cast<const uint4*>(dyr + c), d);
      load8f(gr + c, g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float x_hat = (v[e] - mean) * rstd;
        const float dxh = g[e] * gamma[c + e];
        v[e] = rstd * (dxh - m1 - x_hat * m2) + d[e];
      }
      *reinterpret_cast<uint4*>(dxr + c) = pack8(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kLnbThreads) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kLnbWarps; ++w) {
      sg += acc_s[w * D + c];
      sb += acc_s[(kLnbWarps + w) * D + c];
    }
    part_dg[static_cast<size_t>(blockIdx.x) * D + c] = sg;
    part_db[static_cast<size_t>(blockIdx.x) * D + c] = sb;
  }
}

inline int layernorm_bwd_blocks(int M) { return (M + kLnbRows - 1) / kLnbRows; }

// dx, and dg / db summed over all rows; part holds 2 * blocks * D floats.
inline cudaError_t launch_layernorm_bwd(const bf16* x, const float* dxn, const float* gamma,
                                        const bf16* dy, bf16* dx, float* dg, float* db,
                                        float* part, int M, int D, float eps,
                                        cudaStream_t stream) {
  const int blocks = layernorm_bwd_blocks(M);
  const int smem = 2 * kLnbWarps * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* part_dg = part;
  float* part_db = part + static_cast<size_t>(blocks) * D;
  layernorm_bwd_kernel<<<blocks, kLnbThreads, smem, stream>>>(x, dxn, gamma, dy, dx, part_dg,
                                                              part_db, M, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(part_dg, dg, blocks, D, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials(part_db, db, blocks, D, stream);
}

// partial[chunk][c] = sum of X[r][c] (bf16 X, M x N) over the chunk's
// kColRows rows: each thread sums 8 columns of every 8th row, then the 8
// row lanes are added in order.
__global__ void __launch_bounds__(256)
colsum_partial_kernel(const bf16* __restrict__ X, float* __restrict__ partial, int M, int N) {
  __shared__ float red[8][256];
  const int cv = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int col = blockIdx.x * 256 + cv * kVec;
  const int r0 = blockIdx.y * kColRows;
  const int r1 = min(M, r0 + kColRows);
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (col < N) {
    for (int r = r0 + rl; r < r1; r += 8) {
      float v[kVec];
      unpack8(*reinterpret_cast<const uint4*>(X + static_cast<size_t>(r) * N + col), v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) red[rl][cv * kVec + e] = acc[e];
  __syncthreads();
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c < N) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red[q][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.y) * N + c] = s;
  }
}

inline int colsum_chunks(int M) { return (M + kColRows - 1) / kColRows; }

// out (N,) fp32 = column sums of X (M x N bf16); partial holds
// colsum_chunks(M) * N floats.
inline cudaError_t launch_colsum(const bf16* X, float* out, float* partial, int M, int N,
                                 cudaStream_t stream) {
  const int chunks = colsum_chunks(M);
  const dim3 grid((N + 255) / 256, chunks);
  colsum_partial_kernel<<<grid, 256, 0, stream>>>(X, partial, M, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, out, chunks, N, stream);
}

}  // namespace
}  // namespace duodiff
