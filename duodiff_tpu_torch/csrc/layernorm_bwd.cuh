// The row-wise ends of the backward sublayers (K6, K7, K8): LayerNorm backward
// fused with the residual and the dgamma / dbeta partial sums, and the
// column sums of the bias gradients.
//
// Replaces: _ln_bwd_dx (duodiff_tpu/ops/pallas_block.py:224) with
// ``dx = dx + dy`` and the dg/db accumulations of _attn_bwd_kernel
// (:364-369) and _mlp_bwd_kernel (:1101-1106), and the bias-gradient sums
// (dbp :281, dbqkv :357, db2 :1070).
//
// Bound: memory. Each row reads x (bf16), dxn (fp32) and dy (bf16) and
// writes dx (bf16), a few flops per byte. A warp reads a row into registers
// at once (rows of D <= 1024) and reduces it there.
// Determinism: the Pallas kernels add these sums across a grid that runs in
// order. Here each block sums a fixed range of rows into a partial, in row
// order within each warp and then warp by warp, and sum_partials_kernel
// adds the partials in block order: two passes, no atomics.
#pragma once

#include "common.cuh"

namespace duodiff {
namespace {

// out[i] = sum over p = 0 .. parts-1, in that order, of part[p * n + i]: the
// second pass of the deterministic column sums here and of db1
// (mlp_bwd_hidden.cuh).
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int parts, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

inline cudaError_t launch_sum_partials(const float* part, float* out, int parts, size_t n,
                                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(part, out, parts, n);
  return cudaGetLastError();
}

constexpr int kLnbThreads = 256;                 // 8 warps, one row each at a time
constexpr int kLnbWarps = kLnbThreads / 32;
constexpr int kLnbRows = 64;                     // rows per block (K6, K7)
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
// dxn over its block_rows rows. Lane l of a warp takes columns 8 l + 256 j
// .. + 7, j < kChunks (D <= 256 kChunks), and reads its x, dxn and dy of a
// row into registers at once, so that a row costs one trip to device
// memory, not one a pass: a chunk of K8's rows launches only a few blocks
// an SM, and then that latency is what bounds the launch. Dynamic shared
// memory: 2 * kLnbWarps * D floats.
template <int kChunks>
__global__ void __launch_bounds__(kLnbThreads)
layernorm_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                     const float* __restrict__ gamma, const bf16* __restrict__ dy,
                     bf16* __restrict__ dx, float* __restrict__ part_dg,
                     float* __restrict__ part_db, int M, int D, int block_rows, float eps) {
  extern __shared__ float acc_s[];
  grid_dependency_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* my_dg = acc_s + warp * D;
  float* my_db = acc_s + (kLnbWarps + warp) * D;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) my_dg[c + e] = my_db[c + e] = 0.f;
  }
  const auto col = [&](int j) { return lane * kVec + 32 * kVec * j; };
  const float inv_d = 1.f / static_cast<float>(D);
  const int row_end = min(M, (blockIdx.x + 1) * block_rows);
  for (int row = blockIdx.x * block_rows + warp; row < row_end; row += kLnbWarps) {
    const size_t at = static_cast<size_t>(row) * D;
    uint4 xr[kChunks], dyr[kChunks];
    float g[kChunks][kVec];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (col(j) < D) {
        xr[j] = *reinterpret_cast<const uint4*>(x + at + col(j));
        dyr[j] = *reinterpret_cast<const uint4*>(dy + at + col(j));
        load8f(dxn + at + col(j), g[j]);
      }
    }
    float v[kVec];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (col(j) >= D) break;
      unpack8(xr[j], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[e];
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (col(j) >= D) break;
      unpack8(xr[j], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (col(j) >= D) break;
      const int c = col(j);
      unpack8(xr[j], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float x_hat = (v[e] - mean) * rstd;
        const float dxh = g[j][e] * gamma[c + e];
        m1 += dxh;
        m2 += dxh * x_hat;
        my_dg[c + e] += g[j][e] * x_hat;
        my_db[c + e] += g[j][e];
      }
    }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (col(j) >= D) break;
      const int c = col(j);
      float d[kVec];
      unpack8(xr[j], v);
      unpack8(dyr[j], d);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float x_hat = (v[e] - mean) * rstd;
        const float dxh = g[j][e] * gamma[c + e];
        v[e] = rstd * (dxh - m1 - x_hat * m2) + d[e];
      }
      *reinterpret_cast<uint4*>(dx + at + c) = pack8(v);
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

constexpr int kLnbMaxWidth = 4 * 32 * kVec;  // 1024: 32 values of a row a lane

inline int layernorm_bwd_blocks(int M, int block_rows = kLnbRows) {
  return (M + block_rows - 1) / block_rows;
}

// The kernel for kChunks, its shared-memory opt-in set once, at the widest
// rows it takes.
template <int kChunks>
inline cudaError_t launch_layernorm_bwd_form(const bf16* x, const float* dxn, const float* gamma,
                                             const bf16* dy, bf16* dx, float* part_dg,
                                             float* part_db, int M, int D, int block_rows,
                                             float eps, cudaStream_t stream, bool pdl) {
  static const cudaError_t set = cudaFuncSetAttribute(
      layernorm_bwd_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kLnbWarps * 32 * kVec * kChunks * static_cast<int>(sizeof(float)));
  if (set != cudaSuccess) return set;
  const int smem = 2 * kLnbWarps * D * static_cast<int>(sizeof(float));
  return launch_kernel(layernorm_bwd_kernel<kChunks>, layernorm_bwd_blocks(M, block_rows),
                       kLnbThreads, smem, stream, pdl, x, dxn, gamma, dy, dx, part_dg, part_db, M,
                       D, block_rows, eps);
}

// dx of M rows (D <= kLnbMaxWidth, D % 8 == 0), and the dg / db partials of
// their blocks of block_rows rows at part_dg / part_db
// (layernorm_bwd_blocks(M, block_rows) rows of D floats each).
inline cudaError_t launch_layernorm_bwd_rows(const bf16* x, const float* dxn,
                                             const float* gamma, const bf16* dy, bf16* dx,
                                             float* part_dg, float* part_db, int M, int D,
                                             float eps, cudaStream_t stream,
                                             int block_rows = kLnbRows, bool pdl = false) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || D <= 0 || D % kVec != 0 || D > kLnbMaxWidth || block_rows < 1)
    return cudaErrorInvalidValue;
  const int chunks = (D + 32 * kVec - 1) / (32 * kVec);
  if (chunks == 1)
    return launch_layernorm_bwd_form<1>(x, dxn, gamma, dy, dx, part_dg, part_db, M, D,
                                        block_rows, eps, stream, pdl);
  if (chunks == 2)
    return launch_layernorm_bwd_form<2>(x, dxn, gamma, dy, dx, part_dg, part_db, M, D,
                                        block_rows, eps, stream, pdl);
  if (chunks == 3)
    return launch_layernorm_bwd_form<3>(x, dxn, gamma, dy, dx, part_dg, part_db, M, D,
                                        block_rows, eps, stream, pdl);
  return launch_layernorm_bwd_form<4>(x, dxn, gamma, dy, dx, part_dg, part_db, M, D,
                                      block_rows, eps, stream, pdl);
}

// dx, and dg / db summed over all rows; part holds 2 * blocks * D floats.
inline cudaError_t launch_layernorm_bwd(const bf16* x, const float* dxn, const float* gamma,
                                        const bf16* dy, bf16* dx, float* dg, float* db,
                                        float* part, int M, int D, float eps,
                                        cudaStream_t stream) {
  const int blocks = layernorm_bwd_blocks(M);
  float* part_dg = part;
  float* part_db = part + static_cast<size_t>(blocks) * D;
  cudaError_t err =
      launch_layernorm_bwd_rows(x, dxn, gamma, dy, dx, part_dg, part_db, M, D, eps, stream);
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
