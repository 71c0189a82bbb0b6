// Row quantization of activations to int8, the activation side of the W8A8
// sublayers K11 and K12:
//
//   ln_quant_rows_kernel: LayerNorm of a bf16 (M, D) matrix in fp32, then
//     int8 codes of the fp32 result, never rounded to bf16 in between;
//   quant_rows_kernel:    int8 codes of a bf16 or fp32 (M, N) matrix.
//
// Dynamic mode, per row: amax = max|v|, inv = amax > 0 ? 127/amax : 1,
// q = clip(rint(v * inv), -127, 127), row scale amax/127. Static mode (K12
// with calibrated scales, and the static form of the attention sublayer,
// tools/probe_int8_static.py _attn_kernel_static :152, :168): q =
// clip(rint(v * inv)) with one given inv, no row statistic; a bf16 input is
// widened to fp32 before the multiply, as the Pallas body does.
//
// Replaces: _quant_rows and _quant_rows_static of
// duodiff_tpu/ops/pallas_block_int8.py (:71-88), applied in
// _kernel_v2_int8 to the LayerNorm output (:121-123) and to the merged
// heads (:146-147), and in _mlp_kernel_int8 to the LayerNorm output and
// the GELU output (:186-198). The LayerNorm is _ln_fwd's: fp32 two-pass
// statistics, eps inside the rsqrt, x_hat * gamma + beta.
//
// Numerics: the activation is multiplied by the reciprocal (one IEEE
// division per row); rint rounds half to even, as jnp.round does; the
// clip is to +-127, never -128. The LayerNorm's multiplies and adds are
// __fmul_rn/__fadd_rn so that no FMA contraction changes a value that is
// about to be rounded to an int8 code.
//
// Bound: memory, 3 bytes a value (bf16 in, int8 out) for the LayerNorm
// pass. Design: 8 values a lane per 16-byte load; the LayerNorm pass holds
// a warp's rows whole in registers, two rows a warp for D <= 1024 and one
// row a warp for 1024 < D <= 2048 (U-ViT-H's 1152: 5 chunks of 256
// columns), so it reads them from memory once and gamma and beta as 16-byte
// vectors; the row quant
// of an fp32 or bf16 matrix takes a row a warp and reads it twice (amax,
// codes), the second time from L1/L2.
#pragma once

#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kQuantThreads = 256;  // 8 warps = 8 rows per block

__device__ __forceinline__ int8_t quant_int8(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ void load8(const bf16* p, float v[kVec]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 int8 codes = one 8-byte store.
__device__ __forceinline__ void store8_int8(int8_t* p, const float v[kVec], float inv) {
  uint2 raw;
  int8_t* q = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) q[e] = quant_int8(v[e], inv);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float inv_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(127.f, amax) : 1.f;
}

// x (M, D) bf16 -> x8 (M, D) int8. static_inv null: dynamic, row_scale[m]
// = amax/127; else every row quantizes with static_inv[0] and row_scale is
// not written. One warp takes kLnRows rows; lane l holds each row's columns
// 8 l + 256 j .. + 7, j < kChunks (D <= 256 kChunks), in registers from one
// read of the row, and the loads of all its rows are issued before the first
// is summed, so twice the bytes are in flight while the reductions run (at
// kLnRows = 2). The statistics, the normalized values, their amax and the
// codes all come from the registers. Each row's sums run over the same
// values in the same order as a loop over the row would, so the codes and
// scales depend neither on kChunks nor on kLnRows. Past 4 chunks a warp
// takes one row (ln_quant_rows_per_warp), so that its values stay at 64
// registers a lane or fewer above 1024 columns as well as at or below.
__host__ __device__ constexpr int ln_quant_rows_per_warp(int chunks) {
  return chunks <= 4 ? 2 : 1;
}

template <int kChunks, int kLnRows = ln_quant_rows_per_warp(kChunks)>
__global__ void __launch_bounds__(kQuantThreads)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, int8_t* __restrict__ x8,
                     float* __restrict__ row_scale, const float* __restrict__ static_inv,
                     int M, int D, float eps) {
  const int row0 = (blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5)) * kLnRows;
  const int lane = threadIdx.x & 31;
  if (row0 >= M) return;  // whole warp leaves together
  const auto in_row = [&](int j) { return lane * kVec + 32 * kVec * j < D; };
  float v[kLnRows][kChunks][kVec];
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    const bf16* xr = x + static_cast<size_t>(row0 + r) * D;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (row0 + r < M && in_row(j)) {
        load8(xr + lane * kVec + 32 * kVec * j, v[r][j]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[r][j][e] = 0.f;
      }
    }
  }

  float mean[kLnRows], rstd[kLnRows], amax[kLnRows];
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) amax[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in_row(j)) break;
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[r][j][e];
    }
    mean[r] = warp_sum(sum) / static_cast<float>(D);
  }
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in_row(j)) break;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[r][j][e] - mean[r];
        sq += d * d;
      }
    }
    rstd[r] = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (!in_row(j)) break;
    const int c = lane * kVec + 32 * kVec * j;
    float g[kVec], b[kVec];
    load_row8(gamma + c, g);
    load_row8(beta + c, b);
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[r][j][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[r][j][e] - mean[r], rstd[r]), g[e]), b[e]);
        amax[r] = fmaxf(amax[r], fabsf(v[r][j][e]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    if (row0 + r >= M) break;
    float inv;
    if (static_inv != nullptr) {
      inv = static_inv[0];
    } else {
      const float m = warp_max(amax[r]);
      inv = inv_scale(m);
      if (lane == 0) row_scale[row0 + r] = __fdiv_rn(m, 127.f);
    }
    int8_t* qr = x8 + static_cast<size_t>(row0 + r) * D;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in_row(j)) break;
      store8_int8(qr + lane * kVec + 32 * kVec * j, v[r][j], inv);
    }
  }
}

constexpr int kLnQuantMaxWidth = 8 * 32 * kVec;  // 2048: 64 values a lane

// in (M, N) bf16 or fp32 -> out (M, N) int8. static_inv null: dynamic,
// row_scale[m] = amax/127; else every row quantizes with static_inv[0] and
// row_scale is not written.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const T* __restrict__ in, int8_t* __restrict__ out,
                  float* __restrict__ row_scale, const float* __restrict__ static_inv, int M,
                  int N) {
  const int row = blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* r = in + static_cast<size_t>(row) * N;
  float v[kVec];
  float inv;
  if (static_inv != nullptr) {
    inv = static_inv[0];
  } else {
    float amax = 0.f;
    for (int c = lane * kVec; c < N; c += 32 * kVec) {
      load8(r + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    inv = inv_scale(amax);
    if (lane == 0) row_scale[row] = __fdiv_rn(amax, 127.f);
  }
  int8_t* q = out + static_cast<size_t>(row) * N;
  for (int c = lane * kVec; c < N; c += 32 * kVec) {
    load8(r + c, v);
    store8_int8(q + c, v, inv);
  }
}

inline int quant_blocks(int M) {
  const int rows_per_block = kQuantThreads / 32;
  return (M + rows_per_block - 1) / rows_per_block;
}

template <int kChunks>
inline void launch_ln_quant_form(const bf16* x, const float* gamma, const float* beta,
                                 int8_t* x8, float* row_scale, const float* static_inv, int M,
                                 int D, float eps, cudaStream_t stream) {
  constexpr int rows = ln_quant_rows_per_warp(kChunks);
  ln_quant_rows_kernel<kChunks><<<quant_blocks((M + rows - 1) / rows), kQuantThreads, 0,
                                  stream>>>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps);
}

// D % 8 == 0 and D <= kLnQuantMaxWidth, with 16-byte aligned x, gamma, beta
// and x8, or nothing is launched.
inline cudaError_t launch_ln_quant_rows(const bf16* x, const float* gamma, const float* beta,
                                        int8_t* x8, float* row_scale, const float* static_inv,
                                        int M, int D, float eps, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || D <= 0 || D % kVec != 0 || D > kLnQuantMaxWidth) return cudaErrorInvalidValue;
  if (misaligned16(x) || misaligned16(gamma) || misaligned16(beta) || misaligned16(x8))
    return cudaErrorMisalignedAddress;
  switch ((D + 32 * kVec - 1) / (32 * kVec)) {
    case 1:
      launch_ln_quant_form<1>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 2:
      launch_ln_quant_form<2>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 3:
      launch_ln_quant_form<3>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 4:
      launch_ln_quant_form<4>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 5:
      launch_ln_quant_form<5>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 6:
      launch_ln_quant_form<6>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    case 7:
      launch_ln_quant_form<7>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
      break;
    default:
      launch_ln_quant_form<8>(x, gamma, beta, x8, row_scale, static_inv, M, D, eps, stream);
  }
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_quant_rows(const T* in, int8_t* out, float* row_scale,
                                     const float* static_inv, int M, int N,
                                     cudaStream_t stream) {
  quant_rows_kernel<T><<<quant_blocks(M), kQuantThreads, 0, stream>>>(in, out, row_scale,
                                                                      static_inv, M, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
