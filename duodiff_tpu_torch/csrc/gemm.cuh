// Tiled bf16 GEMM with an fp32 epilogue, the four projections of a block:
// qkv and proj (K1), fc1 and fc2 (K2).
//
//   C[M, N] = cast_bf16( gelu?( acc + residual? + bias? ) ),
//   acc = A[M, K] @ B[K, N] in fp32 from bf16 operands.
//
// The kernel is a template over the row types of the residual and of C
// (bf16 or fp32): the whole-block kernel K5 writes its intermediate residual
// stream u as fp32 from the proj epilogue and adds it as fp32 in the fc2
// epilogue; every other caller takes bf16 for both (launch_gemm).
//
// Replaces: the jnp.dot(..., preferred_element_type=f32) projections inside
// duodiff_tpu/ops/pallas_block.py _kernel_v2 (qkv, :132-135; proj with the
// fp32 residual and bias, :161-164) and _mlp_kernel (fc1 + bias + GELU,
// :405-408; fc2 with the fp32 residual and bias, :409-412). The epilogue
// keeps their order: residual first, then bias, then GELU, all in fp32,
// one rounding to bf16 at the end. GELU is exact (erff) or tanh.
//
// Bound: at the sampling shapes (M = B*257, K in {512, 2048}) these are the
// only tensor-core work of any size, ~92% of a block's flops, so the bound
// is tensor-core throughput; the 128x128 tile reads 2*(128+128)*32 bytes
// per 2*128*128*32 flops (64 flop/byte, below the card's balance point,
// so operand staging through shared memory must be overlapped with math).
// Design (simple first, wgmma/TMA later): 128x128x32 block tile, 8 warps
// each owning a 64x32 tile of 4x2 WMMA 16x16x16 fragments with fp32
// accumulators, a two-stage cp.async pipeline (the next K slab loads while
// the current one multiplies), rows padded by 8 bf16 against bank
// conflicts. Ragged edges (M = B*257 is no multiple of 128) are zero-filled
// by cp.async's src-size operand and masked at the store; M, N, K need
// only N % 8 == 0 and K % 8 == 0 (16-byte chunks).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace duodiff {
namespace {

using namespace nvcuda;

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kAPitch = kGemmBK + 8;  // bf16 elements per A tile row
constexpr int kBPitch = kGemmBN + 8;  // bf16 elements per B tile row

template <typename ResT, typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C,
                 const float* __restrict__ bias, const ResT* __restrict__ residual,
                 int M, int N, int K, int gelu_mode) {
  __shared__ __align__(128) bf16 As[2][kGemmBM * kAPitch];
  __shared__ __align__(128) bf16 Bs[2][kGemmBK * kBPitch];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 2 warp rows of 64
  const int wn = warp & 3;   // 4 warp columns of 32
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;

  auto load_tile = [&](int stage, int k0) {
    for (int c = tid; c < kGemmBM * kGemmBK / kVec; c += kGemmThreads) {
      const int r = c / (kGemmBK / kVec), col = (c % (kGemmBK / kVec)) * kVec;
      const bool ok = m0 + r < M && k0 + col < K;
      const bf16* src = ok ? A + static_cast<size_t>(m0 + r) * K + k0 + col : A;
      cp_async16(&As[stage][r * kAPitch + col], src, ok);
    }
    for (int c = tid; c < kGemmBK * kGemmBN / kVec; c += kGemmThreads) {
      const int r = c / (kGemmBN / kVec), col = (c % (kGemmBN / kVec)) * kVec;
      const bool ok = k0 + r < K && n0 + col < N;
      const bf16* src = ok ? B + static_cast<size_t>(k0 + r) * N + n0 + col : B;
      cp_async16(&Bs[stage][r * kBPitch + col], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int num_k = (K + kGemmBK - 1) / kGemmBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < num_k) {
      load_tile(st ^ 1, (kt + 1) * kGemmBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm * 64 + i * 16) * kAPitch + kk], kAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk * kBPitch + wn * 32 + j * 16], kBPitch);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration overwrites the other stage
  }

  // Epilogue, one 16x16 fragment at a time through a per-warp fp32 tile:
  // each lane owns 8 consecutive columns of one row (one 16-byte store).
  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * kVec;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < N) {  // N % 8 == 0: the 8 columns are all in or all out
        float v[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = cs[r * 16 + c0 + e];
        const size_t off = static_cast<size_t>(gr) * N + gc;
        if (residual != nullptr) {
          float res[kVec];
          load_row8(residual + off, res);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[e] += res[e];
        }
        if (bias != nullptr) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[e] += bias[gc + e];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = gelu(v[e], gelu_mode);
        store_row8(C + off, v);
      }
      __syncwarp();
    }
  }
}

// bias may be null (no bias), residual may be null (no residual add).
template <typename ResT, typename OutT>
inline cudaError_t launch_gemm_rows(const bf16* A, const bf16* B, OutT* C, const float* bias,
                                    const ResT* residual, int M, int N, int K, int gelu_mode,
                                    cudaStream_t stream) {
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<ResT, OutT><<<grid, kGemmThreads, 0, stream>>>(A, B, C, bias, residual, M, N,
                                                                   K, gelu_mode);
  return cudaGetLastError();
}

// The bf16-row form every sublayer kernel takes.
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, bf16* C, const float* bias,
                               const bf16* residual, int M, int N, int K, int gelu_mode,
                               cudaStream_t stream) {
  return launch_gemm_rows<bf16, bf16>(A, B, C, bias, residual, M, N, K, gelu_mode, stream);
}

}  // namespace
}  // namespace duodiff
