// Tiled bf16 GEMM with transposed-operand loads, the matrix products of the
// backward sublayers (K6, K7):
//
//   C[M, N] = sum_k A(m, k) B(k, n),  fp32 accumulation from bf16 operands,
//   A(m, k) = A[m * lda + k], or with kTA, A[k * lda + m]  (A stored (K, M));
//   B(k, n) = B[k * ldb + n], or with kTB, B[n * ldb + k]  (B stored (N, K)).
//
// Replaces: the jax.lax.dot_general contractions of duodiff_tpu/ops/
// pallas_block.py _attn_bwd_kernel (dm = dy Wp^T :283, the weight gradients
// dWp = merged^T dy :347 and dWqkv = xn^T dqkv :351, dxn = dqkv Wqkv^T :360)
// and _mlp_bwd_kernel (dh = dy W2^T :1084, dW2 = hgb^T dy :1079,
// dW1 = xn^T dhp :1092, dxn = dhp W1^T :1097).
//
// Bound: the weight gradients contract over all B*L rows (32,896 at batch
// 128) into outputs of only 16 to 64 128x128 tiles, far fewer than the 132
// SMs. So those GEMMs split K (the rows) over gridDim.z: each split writes
// an fp32 partial, and sum_partials_kernel adds the partials in split order.
// That is the deterministic replacement of the Pallas kernels' fp32 VMEM
// accumulators, which sum across a grid that runs in order; Hopper's blocks
// run in no order, and no floating-point atomic is used anywhere, so a
// repeat call gives the same bits.
// Design (simple first, wgmma/TMA later): gemm.cuh's 128x128x32 tile, 8
// warps of 4x2 WMMA 16x16x16 fragments, two-stage cp.async. A transposed
// operand is staged as it lies in memory (K rows of M) and read with a
// column-major fragment, so no transpose pass is needed. Ragged edges are
// zero-filled by cp.async and masked at the store: chunks of 8 elements run
// along the stored rows, so N % 8 == 0, M % 8 == 0 when kTA, and K % 8 == 0
// when A or B is read along K.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace duodiff {
namespace {

using namespace nvcuda;

constexpr int kTBM = 128;
constexpr int kTBN = 128;
constexpr int kTBK = 32;
constexpr int kTThreads = 256;
constexpr int kPitchK = kTBK + 8;    // bf16 per staged row of length BK
constexpr int kPitchMN = kTBM + 8;   // bf16 per staged row of length BM (= BN)
constexpr int kStageElems = kTBM * kPitchK;  // >= kTBK * kPitchMN
constexpr int kMaxSplits = 16;       // split-K partials the workspace holds
constexpr int kSplitTargetBlocks = 2 * 132;  // two waves on an H100's SMs
static_assert(kTBM == kTBN, "one staging size serves A and B");
static_assert(kStageElems >= kTBK * kPitchMN, "a stage holds either layout");

struct GemmSmem {
  bf16 a[2][kStageElems];
  bf16 b[2][kStageElems];
};  // 40 KB; the epilogue reuses it once the main loop is done

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
template <bool kT>
using ALayout = std::conditional_t<kT, wmma::col_major, wmma::row_major>;
template <bool kT>
using BLayout = std::conditional_t<kT, wmma::col_major, wmma::row_major>;

// Stage the A tile rows [m0, m0 + BM) x k [k0, k0 + BK), k < k_end.
template <bool kTA>
__device__ __forceinline__ void load_a(bf16* dst, const bf16* A, int lda, int M, int m0, int k0,
                                       int k_end) {
  if (!kTA) {  // [m][k]
    for (int c = threadIdx.x; c < kTBM * kTBK / kVec; c += kTThreads) {
      const int r = c / (kTBK / kVec), col = (c % (kTBK / kVec)) * kVec;
      const bool ok = m0 + r < M && k0 + col < k_end;
      const bf16* src = ok ? A + static_cast<size_t>(m0 + r) * lda + k0 + col : A;
      cp_async16(dst + r * kPitchK + col, src, ok);
    }
  } else {  // [k][m]
    for (int c = threadIdx.x; c < kTBK * kTBM / kVec; c += kTThreads) {
      const int r = c / (kTBM / kVec), col = (c % (kTBM / kVec)) * kVec;
      const bool ok = k0 + r < k_end && m0 + col < M;
      const bf16* src = ok ? A + static_cast<size_t>(k0 + r) * lda + m0 + col : A;
      cp_async16(dst + r * kPitchMN + col, src, ok);
    }
  }
}

// Stage the B tile k [k0, k0 + BK), k < k_end, x columns [n0, n0 + BN).
template <bool kTB>
__device__ __forceinline__ void load_b(bf16* dst, const bf16* B, int ldb, int N, int n0, int k0,
                                       int k_end) {
  if (!kTB) {  // [k][n]
    for (int c = threadIdx.x; c < kTBK * kTBN / kVec; c += kTThreads) {
      const int r = c / (kTBN / kVec), col = (c % (kTBN / kVec)) * kVec;
      const bool ok = k0 + r < k_end && n0 + col < N;
      const bf16* src = ok ? B + static_cast<size_t>(k0 + r) * ldb + n0 + col : B;
      cp_async16(dst + r * kPitchMN + col, src, ok);
    }
  } else {  // [n][k]
    for (int c = threadIdx.x; c < kTBN * kTBK / kVec; c += kTThreads) {
      const int r = c / (kTBK / kVec), col = (c % (kTBK / kVec)) * kVec;
      const bool ok = n0 + r < N && k0 + col < k_end;
      const bf16* src = ok ? B + static_cast<size_t>(n0 + r) * ldb + k0 + col : B;
      cp_async16(dst + r * kPitchK + col, src, ok);
    }
  }
}

// Fragment of A at rows mi.., k kk.. of a staged tile; B at k kk.., cols ni..
template <bool kTA>
__device__ __forceinline__ void load_frag_a(
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout<kTA>>& f, const bf16* tile, int mi,
    int kk) {
  if (!kTA) wmma::load_matrix_sync(f, tile + mi * kPitchK + kk, kPitchK);
  else wmma::load_matrix_sync(f, tile + kk * kPitchMN + mi, kPitchMN);
}

template <bool kTB>
__device__ __forceinline__ void load_frag_b(
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout<kTB>>& f, const bf16* tile, int ni,
    int kk) {
  if (!kTB) wmma::load_matrix_sync(f, tile + kk * kPitchMN + ni, kPitchMN);
  else wmma::load_matrix_sync(f, tile + ni * kPitchK + kk, kPitchK);
}

// The block's 128x128 output tile at (m0, n0) over k in [k_begin, k_end):
// each warp's 64x32 share lands in acc (zeroed here). Ends with a barrier,
// so the caller may reuse the staging memory.
template <bool kTA, bool kTB>
__device__ __forceinline__ void gemm_mainloop(GemmSmem& sm, Acc (&acc)[4][2], const bf16* A,
                                              int lda, const bf16* B, int ldb, int M, int N,
                                              int m0, int n0, int k_begin, int k_end) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int num_k = k_end > k_begin ? (k_end - k_begin + kTBK - 1) / kTBK : 0;
  if (num_k > 0) {
    load_a<kTA>(sm.a[0], A, lda, M, m0, k_begin, k_end);
    load_b<kTB>(sm.b[0], B, ldb, N, n0, k_begin, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < num_k) {
      const int k0 = k_begin + (kt + 1) * kTBK;
      load_a<kTA>(sm.a[st ^ 1], A, lda, M, m0, k0, k_end);
      load_b<kTB>(sm.b[st ^ 1], B, ldb, N, n0, k0, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout<kTA>> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout<kTB>> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_frag_a<kTA>(a[i], sm.a[st], wm * 64 + i * 16, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j) load_frag_b<kTB>(b[j], sm.b[st], wn * 32 + j * 16, kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration overwrites the other stage
  }
  __syncthreads();
}

// C (fp32, or bf16 when out_bf16) = the product over split blockIdx.z's
// k range; split z > 0 writes at C + z * M * N (fp32 partials).
template <bool kTA, bool kTB>
__global__ void __launch_bounds__(kTThreads)
gemm_t_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
              void* __restrict__ C, int M, int N, int K, int k_per_split, int out_bf16) {
  __shared__ __align__(128) GemmSmem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  Acc acc[4][2];
  gemm_mainloop<kTA, kTB>(sm, acc, A, lda, B, ldb, M, N, m0, n0, k_begin, k_end);

  float* cs = reinterpret_cast<float*>(sm.a) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * kVec;
  const size_t split_off = static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < N) {  // N % 8 == 0: the 8 columns are all in or all out
        const size_t off = split_off + static_cast<size_t>(gr) * N + gc;
        const float* v = cs + r * 16 + c0;
        if (out_bf16) {
          *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + off) = pack8(v);
        } else {
          float4* dst = reinterpret_cast<float4*>(static_cast<float*>(C) + off);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      __syncwarp();
    }
  }
}

// out[i] = sum over p = 0 .. parts-1, in that order, of part[p * n + i].
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

template <bool kTA, bool kTB>
inline cudaError_t launch_gemm_t(const bf16* A, int lda, const bf16* B, int ldb, void* C, int M,
                                 int N, int K, int splits, bool out_bf16, cudaStream_t stream) {
  const int k_per_split = ((K + splits - 1) / splits + kTBK - 1) / kTBK * kTBK;
  const dim3 grid((N + kTBN - 1) / kTBN, (M + kTBM - 1) / kTBM, splits);
  gemm_t_kernel<kTA, kTB><<<grid, kTThreads, 0, stream>>>(A, lda, B, ldb, C, M, N, K, k_per_split,
                                                          out_bf16 ? 1 : 0);
  return cudaGetLastError();
}

// Splits of a weight-gradient GEMM: enough blocks for two waves, at most
// kMaxSplits, and no split without a k slab.
inline int split_count(int M, int N, int K) {
  const int tiles = ((M + kTBM - 1) / kTBM) * ((N + kTBN - 1) / kTBN);
  int s = (kSplitTargetBlocks + tiles - 1) / tiles;
  s = s < kMaxSplits ? s : kMaxSplits;
  const int slabs = (K + kTBK - 1) / kTBK;
  s = s < slabs ? s : slabs;
  return s > 1 ? s : 1;
}

// out (M, N) fp32 = A(m, k) B(k, n) over all K rows, A stored (K, M), B
// stored (K, N): split over K into partial (kMaxSplits * M * N floats of
// scratch), then the partials are summed in split order.
inline cudaError_t launch_weight_grad(const bf16* A, const bf16* B, float* out, float* partial,
                                      int M, int N, int K, cudaStream_t stream) {
  const int splits = split_count(M, N, K);
  if (splits == 1) return launch_gemm_t<true, false>(A, M, B, N, out, M, N, K, 1, false, stream);
  cudaError_t err = launch_gemm_t<true, false>(A, M, B, N, partial, M, N, K, splits, false, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, out, splits, static_cast<size_t>(M) * N, stream);
}

}  // namespace
}  // namespace duodiff
