// The int8 GEMM of gemm_int8.cuh and the LayerNorm + row quant pass of
// quant.cuh on their own, for measuring them: no model calls these entries.
// The W8A8 sublayers (K11, K12, and through them K13, K14) reach the same
// device code through launch_gemm_int8 and launch_ln_quant_rows.
//
// ln_quant_rows_first_kernel is the LayerNorm + quant pass as it was first
// written (four passes over the row, gamma and beta read one value at a
// time), kept here only so that the one-read form can be held equal to it to
// the bit on the card.

#include "common.cuh"
#include "gemm_int8.cuh"
#include "quant.cuh"

namespace duodiff {
namespace {

__global__ void __launch_bounds__(kQuantThreads)
ln_quant_rows_first_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, int8_t* __restrict__ x8,
                           float* __restrict__ row_scale, const float* __restrict__ static_inv,
                           int M, int D, float eps) {
  const int row = blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warp leaves together
  const bf16* xr = x + static_cast<size_t>(row) * D;
  float v[kVec];

  float sum = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += v[e];
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
  auto normalize = [&](int c) {  // v <- LN(x[row, c:c+8]) in fp32
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[e] - mean, rstd), gamma[c + e]), beta[c + e]);
  };

  float inv;
  if (static_inv != nullptr) {
    inv = static_inv[0];
  } else {
    float amax = 0.f;
    for (int c = lane * kVec; c < D; c += 32 * kVec) {
      normalize(c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    amax = warp_max(amax);
    inv = inv_scale(amax);
    if (lane == 0) row_scale[row] = __fdiv_rn(amax, 127.f);
  }
  int8_t* qr = x8 + static_cast<size_t>(row) * D;
  for (int c = lane * kVec; c < D; c += 32 * kVec) {
    normalize(c);
    store8_int8(qr + c, v, inv);
  }
}

}  // namespace
}  // namespace duodiff

using duodiff::bf16;

// C[M, N] = epilogue(A[M, K] @ B[N, K]^T): a, b int8 row-major; row_scale
// (M,) fp32 or null; col_scale (N,) fp32; bias (N,) fp32 or null; residual
// (M, N) bf16 (mode 1); quant_inv (1,) fp32 (mode 3); c (M, N) bf16 (modes 0,
// 1), fp32 (mode 2) or int8 (mode 3). mode: 0 bias, 1 residual, 2 GELU into
// fp32, 3 GELU quantized to int8; gelu_mode 0 none, 1 exact (erf), 2 tanh.
// Returns the CUDA error of the checks or the launch, or 0.
extern "C" int duodiff_gemm_int8(const void* a, const void* b, void* c, const void* row_scale,
                                 const void* col_scale, const void* bias, const void* residual,
                                 const void* quant_inv, int M, int N, int K, int mode,
                                 int gelu_mode, void* stream) {
  using namespace duodiff;
  const Int8GemmArgs ep{mode,
                        gelu_mode,
                        static_cast<const float*>(row_scale),
                        static_cast<const float*>(col_scale),
                        static_cast<const float*>(bias),
                        static_cast<const bf16*>(residual),
                        static_cast<const float*>(quant_inv),
                        c};
  return launch_gemm_int8(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), M, N, K,
                          ep, static_cast<cudaStream_t>(stream));
}

extern "C" int duodiff_gemm_int8_threads() { return duodiff::kI8Threads; }

extern "C" int duodiff_gemm_int8_stages() { return duodiff::kI8Stages; }

extern "C" int duodiff_gemm_int8_smem_bytes() { return duodiff::kI8SmemBytes; }

extern "C" int duodiff_gemm_int8_blocks_per_sm() { return duodiff::gemm_int8_blocks_per_sm(); }

// x (M, D) bf16 -> x8 (M, D) int8 codes of LayerNorm(x) (gamma, beta fp32),
// with row_scale (M,) = amax / 127 when static_inv is null, else quantized
// with static_inv[0]. first != 0 runs the first form of the pass.
extern "C" int duodiff_ln_quant_rows(const void* x, const void* gamma, const void* beta, void* x8,
                                     void* row_scale, const void* static_inv, int M, int D,
                                     float eps, int first, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(x8);
  float* rs = static_cast<float*>(row_scale);
  const float* inv = static_cast<const float*>(static_inv);
  if (!first) return launch_ln_quant_rows(xb, g, bt, q, rs, inv, M, D, eps, s);
  if (M == 0) return cudaSuccess;
  ln_quant_rows_first_kernel<<<quant_blocks(M), kQuantThreads, 0, s>>>(xb, g, bt, q, rs, inv, M,
                                                                        D, eps);
  return cudaGetLastError();
}
