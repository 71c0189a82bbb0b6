// The bf16 GEMM of gemm.cuh on its own, for measuring it: no model calls
// this entry. The sublayer kernels (K1, K1-v1, K2, K5, K6) reach the same
// device code through launch_gemm / launch_gemm_rows.

#include "common.cuh"
#include "gemm.cuh"

using duodiff::bf16;

// C[M, N] = cast(gelu?(A[M, K] @ B[K, N] + residual? + bias?)): a, b bf16
// row-major; bias (N,) fp32 or null; residual (M, N) bf16, or fp32 with
// residual_fp32, or null; c (M, N) bf16, or fp32 with out_fp32. gelu_mode 0
// none, 1 exact (erf), 2 tanh. Returns the CUDA error of the checks or the
// launch, or 0.
extern "C" int duodiff_gemm_bf16(const void* a, const void* b, void* c, const void* bias,
                                 const void* residual, int M, int N, int K, int gelu_mode,
                                 int residual_fp32, int out_fp32, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const float* bi = static_cast<const float*>(bias);
  if (residual_fp32) {
    const float* r = static_cast<const float*>(residual);
    if (out_fp32)
      return launch_gemm_rows<float, float>(A, B, static_cast<float*>(c), bi, r, M, N, K,
                                            gelu_mode, s);
    return launch_gemm_rows<float, bf16>(A, B, static_cast<bf16*>(c), bi, r, M, N, K, gelu_mode,
                                         s);
  }
  const bf16* r = static_cast<const bf16*>(residual);
  if (out_fp32)
    return launch_gemm_rows<bf16, float>(A, B, static_cast<float*>(c), bi, r, M, N, K, gelu_mode,
                                         s);
  return launch_gemm_rows<bf16, bf16>(A, B, static_cast<bf16*>(c), bi, r, M, N, K, gelu_mode, s);
}

extern "C" int duodiff_gemm_bf16_threads() { return duodiff::kGemmThreads; }

extern "C" int duodiff_gemm_bf16_stages() { return duodiff::kGemmStages; }

extern "C" int duodiff_gemm_bf16_smem_bytes() { return duodiff::kGemmSmemBytes; }

extern "C" int duodiff_gemm_bf16_blocks_per_sm() { return duodiff::gemm_blocks_per_sm(); }
