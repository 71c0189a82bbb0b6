// The backward GEMM forms (gemm_t.cuh over gemm.cuh) and the MLP backward's
// hidden stage (mlp_bwd_hidden.cuh) on their own, for measuring them: no
// model calls these entries. The backward sublayer kernels (K6, K7, K8)
// reach the same device code through launch_gemm_nt,
// launch_gemm_nt_accumulate, launch_weight_grad and launch_mlp_bwd_hidden.

#include "common.cuh"
#include "gemm_t.cuh"
#include "layernorm_bwd.cuh"
#include "mlp_bwd_hidden.cuh"

using duodiff::bf16;

// By form, on packed operands:
//   0  c (M, N) fp32 = a^T b, a stored (K, M), b (K, N): a weight gradient,
//      split over the K rows into `splits` (0: the launcher's choice) and
//      summed in split order; flags holds duodiff_gemm_t_flag_bytes(M, N);
//   1  c (M, N) fp32 = a b^T, a (M, K), b stored (N, K);
//   2  the same rounded to bf16 c;
//   3  c (M, N) fp32 += a b^T.
// Returns the CUDA error of the checks or the launch, or 0.
extern "C" int duodiff_gemm_t(const void* a, const void* b, void* c, void* flags, int M, int N,
                              int K, int form, int splits, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  switch (form) {
    case 0:
      return launch_weight_grad(A, B, static_cast<float*>(c), static_cast<int*>(flags), M, N, K,
                                s, splits);
    case 1:
      return launch_gemm_nt(A, K, B, K, static_cast<float*>(c), M, N, K, s);
    case 2:
      return launch_gemm_nt(A, K, B, K, static_cast<bf16*>(c), M, N, K, s);
    case 3:
      return launch_gemm_nt_accumulate(A, K, B, K, static_cast<float*>(c), M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The row splits form 0 takes by itself for an (M, N) output over K rows.
extern "C" int duodiff_gemm_t_splits(int M, int N, int K) {
  return duodiff::weight_grad_splits(M, N, K);
}

// Bytes of the flags form 0 takes.
extern "C" size_t duodiff_gemm_t_flag_bytes(int M, int N) {
  return duodiff::weight_grad_flags(M, N);
}

// xn, dy (M, D) bf16; w1 (D, Hd), b1 (Hd,) fp32; w2 (Hd, D): hgb, dhp (M,
// Hd) bf16 and db1 (Hd,) fp32, summed in row-tile order from db1_part
// (duodiff_mlp_bwd_hidden_part_bytes). gelu_mode 1 exact, 2 tanh.
extern "C" int duodiff_mlp_bwd_hidden(const void* xn, const void* w1, const void* b1,
                                      const void* dy, const void* w2, void* hgb, void* dhp,
                                      void* db1, void* db1_part, int M, int D, int Hd,
                                      int gelu_mode, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_mlp_bwd_hidden(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w1), Hd,
      static_cast<const float*>(b1), static_cast<const bf16*>(dy), static_cast<const bf16*>(w2),
      static_cast<bf16*>(hgb), static_cast<bf16*>(dhp), static_cast<float*>(db1_part), M, D, Hd,
      gelu_mode, s);
  if (err != cudaSuccess || M == 0) return err;
  return launch_sum_partials(static_cast<const float*>(db1_part), static_cast<float*>(db1),
                             row_tiles(M), Hd, s);
}

extern "C" size_t duodiff_mlp_bwd_hidden_part_bytes(int M, int Hd) {
  return static_cast<size_t>(duodiff::row_tiles(M)) * Hd * sizeof(float);
}

// What a block of each kernel is: out[0..3] the GEMM's threads, ring stages,
// dynamic shared memory bytes and resident blocks an SM; out[4..7] the same
// for the hidden stage. Returns 0.
extern "C" int duodiff_gemm_t_layout(void* out) {
  using namespace duodiff;
  int* o = static_cast<int*>(out);
  o[0] = kGemmThreads;
  o[1] = kGemmStages;
  o[2] = kGemmSmemBytes;
  o[3] = gemm_blocks_per_sm();
  o[4] = kHidThreads;
  o[5] = kHidStages;
  o[6] = kHidSmemBytes;
  o[7] = mlp_bwd_hidden_blocks_per_sm();
  return 0;
}
