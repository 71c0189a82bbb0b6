// K11: the W8A8 attention sublayer of a U-ViT block on Hopper,
//
//   y = x + proj8(q8(SDPA(qkv8(q8(LN(x)))))) + b_proj,   x (B, L, D) bf16,
//
// as five launches: LayerNorm with per-row int8 quantization of its fp32
// output (quant.cuh), the int8 qkv GEMM dequantized by (row x column)
// scale plus the q-prescaled bias, rounded to bf16 (gemm_int8.cuh), the
// bf16 attention core of K1 (attn_core.cuh), per-row int8 quantization of
// the bf16 merged heads (quant.cuh), and the int8 proj GEMM with the fp32
// residual and bias in its epilogue.
//
// Replaces: duodiff_tpu/ops/pallas_block_int8.py fused_attn_sublayer_int8
// (kernel _kernel_v2_int8, :103-152). The TPU kernel keeps a sample in
// VMEM; here the intermediates go to device memory exactly where the TPU
// kernel holds them in a fixed type: the int8 codes and fp32 row scales of
// the LayerNorm output (:123), the bf16 qkv (:128), the bf16 merged heads
// (:145-146), so the split changes no number. The softmax scale is folded
// into the q column scales and the q bias by the caller (_prep_attn_int8),
// never into the int8 codes. The merged heads are quantized by a launch of
// their own because a row's amax spans every head, while the attention
// core works one head per block.
//
// Bound: the two int8 GEMMs are ~1/2 of a bf16 sublayer's GEMM bytes and
// run at up to twice the bf16 tensor-core rate; the attention core, which
// stays bf16, is the larger part of the sublayer at L = 257. The
// quantization launches are memory-bound passes over (B*L, D).

#include "attn_core.cuh"
#include "common.cuh"
#include "gemm_int8.cuh"
#include "quant.cuh"

using duodiff::bf16;

// x, out: (B, L, D) bf16; wqkv8: (3A, D) int8, sqkv (3A,) fp32 with the
// softmax scale in its q part; bqkv: (3A,) fp32 (q part prescaled) or
// null; wp8: (D, A) int8, sp (D,) fp32; ln_w, ln_b, bp: fp32. x8 (B*L, D)
// int8, rs (B*L,) fp32, qkv (B*L, 3A) bf16 and merged (B*L, A) bf16 are
// caller-owned scratch (x8 and rs are reused for the merged heads). Head
// width 64, A = H * 64 = D. Returns the first CUDA error, or 0.
extern "C" int duodiff_attn_sublayer_int8(const void* x, const void* ln_w, const void* ln_b,
                                          const void* wqkv8, const void* sqkv, const void* bqkv,
                                          const void* wp8, const void* sp, const void* bp,
                                          void* x8, void* rs, void* qkv, void* merged,
                                          void* out, int B, int L, int D, int H, float eps,
                                          void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, A = H * kDh;
  int8_t* codes = static_cast<int8_t*>(x8);
  float* row_scale = static_cast<float*>(rs);
  cudaError_t err = launch_ln_quant_rows(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), codes, row_scale, nullptr, M, D, eps, s);
  if (err != cudaSuccess) return err;
  Int8GemmArgs qkv_ep{kEpiBias, kGeluNone, row_scale, static_cast<const float*>(sqkv),
                      static_cast<const float*>(bqkv), nullptr, nullptr, qkv};
  err = launch_gemm_int8(codes, static_cast<const int8_t*>(wqkv8), M, 3 * A, D, qkv_ep, s);
  if (err != cudaSuccess) return err;
  err = launch_attn_core(static_cast<const bf16*>(qkv), static_cast<bf16*>(merged), B, L, H, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_rows(static_cast<const bf16*>(merged), codes, row_scale, M, A, s);
  if (err != cudaSuccess) return err;
  Int8GemmArgs proj_ep{kEpiResidual, kGeluNone, row_scale, static_cast<const float*>(sp),
                       static_cast<const float*>(bp), static_cast<const bf16*>(x), nullptr, out};
  return launch_gemm_int8(codes, static_cast<const int8_t*>(wp8), M, D, A, proj_ep, s);
}
