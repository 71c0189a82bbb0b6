// K1-v1: the per-head form of the fused attention sublayer on Hopper,
//
//   y = x + sum_h proj_h(softmax(q_h k_h^T * scale) v_h) + b_proj,
//   x (B, L, D) bf16,
//
// as six launches: LayerNorm rows (layernorm.cuh), one GEMM each for q, k
// and v from the three (D, A) blocks of the packed weight (gemm.cuh), the
// attention core in its normalise-first form, one block a (head, sample)
// whose warps walk the 16-row query tiles (attn_core.cuh), and the proj GEMM with the fp32 residual and
// bias in its epilogue.
//
// Replaces: duodiff_tpu/ops/pallas_block.py fused_attn_sublayer, variant
// "v1" (kernel _kernel, a (batch group, head) grid). Its rounding points
// differ from K1's and are kept: the qkv weight comes WITHOUT the softmax
// scale, q, k and v are rounded to bf16 per head (:77), the fp32 scores are
// multiplied by the scale (:83), p = softmax is rounded to bf16 after the
// division (:85), each head's output is rounded to bf16 (:88), and the
// per-head (L, Dh) (Dh, D) partial products are summed over heads in fp32
// onto x + b_proj (:63, :90). That sum over heads of bf16 rows times wp[h]
// with fp32 accumulation is the proj GEMM over A = H * Dh, so it is one
// GEMM here; the TPU's sequential head axis carried the sum in a VMEM
// accumulator, which a grid of parallel blocks cannot do without atomics.
// The per-(which) weight blocks (3, D, A) are the (3, H, D, Dh) blocks of
// the Pallas wrapper (:1651) with the heads of one of q, k, v side by side.
// Bound: K1's, the same products.

#include <cmath>

#include "attn_core.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

using duodiff::bf16;

// x, xn, out: (B, L, D) bf16; wqkv: (3, D, A) bf16, unscaled; bqkv: (3, A)
// fp32 or null; wp: (A, D) bf16; ln_w, ln_b, bp: fp32. xn (B*L, D), qkv
// (3, B*L, A) and merged (B*L, A) are caller-owned scratch. Head width 64,
// A = H * 64 = D. Returns the first CUDA error, or 0.
extern "C" int duodiff_attn_sublayer_v1(const void* x, const void* ln_w, const void* ln_b,
                                        const void* wqkv, const void* bqkv, const void* wp,
                                        const void* bp, void* xn, void* qkv, void* merged,
                                        void* out, int B, int L, int D, int H, float eps,
                                        void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, A = H * kDh;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* qkvb = static_cast<bf16*>(qkv);
  const bf16* w = static_cast<const bf16*>(wqkv);
  const float* bias = static_cast<const float*>(bqkv);
  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), xnb, M, D, eps, s);
  if (err != cudaSuccess) return err;
  const size_t third = static_cast<size_t>(M) * A;
  for (int i = 0; i < 3; ++i) {
    err = launch_gemm(xnb, w + static_cast<size_t>(i) * D * A, qkvb + i * third,
                      bias == nullptr ? nullptr : bias + i * A, nullptr, M, A, D, kGeluNone, s);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(kDh));
  err = launch_attn_core_form<true>(
      merged_heads(static_cast<const bf16*>(qkvb), L, H, kDh),
      merged_heads(static_cast<const bf16*>(qkvb + third), L, H, kDh),
      merged_heads(static_cast<const bf16*>(qkvb + 2 * third), L, H, kDh),
      merged_heads(static_cast<bf16*>(merged), L, H, kDh), B, L, H, scale, s);
  if (err != cudaSuccess) return err;
  return launch_gemm(static_cast<const bf16*>(merged), static_cast<const bf16*>(wp),
                     static_cast<bf16*>(out), static_cast<const float*>(bp), xb, M, D, A,
                     kGeluNone, s);
}
