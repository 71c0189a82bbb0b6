// K2: the fused MLP sublayer of a U-ViT block on Hopper,
//
//   y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2,   x (B, L, D) bf16, hidden 4D,
//
// as three launches: LayerNorm rows (layernorm.cuh), the fc1 GEMM with
// bias and GELU in its fp32 epilogue, and the fc2 GEMM with the fp32
// residual and bias in its epilogue (gemm.cuh).
//
// Replaces: duodiff_tpu/ops/pallas_block.py fused_mlp_sublayer (kernel
// _mlp_kernel). The TPU kernel keeps the (L, 4D) hidden activation in
// VMEM; here it goes to device memory in bf16, which is exactly where the
// TPU kernel rounds it (``.astype(x_ref.dtype)`` at :408), so the split
// changes no number. GELU is exact (erff; the TPU kernel's _erf_poly is a
// Mosaic workaround for the same function) or the tanh form.
//
// Bound: the two GEMMs carry 16*M*D^2 flops against ~24*M*D bytes moved,
// the bf16 xn and hidden round trips included (~340 flop/byte at D = 512,
// just above the card's ~295 balance point), so the sublayer is
// tensor-core bound at the sampling shapes; the hidden round trip alone is
// 16*M*D bytes (~17 MB per call at B = 8), which the 50 MB L2 mostly
// absorbs. Design: reuse the GEMM tile of gemm.cuh, whose
// epilogue applies bias, GELU and the residual without another pass.

#include "common.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

using duodiff::bf16;

// x, xn, out: (M, D) bf16; w1: (D, hidden) bf16; w2: (hidden, D) bf16;
// ln_w, ln_b, b1, b2: fp32. xn and hidden (M, hidden) are caller-owned
// scratch. gelu_mode: 1 exact (erf), 2 tanh. Returns the first CUDA
// error, or 0.
extern "C" int duodiff_mlp_sublayer(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* xn, void* hidden, void* out,
                                    int M, int D, int Hd, int gelu_mode, float eps,
                                    void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_layernorm(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), static_cast<bf16*>(xn),
                                     M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm(static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
                    static_cast<bf16*>(hidden), static_cast<const float*>(b1), nullptr, M, Hd, D,
                    gelu_mode, s);
  if (err != cudaSuccess) return err;
  return launch_gemm(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2),
                     static_cast<bf16*>(out), static_cast<const float*>(b2),
                     static_cast<const bf16*>(x), M, D, Hd, kGeluNone, s);
}
