// K12: the W8A8 MLP sublayer of a U-ViT block on Hopper,
//
//   y = x + fc2_8(q8(gelu(fc1_8(q8(LN(x))) + b1))) + b2,   x (B, L, D) bf16,
//
// with the activation scales dynamic per row, or static per block
// (calibrated amax; the row factors folded into the weight column scales
// by the caller and inv = [127/sx, 127/sh] passed as a (2,) fp32 operand):
//
//   dynamic: LayerNorm + row quant (quant.cuh); int8 fc1 GEMM with bias and
//            GELU, fp32 hidden out (gemm_int8.cuh); row quant of the
//            hidden; int8 fc2 GEMM with the fp32 residual and bias;
//   static:  LayerNorm + quant with inv[0]; int8 fc1 GEMM whose epilogue
//            applies bias and GELU and quantizes with inv[1], int8 hidden
//            out; int8 fc2 GEMM with the residual and bias.
//
// Replaces: duodiff_tpu/ops/pallas_block_int8.py fused_mlp_sublayer_int8
// (kernel _mlp_kernel_int8, :155-201). The TPU kernel holds the (L, 4D)
// hidden in VMEM. In dynamic mode a row's amax spans all 4D = 2048 hidden
// columns, several GEMM column tiles, so the fp32 hidden goes to device
// memory and a separate pass quantizes it: the fp32 values quantized are
// the TPU kernel's (:192-198), never rounded to bf16. In static mode no
// row statistic is needed and the hidden leaves the SM as int8 codes.
// GELU is exact (erff; the TPU kernel's _erf_poly is a Mosaic workaround
// for the same function) or the tanh form.
//
// Bound: the GEMMs carry 16*M*D^2 operations at up to twice the bf16
// tensor-core rate. The dynamic mode's fp32 hidden round trip is
// 8 bytes per hidden value (write, then read) plus 2 bytes of int8 codes,
// ~270 MB written per call at B = 128, so at that batch it is memory
// traffic the static mode does not have (1 byte write, 1 byte read).

#include "common.cuh"
#include "gemm_int8.cuh"
#include "quant.cuh"

using duodiff::bf16;

// x, out: (M, D) bf16; w1: (Hd, D) int8, s1 (Hd,); w2: (D, Hd) int8,
// s2 (D,); ln_w, ln_b, b1, b2: fp32. inv: (2,) fp32 for static scales, or
// null for dynamic ones. Caller-owned scratch: x8 (M, D) int8, h8 (M, Hd)
// int8; dynamic mode also rs (M,), hidden (M, Hd) fp32 and hrs (M,)
// (null in static mode). gelu_mode: 1 exact (erf), 2 tanh. Returns the
// first CUDA error, or 0.
extern "C" int duodiff_mlp_sublayer_int8(const void* x, const void* ln_w, const void* ln_b,
                                         const void* w1, const void* s1, const void* b1,
                                         const void* w2, const void* s2, const void* b2,
                                         const void* inv, void* x8, void* rs, void* hidden,
                                         void* h8, void* hrs, void* out, int M, int D, int Hd,
                                         int gelu_mode, float eps, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* inv_f = static_cast<const float*>(inv);
  const bool is_static = inv_f != nullptr;
  int8_t* x_codes = static_cast<int8_t*>(x8);
  int8_t* h_codes = static_cast<int8_t*>(h8);
  float* x_scale = static_cast<float*>(rs);
  float* h_scale = static_cast<float*>(hrs);
  cudaError_t err = launch_ln_quant_rows(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), x_codes, x_scale, inv_f, M, D, eps, s);
  if (err != cudaSuccess) return err;
  if (is_static) {
    Int8GemmArgs fc1{kEpiGeluQuant, gelu_mode, nullptr, static_cast<const float*>(s1),
                     static_cast<const float*>(b1), nullptr, inv_f + 1, h_codes};
    err = launch_gemm_int8(x_codes, static_cast<const int8_t*>(w1), M, Hd, D, fc1, s);
  } else {
    Int8GemmArgs fc1{kEpiGeluF32, gelu_mode, x_scale, static_cast<const float*>(s1),
                     static_cast<const float*>(b1), nullptr, nullptr, hidden};
    err = launch_gemm_int8(x_codes, static_cast<const int8_t*>(w1), M, Hd, D, fc1, s);
    if (err != cudaSuccess) return err;
    err = launch_quant_rows(static_cast<const float*>(hidden), h_codes, h_scale, nullptr, M, Hd,
                            s);
  }
  if (err != cudaSuccess) return err;
  Int8GemmArgs fc2{kEpiResidual, kGeluNone, is_static ? nullptr : h_scale,
                   static_cast<const float*>(s2), static_cast<const float*>(b2),
                   static_cast<const bf16*>(x), nullptr, out};
  return launch_gemm_int8(h_codes, static_cast<const int8_t*>(w2), M, D, Hd, fc2, s);
}
