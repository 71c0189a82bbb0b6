// K5: a whole pre-norm transformer block of the U-ViT on Hopper,
//
//   u = x + proj(SDPA(qkv(LN1(x)))) + b_proj        (fp32, never rounded)
//   y = u + fc2(gelu(fc1(LN2(u)) + b1)) + b2,       x, y (B, L, D) bf16,
//
// as seven launches: LayerNorm rows, the qkv GEMM, the attention core (its
// blocked form past L = 272, attn_core.cuh), the proj GEMM whose epilogue
// writes u = acc + x + b_proj as fp32, LayerNorm of the fp32 rows of u, the
// fc1 GEMM with bias and GELU, and the fc2 GEMM whose epilogue adds the fp32
// u and the bias and rounds once to bf16.
//
// Replaces: duodiff_tpu/ops/pallas_block.py fused_block (kernel
// _block_kernel). What that kernel has over the two sublayer kernels run
// back to back is the intermediate residual stream u kept in fp32 through
// the second LayerNorm and the last residual add (:462-474), where K1 then
// K2 round it to bf16 in between; the TPU keeps u in VMEM, here it is one
// fp32 (B*L, D) scratch tensor, written once and read twice. Every other
// rounding point is the sublayers' own: xn, qkv, the per-head outputs, un
// and the hidden activation in bf16. As in K1 the softmax scale comes folded
// into the q columns of the packed weight and the softmax is normalised
// after the value product (:453-459).
// Bound: the six matrix products of K1 and K2 together, tensor-core bound;
// against K1 then K2 it moves 4 more bytes per element of u (fp32 written
// and read twice instead of bf16 written once and read twice).

#include "attn_core.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

using duodiff::bf16;

// x, out: (B, L, D) bf16; wqkv: (D, 3A) bf16, q columns pre-scaled; bqkv:
// (3A,) fp32 or null; wp: (A, D) bf16; w1: (D, Hd) bf16; w2: (Hd, D) bf16;
// the LayerNorm affines and the biases fp32. Caller-owned scratch: xn
// (B*L, D) bf16 (both LayerNorm outputs in turn), qkv (B*L, 3A) bf16, merged
// (B*L, A) bf16, u (B*L, D) fp32, hidden (B*L, Hd) bf16. Head width Dh
// (64 or 72), A = H * Dh = D. gelu_mode: 1 exact (erf), 2 tanh. Returns the first CUDA
// error, or 0.
extern "C" int duodiff_fused_block(const void* x, const void* ln1_w, const void* ln1_b,
                                   const void* wqkv, const void* bqkv, const void* wp,
                                   const void* bp, const void* ln2_w, const void* ln2_b,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* xn, void* qkv, void* merged, void* u, void* hidden,
                                   void* out, int B, int L, int D, int H, int Dh, int Hd, int gelu_mode,
                                   float eps, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, A = H * Dh;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* xnb = static_cast<bf16*>(xn);
  float* uf = static_cast<float*>(u);
  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln1_w),
                                     static_cast<const float*>(ln1_b), xnb, M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm(xnb, static_cast<const bf16*>(wqkv), static_cast<bf16*>(qkv),
                    static_cast<const float*>(bqkv), nullptr, M, 3 * A, D, kGeluNone, s);
  if (err != cudaSuccess) return err;
  err = launch_attn_core(static_cast<const bf16*>(qkv), static_cast<bf16*>(merged), B, L, H, Dh,
                         s);
  if (err != cudaSuccess) return err;
  err = launch_gemm_rows<bf16, float>(static_cast<const bf16*>(merged),
                                      static_cast<const bf16*>(wp), uf,
                                      static_cast<const float*>(bp), xb, M, D, A, kGeluNone, s);
  if (err != cudaSuccess) return err;
  err = launch_layernorm(static_cast<const float*>(uf), static_cast<const float*>(ln2_w),
                         static_cast<const float*>(ln2_b), xnb, M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm(xnb, static_cast<const bf16*>(w1), static_cast<bf16*>(hidden),
                    static_cast<const float*>(b1), nullptr, M, Hd, D, gelu_mode, s);
  if (err != cudaSuccess) return err;
  return launch_gemm_rows<float, bf16>(static_cast<const bf16*>(hidden),
                                       static_cast<const bf16*>(w2), static_cast<bf16*>(out),
                                       static_cast<const float*>(b2),
                                       static_cast<const float*>(uf), M, D, Hd, kGeluNone, s);
}
