// K1: the fused attention sublayer of a U-ViT block on Hopper,
//
//   y = x + proj(SDPA(qkv(LN(x)))) + b_proj,   x (B, L, D) bf16,
//
// as four launches: LayerNorm rows (layernorm.cuh), the qkv GEMM
// (gemm.cuh), the attention core (attn_core.cuh: the register form up to
// L = 272, the blocked form past it), and the proj GEMM with the fp32
// residual and bias in its epilogue.
//
// Replaces: duodiff_tpu/ops/pallas_block.py fused_attn_sublayer, variant
// "v2" (kernel _kernel_v2). The TPU kernel keeps everything in VMEM; here
// the intermediates go to device memory, but exactly at the TPU kernel's
// own bf16 rounding points (xn :130, qkv :135, per-head outputs :157), so
// the split changes no number. As on the TPU, the softmax scale is folded
// into the q columns of the packed weight by the caller.
//
// The tensor-parallel shard form (residual = 0; the Pallas kernel's
// residual=False with head_dim passed, duodiff_tpu/parallel/tp_fused.py):
// the shard holds H of the model's heads, A = H * Dh < D, so the qkv GEMM
// has N = 3A, the core runs H heads and the proj GEMM has K = A; its
// epilogue writes the bare partial proj + bias, no x +, rounded to bf16
// once (the caller passes a zero bias and adds x and the real bias after
// the sum over the shards).

#include "attn_core.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

using duodiff::bf16;

// The head widths the attention cores take: the i-th, 0 past the last.
extern "C" int duodiff_attn_head_width(int i) {
  constexpr int n = sizeof(duodiff::kHeadWidths) / sizeof(int);
  return i >= 0 && i < n ? duodiff::kHeadWidths[i] : 0;
}

// The longest sequence the attention core takes at head width Dh (0: a
// width it does not take): up to 272 a warp keeps 16 whole score rows in
// registers, past it the blocked form walks the keys in blocks
// (attn_core.cuh), whose limit is its fp32 running sums' (attn_tiles.cuh),
// at either width.
extern "C" int duodiff_attn_core_max_len(int Dh) {
  return duodiff::with_head_dim(Dh, 0, [](auto) { return duodiff::kMaxSeqBlocked; });
}

extern "C" const char* duodiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, xn, out: (B, L, D) bf16; wqkv: (D, 3A) bf16, q columns pre-scaled;
// bqkv: (3A,) fp32 or null; wp: (A, D) bf16; ln_w, ln_b, bp: fp32.
// xn (B*L, D), qkv (B*L, 3A) and merged (B*L, A) are caller-owned scratch.
// Head width Dh (64 or 72), A = H * Dh: A = D with residual = 1
// (y = x + ...), any A with residual = 0 (y = the partial, a shard's).
// Returns the first CUDA error, or 0.
extern "C" int duodiff_attn_sublayer(const void* x, const void* ln_w, const void* ln_b,
                                     const void* wqkv, const void* bqkv, const void* wp,
                                     const void* bp, void* xn, void* qkv, void* merged,
                                     void* out, int B, int L, int D, int H, int Dh, int residual,
                                     float eps, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, A = H * Dh;
  cudaError_t err = launch_layernorm(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), static_cast<bf16*>(xn),
                                     M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm(static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv),
                    static_cast<bf16*>(qkv), static_cast<const float*>(bqkv), nullptr, M, 3 * A,
                    D, kGeluNone, s);
  if (err != cudaSuccess) return err;
  err = launch_attn_core(static_cast<const bf16*>(qkv), static_cast<bf16*>(merged), B, L, H, Dh,
                         s);
  if (err != cudaSuccess) return err;
  return launch_gemm(static_cast<const bf16*>(merged), static_cast<const bf16*>(wp),
                     static_cast<bf16*>(out), static_cast<const float*>(bp),
                     residual ? static_cast<const bf16*>(x) : nullptr, M, D, A, kGeluNone, s);
}
