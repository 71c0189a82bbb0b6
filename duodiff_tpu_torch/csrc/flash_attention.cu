// K9: scaled dot-product attention on Hopper,
//
//   o = softmax(q k^T / sqrt(Dh)) v,   q, k, v, o (B, H, L, Dh) bf16,
//
// one launch of the attention core (attn_core.cuh) on the three separate
// tensors, the softmax scale applied to q inside it.
//
// Replaces: duodiff_tpu/ops/pallas_attention.py flash_attention (kernel
// _kernel). The rounding points are that kernel's: q * scale in fp32
// rounded to bf16, fp32 scores and row max, e = exp(s - m) rounded to bf16
// for e v, the fp32 sum of the unrounded e divided out after the value
// product, one rounding of the output. The TPU kernel's group size and lane
// padding have no counterpart: a block is one (head, sample), its warps walk
// the 16-row query tiles.
// Past L = 272 the launch takes the core's blocked form (attn_core.cuh),
// with the same rounding points.
// Bound: 4 * L * L * Dh flops per (sample, head) against 8 * L * Dh bytes
// (L / 2 = 129 flop/byte at L = 258, under the card's ~295, 513 at L =
// 1025, over it): bytes at the roofline at L = 258, operations at 1025; on
// the card, the instruction count of the softmax over score rows held in
// registers (two blocks of four warps an SM); see attn_core.cuh.

#include "attn_core.cuh"
#include "common.cuh"

using duodiff::bf16;

// Warps a block, dynamic shared memory a block and resident blocks an SM of
// the attention core at length L (its form's) and head width Dh.
extern "C" int duodiff_attn_core_warps(int L) { return duodiff::attn_core_warps(L); }
extern "C" int duodiff_attn_core_smem_bytes(int L, int Dh) {
  return duodiff::attn_core_smem_bytes(L, Dh);
}
extern "C" int duodiff_attn_core_blocks_per_sm(int L, int Dh) {
  return duodiff::attn_core_blocks_per_sm(L, Dh);
}

// q, k, v, out: (B, H, L, Dh) bf16, contiguous, Dh 64 or 72. Returns the
// first CUDA error, or 0.
extern "C" int duodiff_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int L, int Dh, void* stream) {
  using namespace duodiff;
  const float scale = 1.f / sqrtf(static_cast<float>(Dh));
  return launch_attn_core(split_heads(static_cast<const bf16*>(q), L, H, Dh),
                          split_heads(static_cast<const bf16*>(k), L, H, Dh),
                          split_heads(static_cast<const bf16*>(v), L, H, Dh),
                          split_heads(static_cast<bf16*>(out), L, H, Dh), B, L, H, Dh, scale,
                          static_cast<cudaStream_t>(stream));
}
