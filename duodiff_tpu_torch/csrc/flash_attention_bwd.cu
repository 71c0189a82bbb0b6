// K10: the backward of scaled dot-product attention (K9) on Hopper,
//
//   dq, dk, dv of o = softmax(q k^T / sqrt(Dh)) v from q, k, v and do,
//   all (B, H, L, Dh) bf16,
//
// the two launches of the attention backward core (attn_bwd_core.cuh) on
// the separate tensors: the row launch (softmax statistics and dq), then
// the key launch (dk and dv summed over the queries in registers); every
// score, e, dp and dsp tile lives in registers in both.
//
// Replaces: duodiff_tpu/ops/pallas_attention.py _flash_attention_bwd_impl
// (kernel _bwd_kernel). As there, the forward saves only q, k and v, the
// softmax is rebuilt here, and no (L, L) tensor ever reaches device memory:
// the only scratch is the row statistics m, r, c (3 * B * H * L floats). q
// comes in unscaled and dq is the gradient for that tensor. The rounding
// points are the Pallas kernel's (attn_bwd_core.cuh lists them).
// Bound: 10 * L * L * Dh flops per (sample, head) against 14 * L * Dh bytes
// at the roofline (bytes); this core forms the scores in both launches and
// is bound by its instruction count. No atomics: a repeat call gives the same
// bits.

#include "attn_bwd_core.cuh"
#include "common.cuh"

using duodiff::bf16;

// Floats of scratch duodiff_flash_attention_bwd takes.
extern "C" size_t duodiff_flash_attention_bwd_stats(int B, int H, int L) {
  return 3 * static_cast<size_t>(B) * H * L;
}

// Warps a block, dynamic shared memory a block and resident blocks an SM of
// the backward core's row launch (key 0) and key launch (key 1) at length L.
extern "C" int duodiff_attn_bwd_core_warps(int key) {
  return key ? duodiff::kBwdKeyWarps : duodiff::kBwdRowWarps;
}
extern "C" int duodiff_attn_bwd_core_smem_bytes(int L, int key) {
  return duodiff::attn_bwd_core_smem_bytes(L, key != 0);
}
extern "C" int duodiff_attn_bwd_core_blocks_per_sm(int L, int key) {
  return duodiff::attn_bwd_core_blocks_per_sm(L, key != 0);
}

// q, k, v, dout, dq, dk, dv: (B, H, L, 64) bf16, contiguous; stats: fp32
// scratch. Returns the first CUDA error, or 0.
extern "C" int duodiff_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           void* stats, int B, int H, int L, void* stream) {
  using namespace duodiff;
  constexpr int Dh = kBwdDh;
  const float scale = 1.f / sqrtf(static_cast<float>(Dh));
  const HeadRows<bf16> none{nullptr, 0, 0, 0};
  return launch_attn_bwd_core(
      split_heads(static_cast<const bf16*>(q), L, H, Dh),
      split_heads(static_cast<const bf16*>(k), L, H, Dh),
      split_heads(static_cast<const bf16*>(v), L, H, Dh),
      split_heads(static_cast<const bf16*>(dout), L, H, Dh), none,
      split_heads(static_cast<bf16*>(dq), L, H, Dh), split_heads(static_cast<bf16*>(dk), L, H, Dh),
      split_heads(static_cast<bf16*>(dv), L, H, Dh), static_cast<float*>(stats), B, L, H, scale,
      static_cast<cudaStream_t>(stream));
}
