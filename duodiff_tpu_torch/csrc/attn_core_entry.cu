// The forward attention core of attn_core.cuh on its own, in either form at
// a length both take, for measuring it: no model calls this entry. K1,
// K1-v1, K5, K9, K11 and K15's bf16 form reach the same device code through
// launch_attn_core / launch_attn_core_form, which pick the form by L.

#include "attn_core.cuh"
#include "common.cuh"

using duodiff::bf16;

// The longest sequence the register form takes (the blocked form takes the
// longer ones, up to duodiff_attn_core_max_len).
extern "C" int duodiff_attn_core_registers_max_len() { return duodiff::kMaxSeq; }

// q, k, v, out: (B, H, L, Dh) bf16, contiguous, Dh 64 or 72. form 0 picks
// by L as the kernels do, 1 forces the register form (L <= 272), 2 the
// blocked one. norm_first 0: q * scale rounded to bf16, normalised after
// e v (K1, K9, K11, K15); 1: q as it is, the fp32 scores times scale, p =
// e / sum rounded before p v (K1-v1). Returns the first CUDA error, or 0.
extern "C" int duodiff_attn_core_form(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int L, int Dh, int form, int norm_first,
                                      float scale, void* stream) {
  using namespace duodiff;
  const auto qh = split_heads(static_cast<const bf16*>(q), L, H, Dh);
  const auto kh = split_heads(static_cast<const bf16*>(k), L, H, Dh);
  const auto vh = split_heads(static_cast<const bf16*>(v), L, H, Dh);
  const auto oh = split_heads(static_cast<bf16*>(out), L, H, Dh);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form < kCoreAuto || form > kCoreBlocked) return cudaErrorInvalidValue;
  if (norm_first)
    return launch_attn_core_form<true>(qh, kh, vh, oh, B, L, H, Dh, scale, s, form);
  return launch_attn_core_form<false>(qh, kh, vh, oh, B, L, H, Dh, scale, s, form);
}
