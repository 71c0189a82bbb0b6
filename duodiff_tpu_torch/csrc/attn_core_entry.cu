// The attention cores on their own, in either form at a length both take,
// for measuring them: no model calls these entries. The forward core of
// attn_core.cuh: K1, K1-v1, K5, K9, K11 and K15's bf16 form reach the same
// device code through launch_attn_core / launch_attn_core_form; the backward
// core of attn_bwd_core.cuh: K6 and K10 through launch_attn_bwd_core. Both
// launches pick the form by L.

#include "attn_bwd_core.cuh"
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

// q, k, v, dout, dq, dk, dv (and o unless null): (B, H, L, Dh) bf16,
// contiguous, Dh 64 or 72; stats: 3 * B * H * L floats of scratch. form as
// duodiff_attn_core_form's; the backward of K10 (o null) or, with o, of K6's
// core, which also writes the forward output. Returns the first CUDA error,
// or 0.
extern "C" int duodiff_attn_bwd_core_form(const void* q, const void* k, const void* v,
                                          const void* dout, void* o, void* dq, void* dk, void* dv,
                                          void* stats, int B, int H, int L, int Dh, int form,
                                          void* stream) {
  using namespace duodiff;
  if (form < kCoreAuto || form > kCoreBlocked) return cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf(static_cast<float>(Dh));
  const HeadRows<bf16> none{nullptr, 0, 0, 0};
  return launch_attn_bwd_core(
      split_heads(static_cast<const bf16*>(q), L, H, Dh),
      split_heads(static_cast<const bf16*>(k), L, H, Dh),
      split_heads(static_cast<const bf16*>(v), L, H, Dh),
      split_heads(static_cast<const bf16*>(dout), L, H, Dh),
      o == nullptr ? none : split_heads(static_cast<bf16*>(o), L, H, Dh),
      split_heads(static_cast<bf16*>(dq), L, H, Dh), split_heads(static_cast<bf16*>(dk), L, H, Dh),
      split_heads(static_cast<bf16*>(dv), L, H, Dh), static_cast<float*>(stats), B, L, H, Dh,
      scale, static_cast<cudaStream_t>(stream), form);
}
