// K15: the attention chain alone, softmax(q k^T) v WITHOUT the 1/sqrt(Dh)
// scale, in two forms on (B, H, L, 64) bf16 tensors:
//
//   bf16: fp32 scores, e = exp(s - m) rounded to bf16 for e v, the division
//         by the fp32 sum of the unrounded e after the value product;
//   int8: q and k quantized per row, v per column over the tokens, e as
//         round(e * 127); both contractions on the int8 tensor cores, the
//         softmax in fp32 (attn_core_int8.cuh).
//
// Replaces: tools/probe_int8_sdpa.py build.run and main.single (bodies
// _sdpa_bf16_kernel :46-59 and _sdpa_int8_kernel :68-90). The bf16 body is
// the attention core of K1 and K9 (attn_core.cuh) with no scale: this entry
// launches that core with qscale = 1, which leaves q untouched. The TPU
// kernel's group of samples per grid step has no counterpart: a block is one
// (head, sample) in the bf16 form, whose scores live in registers, and one
// (64 query rows, head, sample) in the int8 form, which still keeps its fp32
// score rows in shared memory.
// Bound: 4 * L * L * Dh operations per (sample, head) against 8 * L * Dh
// bytes: bytes at the roofline for both forms; see the two cores' notes for
// what bounds each on the card instead.

#include "attn_core.cuh"
#include "attn_core_int8.cuh"
#include "common.cuh"

using duodiff::bf16;

// Dynamic shared memory the int8 core needs for sequence length L, so that
// the caller can refuse a length that does not fit a block.
extern "C" int duodiff_sdpa_int8_smem_bytes(int L) {
  return static_cast<int>(duodiff::attn_int8_smem(L).total);
}

// q, k, v, out: (B, H, L, 64) bf16, contiguous. Returns the first CUDA
// error, or 0.
extern "C" int duodiff_sdpa_chain_bf16(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int L, void* stream) {
  using namespace duodiff;
  return launch_attn_core(split_heads(static_cast<const bf16*>(q), L, H, kDh),
                          split_heads(static_cast<const bf16*>(k), L, H, kDh),
                          split_heads(static_cast<const bf16*>(v), L, H, kDh),
                          split_heads(static_cast<bf16*>(out), L, H, kDh), B, L, H, 1.f,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int duodiff_sdpa_chain_int8(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int L, void* stream) {
  using namespace duodiff;
  return launch_attn_core_int8(split_heads(static_cast<const bf16*>(q), L, H, kI8Dh),
                               split_heads(static_cast<const bf16*>(k), L, H, kI8Dh),
                               split_heads(static_cast<const bf16*>(v), L, H, kI8Dh),
                               split_heads(static_cast<bf16*>(out), L, H, kI8Dh), B, L, H,
                               static_cast<cudaStream_t>(stream));
}
