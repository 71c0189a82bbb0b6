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
// kernel's group of samples per grid step has no counterpart: in both forms a
// block is one (head, sample), its warps walking the 16-row query tiles with
// the score rows in registers; the int8 core (attn_core_int8.cuh) quantizes
// the head's k and v once a block and keeps only their codes in shared
// memory. Both take L <= 272, a register limit.
// Bound: 4 * L * L * Dh operations per (sample, head) against 8 * L * Dh
// bytes: bytes at the roofline for both forms; see the two cores' notes for
// what bounds each on the card instead.

#include "attn_core.cuh"
#include "attn_core_int8.cuh"
#include "common.cuh"

using duodiff::bf16;

// The int8 core at sequence length L: the longest L it takes, warps a
// block, dynamic shared memory a block (0 past the longest L) and resident
// blocks an SM.
extern "C" int duodiff_sdpa_int8_max_len() { return duodiff::kMaxSeq; }
extern "C" int duodiff_sdpa_int8_warps() { return duodiff::kI8AttnWarps; }
extern "C" int duodiff_sdpa_int8_smem_bytes(int L) {
  return duodiff::attn_core_int8_smem_bytes(L);
}
extern "C" int duodiff_sdpa_int8_blocks_per_sm(int L) {
  return duodiff::attn_core_int8_blocks_per_sm(L);
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
