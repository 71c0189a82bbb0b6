// The attention core of K1, K11 and K9: softmax(q k^T) v per (sample,
// head) on bf16 rows given as HeadRows views (common.cuh): for K1 and K11
// the packed (B, L, 3A) qkv tensor with q pre-scaled by the softmax scale
// and the merged heads out as (B, L, A); for K9 three (B, H, L, Dh) tensors,
// q scaled here (qscale, q * qscale rounded to bf16), out (B, H, L, Dh).
//
// Replaces: the per-head SDPA loop of duodiff_tpu/ops/pallas_block.py
// _kernel_v2 (:139-157) and of pallas_block_int8.py _kernel_v2_int8
// (:130-146), and duodiff_tpu/ops/pallas_attention.py _kernel (:30-52),
// which are the same: fp32 scores, e = exp(s - m) rounded to bf16 for e v,
// and the division by the fp32 sum of the unrounded e after the value
// product.
//
// Bound: 4*L*L*Dh flops per (sample, head) against 8*L*Dh bytes of bf16 q,
// k, v and output (L/2, ~128 flop/byte at L = 257, under the card's ~295
// balance point): bytes at the roofline. What a kernel of this size pays
// for on the card is its instruction count (an exp, a max, a sum and a rounding
// per score) and latency with few warps resident. The design keeps the
// score rows out of shared memory and the instructions per score few:
//   - a warp owns 16 query rows and ALL their keys: 34 accumulator tiles of
//     mma.sync m16n8k16 = 136 fp32 registers a thread at L = 272 (the
//     bound on L), plus 32 for the 16 x 64 output. The row max and the row
//     sum are exact two-pass reductions over those registers and the four
//     lanes that share a row (shuffles), so the Pallas kernels' rounding
//     points stay: no online rescaling. e is packed to bf16 in registers:
//     the accumulator layout of q k^T is the A layout of e v
//     (attn_tiles.cuh). No score, no e and no output tile is ever in shared
//     memory; the output leaves as 16-byte stores after a four-lane
//     exchange;
//   - the tile count is a template argument (three classes of L, SeqClass
//     in attn_tiles.cuh), so the loops over the tiles are straight-line
//     code without a branch between two tensor-core instructions; exp is
//     one multiplication and one ex2.approx, and the division by the row
//     sum one IEEE reciprocal a row and a multiplication;
//   - shared memory holds only K and V of the head, 128 bytes a row in an
//     XOR swizzle (no padding): 2 * 272 * 128 = 69,632 bytes at L = 257,
//     so three blocks would fit an SM; the registers (all 255 a thread
//     at L > 144, some 180 bytes of spills around q k^T, none in the
//     softmax) allow kAttnBlocksPerSm = 2 blocks of kAttnWarps = 4 warps;
//   - K and V arrive by cp.async in two groups: q k^T starts when K is
//     there, V lands behind it. Q is read straight from device memory into
//     the A registers (and scaled there);
//   - one block loads K and V once and its warps walk the 16-row query
//     tiles of the head (grid.x > 1 splits them over blocks when there are
//     few heads), so the ragged tail of L = 257 or 258 = 16 * 16 + 1 (2)
//     costs one more 16-row tile for one warp, not a block that stages the
//     whole head for one row. Keys past L are masked to -inf before the
//     max (e = 0), K / V / q rows past L are zeros, output rows past L are
//     never written.
// kNormFirst is the per-head attention sublayer's form (K1-v1, the Pallas
// _kernel :79-86): q comes unscaled, the fp32 scores are multiplied by
// `scale`, and p = e / sum is rounded to bf16 BEFORE the value product, so
// nothing is divided afterwards. It is a template argument: the default
// form's code does not change.
#pragma once

#include "common.cuh"
#include "attn_tiles.cuh"

namespace duodiff {
namespace {

constexpr int kDh = kHeadDim;            // head width the core takes
constexpr int kAttnWarps = 4;            // 16 query rows each, per trip
constexpr int kAttnBlocksPerSm = 2;      // what the register cap is set for

// scale: q is multiplied by it and rounded to bf16 (1: q comes pre-scaled);
// with kNormFirst q stays as it is and the fp32 scores are multiplied by it.
// Seq is the SeqClass of L (attn_tiles.cuh).
template <bool kNormFirst, typename Seq>
__global__ void __launch_bounds__(kAttnWarps * 32, kAttnBlocksPerSm)
attn_core_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                 HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTiles = Seq::kTiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Seq::kHeadBytes;
  const unsigned k_stage = static_cast<unsigned>(__cvta_generic_to_shared(Ks));
  const unsigned v_stage = static_cast<unsigned>(__cvta_generic_to_shared(Vs));

  const int b = blockIdx.z, h = blockIdx.y;
  stage_head_async(Ks, k_rows.at(b, h), k_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();
  stage_head_async(Vs, v_rows.at(b, h), v_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();

  // every warp makes the same number of trips, so that the two barriers of
  // the first one are reached by all; a warp with no tile left idles
  const int tiles = (L + 15) / 16, per_trip = gridDim.x * kAttnWarps;
  const int trips = (tiles + per_trip - 1) / per_trip;
  for (int trip = 0; trip < trips; ++trip) {
    const int q0 = ((trip * gridDim.x + blockIdx.x) * kAttnWarps + warp) * 16;
    const bool active = q0 < L;
    unsigned qa[4][4];
    float s[kTiles][4];
    if (active)
      load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, kNormFirst ? 1.f : scale);
    if (trip == 0) {
      cp_async_wait<1>();  // K has landed, V is still in flight
      __syncthreads();
    }
    if (active) score_tiles<kTiles>(s, qa, k_stage, lane);
    if (trip == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    if (kNormFirst) {
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
      }
    }
    float m_lo, m_hi, sum_lo, sum_hi;
    softmax_rows<kTiles, Seq::kMaskFrom>(s, L, lane, m_lo, m_hi, sum_lo, sum_hi);
    // the division by the row sum as one IEEE reciprocal a row and a
    // multiplication: within an ulp of the fp32 quotient, which the rounding
    // to bf16 that follows swallows, at a tenth of a division's instructions
    const float r_lo = __frcp_rn(sum_lo), r_hi = __frcp_rn(sum_hi);
    if (kNormFirst) {  // p = e / sum, rounded to bf16 by the value product's packing
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        s[nt][0] *= r_lo;
        s[nt][1] *= r_lo;
        s[nt][2] *= r_hi;
        s[nt][3] *= r_hi;
      }
    }
    float o[8][4];
    value_tiles<kTiles>(o, s, v_stage, lane);
    store_tile64(out.at(b, h), out.row, q0, L, lane, o, kNormFirst ? 1.f : r_lo,
                 kNormFirst ? 1.f : r_hi);
  }
}

template <bool kNormFirst>
cudaError_t launch_attn_core_form(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                  HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L, int H,
                                  float scale, cudaStream_t stream) {
  if (L < 1 || L > kMaxSeq) return cudaErrorInvalidValue;
  return with_seq_class(L, [&](auto seq) {
    using Seq = decltype(seq);
    constexpr size_t smem = 2 * Seq::kHeadBytes;
    cudaError_t err = cudaFuncSetAttribute(
        attn_core_kernel<kNormFirst, Seq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // one block a head when the heads alone fill the card twice over
    const dim3 grid(head_splits(B * H, L, kAttnWarps, 2 * kSmCount * kAttnBlocksPerSm), H, B);
    attn_core_kernel<kNormFirst, Seq><<<grid, kAttnWarps * 32, smem, stream>>>(q, k, v, out, L,
                                                                              scale);
    return cudaGetLastError();
  });
}

// Dynamic shared memory of a block of the core at sequence length L (K and
// V of the head) and the blocks one SM holds, by registers and shared
// memory, as the runtime reckons them (0 on an error).
inline int attn_core_smem_bytes(int L) {
  return with_seq_class(L, [](auto seq) {
    return static_cast<int>(2 * decltype(seq)::kHeadBytes);
  });
}

inline int attn_core_blocks_per_sm(int L) {
  return with_seq_class(L, [](auto seq) {
    using Seq = decltype(seq);
    constexpr size_t smem = 2 * Seq::kHeadBytes;
    int blocks = 0;
    if (cudaFuncSetAttribute(attn_core_kernel<false, Seq>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_core_kernel<false, Seq>,
                                                      kAttnWarps * 32, smem) != cudaSuccess)
      return 0;
    return blocks;
  });
}

// The default form: q * qscale rounded to bf16, normalised after e v.
cudaError_t launch_attn_core(HeadRows<const bf16> q, HeadRows<const bf16> k,
                             HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L, int H,
                             float qscale, cudaStream_t stream) {
  return launch_attn_core_form<false>(q, k, v, out, B, L, H, qscale, stream);
}

// The core on a packed (B, L, 3A) qkv with pre-scaled q, merged heads out.
cudaError_t launch_attn_core(const bf16* qkv, bf16* merged, int B, int L, int H,
                             cudaStream_t stream) {
  return launch_attn_core(packed_third(qkv, 0, L, H, kDh), packed_third(qkv, 1, L, H, kDh),
                          packed_third(qkv, 2, L, H, kDh), merged_heads(merged, L, H, kDh), B, L,
                          H, 1.f, stream);
}

}  // namespace
}  // namespace duodiff
