// The attention core of K1, K1-v1, K5, K9, K11 and K15's bf16 form:
// softmax(q k^T) v per (sample,
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
// balance point): bytes at the roofline, at either head width. What a kernel of this size pays
// for on the card is its instruction count (an exp, a max, a sum and a rounding
// per score) and latency with few warps resident. The design keeps the
// score rows out of shared memory and the instructions per score few:
//   - a warp owns 16 query rows and ALL their keys: 34 accumulator tiles of
//     mma.sync m16n8k16 = 136 fp32 registers a thread at L = 272 (the
//     bound on L), plus 32 for the 16 x 64 output (36 for 16 x 72, and q's
//     A operand 18 registers instead of 16: the k8 step of Dh = 72). The row max and the row
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
//     XOR swizzle at Dh = 64, 144 bytes a row unswizzled at 72 (HeadDim in
//     attn_tiles.cuh; neither is padded): 2 * 272 * 128 = 69,632 bytes at
//     L = 257 and Dh = 64, 78,336 at Dh = 72, so three (two) blocks would
//     fit an SM; the registers (all 255 a thread at L > 144, some 180 bytes
//     of spills around q k^T at 64, none in the softmax) allow
//     kAttnBlocksPerSm = 2 blocks of kAttnWarps = 4 warps, at both widths
//     and up to L = 272 (chip_smoke.py phase 2 prints ptxas's spills at 72);
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
//
// Two forms, picked by L at the launch: the register form above up to
// kMaxSeq = 272 keys, and past it, up to kMaxSeqBlocked, the blocked form
// (attn_core_blocked_kernel below), which walks the keys in blocks with the
// same rounding points and gives the register form's bits at the lengths
// both take. At L = 1025 (CelebA-64 at patch 2) the product is
// 4*L*L*Dh against 8*L*Dh bytes, ~513 flop/byte: past the balance point, so
// the blocked form is bound by operations there.
#pragma once

#include "common.cuh"
#include "attn_tiles.cuh"

namespace duodiff {
namespace {

constexpr int kAttnWarps = 4;            // 16 query rows each, per trip
constexpr int kAttnBlocksPerSm = 2;      // what the register cap is set for

// In place: every score times `scale`, rounded once (never fused into the
// subtraction of the row max that follows, so that both forms of the core
// round the scaled score as the Pallas kernel does).
template <int kTiles>
__device__ __forceinline__ void scale_tiles(float (&s)[kTiles][4], float scale) {
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = __fmul_rn(s[nt][e], scale);
  }
}

// scale: q is multiplied by it and rounded to bf16 (1: q comes pre-scaled);
// with kNormFirst q stays as it is and the fp32 scores are multiplied by it.
// Seq is the SeqClass of L, HD the HeadDim (attn_tiles.cuh).
template <bool kNormFirst, typename Seq, typename HD>
__global__ void __launch_bounds__(kAttnWarps * 32, kAttnBlocksPerSm)
attn_core_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                 HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTiles = Seq::kTiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + head_bytes<Seq, HD>();
  const unsigned k_stage = static_cast<unsigned>(__cvta_generic_to_shared(Ks));
  const unsigned v_stage = static_cast<unsigned>(__cvta_generic_to_shared(Vs));

  const int b = blockIdx.z, h = blockIdx.y;
  stage_head_async<HD>(Ks, k_rows.at(b, h), k_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();
  stage_head_async<HD>(Vs, v_rows.at(b, h), v_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();

  // every warp makes the same number of trips, so that the two barriers of
  // the first one are reached by all; a warp with no tile left idles
  const int tiles = (L + 15) / 16, per_trip = gridDim.x * kAttnWarps;
  const int trips = (tiles + per_trip - 1) / per_trip;
  for (int trip = 0; trip < trips; ++trip) {
    const int q0 = ((trip * gridDim.x + blockIdx.x) * kAttnWarps + warp) * 16;
    const bool active = q0 < L;
    ARows<HD> qa;
    float s[kTiles][4];
    if (active)
      load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, kNormFirst ? 1.f : scale);
    if (trip == 0) {
      cp_async_wait<1>();  // K has landed, V is still in flight
      __syncthreads();
    }
    if (active) score_tiles<kTiles, HD>(s, qa, k_stage, lane);
    if (trip == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    if (kNormFirst) scale_tiles(s, scale);
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
    float o[HD::kChunks][4];
    value_tiles<kTiles, HD>(o, s, v_stage, lane);
    store_tile<HD>(out.at(b, h), out.row, q0, L, lane, o, kNormFirst ? 1.f : r_lo,
                   kNormFirst ? 1.f : r_hi);
  }
}

// Dynamic shared memory of a block of class Seq and width HD: K and V of
// the head.
template <typename Seq, typename HD>
constexpr size_t attn_core_smem() {
  return 2 * head_bytes<Seq, HD>();
}

// ---- the blocked form: lengths past kMaxSeq ----
//
// Past 272 keys a warp can no longer hold 16 whole score rows in registers,
// so the keys come in blocks of 64 (BlkKeys: 8 score tiles, 32 fp32
// registers a thread) and each warp walks them in passes, with no online
// rescaling, so that every rounding point of the register form stays:
//   pass 1 forms s block by block and keeps the running row max (a max is
//     exact in any order, so m is the register form's);
//   pass 2 forms s again, e = exp_nonpos(s - m), adds e to the lane's running
//     sums tile by tile (exp_tiles, the register form's order) and, in the
//     default form, packs e to bf16 and chains o += e v through the mma
//     accumulators in key order across the blocks; at the end the sums are
//     shuffled over the row's four lanes (quad_sum) and o * (1 / sum) is
//     stored, as the register form does;
//   in the normalise-first form (kNormFirst) pass 2 only sums, and pass 3
//     forms e once more, p = e * (1 / sum) rounded to bf16 by the packing,
//     and o = p v.
// Every number is thus formed by the register form's instructions in its
// order; blocks past L add exact zeros (e = 0 against rows of zeros) to the
// sums and to o, which leave them unchanged. So at any L <= 272 the two
// forms give the same bits (chip_smoke.py phase 22a holds them to it at
// L = 257 and 258 through duodiff_attn_core_form).
//
// A block of kBlkWarps warps owns 16 query rows a warp, q in the A
// registers across the passes (loaded once), and streams K (every pass)
// and V (the last pass) through a ring of kBlkStages stages by cp.async,
// shared by its warps: stage i + 1 is in flight while stage i is
// multiplied. A stage is a K and a V block: 2 * 64 * 128 B = 16 KiB at
// Dh = 64, 18 KiB at 72, 32 / 36 KiB a block. K is read twice (three times
// in the normalise-first form) and V once, from L2 after the first block
// of the head has read them.
constexpr int kBlkWarps = 8;
constexpr int kBlkBlocksPerSm = 2;       // what the register cap (128) is set for
constexpr int kBlkStages = 2;
using BlkKeys = KeyBlock<8>;             // 64 keys a stage

template <bool kNormFirst, typename HD>
__global__ void __launch_bounds__(kBlkWarps * 32, kBlkBlocksPerSm)
attn_core_blocked_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                         HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTiles = BlkKeys::kTiles, kKeys = BlkKeys::kKeys;
  constexpr int kPasses = kNormFirst ? 3 : 2;
  constexpr unsigned kSlot = static_cast<unsigned>(head_bytes<BlkKeys, HD>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (blockIdx.x * kBlkWarps + warp) * 16;
  const bool active = q0 < L;  // a warp with no rows still stages and syncs
  const int blocks = (L + kKeys - 1) / kKeys, items = kPasses * blocks;
  const bf16* k_head = k_rows.at(b, h);
  const bf16* v_head = v_rows.at(b, h);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // item i: pass i / blocks over key block i % blocks, into stage i % 2: its
  // K rows in the stage's first slot, in the last pass its V rows in the second
  auto stage_item = [&](int i) {
    unsigned char* st = smem + (i % kBlkStages) * 2 * kSlot;
    const int key0 = (i % blocks) * kKeys;
    stage_head_async<HD>(st, k_head + key0 * k_rows.row, k_rows.row, kKeys, L - key0,
                         threadIdx.x, blockDim.x);
    if (i / blocks == kPasses - 1)
      stage_head_async<HD>(st + kSlot, v_head + key0 * v_rows.row, v_rows.row, kKeys, L - key0,
                           threadIdx.x, blockDim.x);
    cp_async_commit();
  };

  ARows<HD> qa;
  if (active)
    load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, kNormFirst ? 1.f : scale);
  const float neg_inf = __uint_as_float(0xff800000u);
  float m_lo = neg_inf, m_hi = neg_inf, sum_lo = 0.f, sum_hi = 0.f, r_lo = 1.f, r_hi = 1.f;
  float o[HD::kChunks][4];
  zero_tiles(o);
  const TransAt at = trans_at<HD>(lane);

  stage_item(0);
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      stage_item(i + 1);
      cp_async_wait<1>();  // item i has landed, item i + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pass = i / blocks, key0 = (i % blocks) * kKeys;
    const unsigned k_stage = ring + (i % kBlkStages) * 2 * kSlot;
    if (active) {
      float s[kTiles][4];
      score_tiles<kTiles, HD>(s, qa, k_stage, lane);
      if (kNormFirst) scale_tiles(s, scale);
      if (key0 + kKeys > L) mask_keys(s, L - key0, lane);
      if (pass == 0) {
        max_tiles(s, m_lo, m_hi);
      } else {
        float dummy_lo = 0.f, dummy_hi = 0.f;  // pass 3 sums nothing
        if (pass == 1)
          exp_tiles(s, m_lo, m_hi, sum_lo, sum_hi);
        else
          exp_tiles(s, m_lo, m_hi, dummy_lo, dummy_hi);
        if (pass == kPasses - 1) {
          if (kNormFirst) {  // p = e / sum, rounded to bf16 by the packing
#pragma unroll
            for (int nt = 0; nt < kTiles; ++nt) {
              s[nt][0] *= r_lo;
              s[nt][1] *= r_lo;
              s[nt][2] *= r_hi;
              s[nt][3] *= r_hi;
            }
          }
#pragma unroll
          for (int kk = 0; kk < kTiles / 2; ++kk) {
            unsigned a[4];
            pack_a(a, s, kk);
            rows_product_step<HD>(o, a, k_stage + kSlot, at, kk);
          }
        }
      }
      if (i % blocks == blocks - 1) {  // a pass ends
        if (pass == 0) quad_max(m_lo, m_hi);
        if (pass == 1) {
          quad_sum(sum_lo, sum_hi);
          r_lo = __frcp_rn(sum_lo);
          r_hi = __frcp_rn(sum_hi);
        }
        if (pass == kPasses - 1)
          store_tile<HD>(out.at(b, h), out.row, q0, L, lane, o, kNormFirst ? 1.f : r_lo,
                         kNormFirst ? 1.f : r_hi);
      }
    }
    __syncthreads();  // every warp is done with stage i % 2 before item i + 2 lands there
  }
}

// Dynamic shared memory of a block of the blocked form at width HD: the ring.
template <typename HD>
constexpr size_t attn_core_blocked_smem() {
  return static_cast<size_t>(kBlkStages) * 2 * head_bytes<BlkKeys, HD>();
}

template <bool kNormFirst, typename HD>
cudaError_t launch_attn_core_blocked(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                     HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L,
                                     int H, float scale, cudaStream_t stream) {
  constexpr size_t smem = attn_core_blocked_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(attn_core_blocked_kernel<kNormFirst, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block a group of kBlkWarps 16-row query tiles: each block streams the
  // head's keys anyway, so a block that walked several groups would save nothing
  const dim3 grid((L + 16 * kBlkWarps - 1) / (16 * kBlkWarps), H, B);
  attn_core_blocked_kernel<kNormFirst, HD><<<grid, kBlkWarps * 32, smem, stream>>>(
      q, k, v, out, L, scale);
  return cudaGetLastError();
}

// Head width Dh (64 or 72), 1 <= L <= kMaxSeqBlocked, the register form
// only up to kMaxSeq; anything else is refused.
template <bool kNormFirst>
cudaError_t launch_attn_core_form(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                  HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L, int H,
                                  int Dh, float scale, cudaStream_t stream,
                                  int form = kCoreAuto) {
  if (L < 1 || L > kMaxSeqBlocked || (form == kCoreRegisters && L > kMaxSeq))
    return cudaErrorInvalidValue;
  return with_head_dim(Dh, cudaErrorInvalidValue, [&](auto hd) {
    using HD = decltype(hd);
    if (blocked_form(L, form))
      return launch_attn_core_blocked<kNormFirst, HD>(q, k, v, out, B, L, H, scale, stream);
    return with_seq_class(L, [&](auto seq) {
      using Seq = decltype(seq);
      constexpr size_t smem = attn_core_smem<Seq, HD>();
      cudaError_t err = cudaFuncSetAttribute(
          attn_core_kernel<kNormFirst, Seq, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      // one block a head when the heads alone fill the card twice over
      const dim3 grid(head_splits(B * H, L, kAttnWarps, 2 * kSmCount * kAttnBlocksPerSm), H, B);
      attn_core_kernel<kNormFirst, Seq, HD><<<grid, kAttnWarps * 32, smem, stream>>>(
          q, k, v, out, L, scale);
      return cudaGetLastError();
    });
  });
}

// Dynamic shared memory of a block of the core at sequence length L and
// head width Dh (K and V of the head, or the blocked form's ring past
// kMaxSeq), warps a block, and the blocks one SM holds, by registers and
// shared memory, as the runtime reckons them (0 on an error or a length or
// width the core does not take).
inline int attn_core_smem_bytes(int L, int Dh) {
  if (L < 1 || L > kMaxSeqBlocked) return 0;
  return with_head_dim(Dh, 0, [&](auto hd) {
    using HD = decltype(hd);
    if (L > kMaxSeq) return static_cast<int>(attn_core_blocked_smem<HD>());
    return with_seq_class(L, [](auto seq) {
      return static_cast<int>(attn_core_smem<decltype(seq), HD>());
    });
  });
}

inline int attn_core_warps(int L) { return L > kMaxSeq ? kBlkWarps : kAttnWarps; }

inline int attn_core_blocks_per_sm(int L, int Dh) {
  if (L < 1 || L > kMaxSeqBlocked) return 0;
  return with_head_dim(Dh, 0, [&](auto hd) {
    using HD = decltype(hd);
    if (L > kMaxSeq)
      return resident_blocks(attn_core_blocked_kernel<false, HD>, kBlkWarps * 32,
                             attn_core_blocked_smem<HD>());
    return with_seq_class(L, [](auto seq) {
      using Seq = decltype(seq);
      return resident_blocks(attn_core_kernel<false, Seq, HD>, kAttnWarps * 32,
                             attn_core_smem<Seq, HD>());
    });
  });
}

// The default form: q * qscale rounded to bf16, normalised after e v.
cudaError_t launch_attn_core(HeadRows<const bf16> q, HeadRows<const bf16> k,
                             HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L, int H,
                             int Dh, float qscale, cudaStream_t stream) {
  return launch_attn_core_form<false>(q, k, v, out, B, L, H, Dh, qscale, stream);
}

// The core on a packed (B, L, 3A) qkv with pre-scaled q, merged heads out.
cudaError_t launch_attn_core(const bf16* qkv, bf16* merged, int B, int L, int H, int Dh,
                             cudaStream_t stream) {
  return launch_attn_core(packed_third(qkv, 0, L, H, Dh), packed_third(qkv, 1, L, H, Dh),
                          packed_third(qkv, 2, L, H, Dh), merged_heads(merged, L, H, Dh), B, L,
                          H, Dh, 1.f, stream);
}

}  // namespace
}  // namespace duodiff
