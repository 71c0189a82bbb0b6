// The attention core of K6 and K10: the backward of
// softmax(q k^T * scale) v per (sample, head) on bf16 rows given as
// HeadRows views (common.cuh), q unscaled. For K6 the operands are the
// packed (B, L, 3A) qkv and the merged-head gradient dm = dy Wp^T (B, L, A)
// as the incoming do, and dq, dk, dv go into a packed dqkv; for K10 they are
// separate (B, H, L, Dh) tensors and no merged output is written.
//
// Replaces: the per-head loop of duodiff_tpu/ops/pallas_block.py
// _attn_bwd_kernel (:289-341) and duodiff_tpu/ops/pallas_attention.py
// _bwd_kernel (:72-119), the same arithmetic. With e = exp(s - m) and
// r = 1 / rowsum(e):
//   qsc = bf16(q * scale), s = qsc k^T (fp32);
//   o   = bf16((bf16(e) v) * r)                      -> merged heads (K6 only)
//   dv  = bf16(bf16(e)^T bf16(do * r))
//   dp  = do v^T, c = rowsum(dp * e) * r, dsp = bf16(e * (dp - c))
//   dq  = bf16((dsp k) * (r * scale)), dk = bf16(dsp^T bf16(qsc * r))
// every rounding at the Pallas kernel's own point.
//
// The Pallas kernel holds a whole (L, L) head in VMEM. Here the rows and
// the columns of that matrix are reduced by different warps, and nothing is
// carried from one block to another, so the core is two launches, both on
// the register-resident tiles of the forward core (attn_core.cuh,
// attn_tiles.cuh): no score, e, dp or dsp tile ever touches shared memory.
//   - attn_bwd_q_kernel, the forward core's layout: K and V of the head
//     arrive by cp.async (two groups) into a swizzled stage, a block's 4
//     warps walk the 16-row query tiles, two blocks an SM. A warp holds the
//     16 x L rows of e in 136 registers; dp of a second such row does not
//     fit beside them, so dp is formed 16 keys at a time, once for
//     c = rowsum(dp * e) * r and, when c is known, once more for dsp, which
//     replaces e in place and goes to dsp k from registers. It writes the
//     row statistics m, r and c, the merged output o (K6) and dq. 69,632
//     bytes of shared memory at L = 257; all 255 registers a thread and,
//     with e, the dq tile and do's A operand live together, about a
//     kilobyte of spills a thread around the two dp passes;
//   - attn_bwd_kv_kernel: a warp owns 16 KEYS and forms s^T = k qsc^T and
//     dp^T = v do^T against 16 queries at a time, so e^T and dsp^T are born
//     in the A layout of the products that sum over the queries
//     (dv += e^T (do r), dk += dsp^T (qsc r)); dk and dv stay in registers
//     over all queries. A block stages qsc, bf16(qsc * r), do and
//     bf16(do * r) of the whole head once (through registers, for the
//     scaling; 141,440 bytes at L = 257, one block an SM), k and v come
//     straight from device memory as A operands. One block a head with
//     kBwdKeyWarps = 9 warps: the 17 key tiles of L = 257 or 258 are two
//     trips for all but one warp.
// The two launches form s and dp from the same products, summed over the
// same four k-steps in the same order (the operands change sides, a product
// does not care), so e agrees between dq and dk / dv.
// Bound: 10 * L^2 * Dh flops per (sample, head) against 14 * L * Dh bytes
// at the roofline (bytes). On the card the core pays for its instruction count
// (two exps, the dsp arithmetic and the roundings per score; exp is one
// multiplication and one ex2.approx, attn_tiles.cuh) and for the eight or
// nine warps an SM holds at this many registers a thread.
// The head width Dh is a template argument (HeadDim in attn_tiles.cuh, 64
// or 72); at 72 the products over Dh (s, dp) take one more m16n8k8 step
// and the dq, dk and dv tiles one more 8-column accumulator tile, and the
// row launch spills more (chip_smoke.py phase 2 prints ptxas's report).
// Determinism: every sum runs in a fixed order inside one warp; no atomics.
// L = 257 or 258 is ragged: keys past L are masked (e = 0), query rows past
// L are zeros with e = 0 in the key launch, so they add nothing to dk and
// dv; rows past L are never written.
//
// Two forms, picked by L at the launch as the forward core's are: the
// register form above up to kMaxSeq = 272, and past it, up to
// kMaxSeqBlocked, the blocked form (attn_bwd_q_blocked_kernel and
// attn_bwd_kv_blocked_kernel below), whose launches hold no whole head
// anywhere and give the register form's bits at the lengths both take. At
// L = 1025 (CelebA-64 at patch 2) the core does 10 * L^2 * Dh flops against
// 14 * L * Dh bytes a head, ~730 flop/byte: bound by operations.
#pragma once

#include "attn_tiles.cuh"
#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kBwdRowWarps = 4;        // 16 query rows each, per trip
constexpr int kBwdRowBlocksPerSm = 2;  // what the row launch's register cap is set for
constexpr int kBwdKeyWarps = 9;        // 16 keys each, per trip

// The arithmetic both forms share, written with explicit roundings
// (__fmul_rn and the like) so that no compiler fuses a multiplication into
// an addition in one form and not in the other: the two forms give equal
// bits because every number is formed by these instructions in this order.
//
// dsp = e * (dp - c), before its rounding to bf16.
__device__ __forceinline__ float dsp_of(float e, float dp, float c) {
  return __fmul_rn(e, __fsub_rn(dp, c));
}

// The running sums c += dp * e of rows g (lo) and g + 8 (hi) over two
// neighbouring tiles (16 keys) of dp and of e, in tile order, a row's two
// columns first.
__device__ __forceinline__ void dp_e_pair(const float (&dp)[2][4], const float (*e)[4],
                                          float& c_lo, float& c_hi) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    c_lo = __fadd_rn(c_lo, __fmaf_rn(dp[t][0], e[t][0], __fmul_rn(dp[t][1], e[t][1])));
    c_hi = __fadd_rn(c_hi, __fmaf_rn(dp[t][2], e[t][2], __fmul_rn(dp[t][3], e[t][3])));
  }
}

// In place: two neighbouring tiles of e -> dsp = e * (dp - c).
__device__ __forceinline__ void dsp_pair(float (*e)[4], const float (&dp)[2][4], float c_lo,
                                         float c_hi) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    e[t][0] = dsp_of(e[t][0], dp[t][0], c_lo);
    e[t][1] = dsp_of(e[t][1], dp[t][1], c_lo);
    e[t][2] = dsp_of(e[t][2], dp[t][2], c_hi);
    e[t][3] = dsp_of(e[t][3], dp[t][3], c_hi);
  }
}

// c = (sum of dp * e) * r from this lane's sums: the sums over the row's
// four lanes, times r.
__device__ __forceinline__ void finish_c(float& c_lo, float& c_hi, float r_lo, float r_hi) {
  quad_sum(c_lo, c_hi);
  c_lo = __fmul_rn(c_lo, r_lo);
  c_hi = __fmul_rn(c_hi, r_hi);
}

// m, r and c of rows q0 + g and q0 + g + 8 (< L) into stats (m, r, c, each
// (B, H, L)), from the lane that holds column 0 of the row.
__device__ __forceinline__ void store_stats(float* stats, int B, int H, int L, int b, int h,
                                            int q0, int lane, float m_lo, float m_hi, float r_lo,
                                            float r_hi, float c_lo, float c_hi) {
  const int g = lane >> 2;
  if ((lane & 3) != 0) return;
  const size_t bhl = static_cast<size_t>(B) * H * L;
  const size_t idx = (static_cast<size_t>(b) * H + h) * L + q0 + g;
  if (q0 + g < L) {
    stats[idx] = m_lo;
    stats[bhl + idx] = r_lo;
    stats[2 * bhl + idx] = c_lo;
  }
  if (q0 + g + 8 < L) {
    stats[idx + 8] = m_hi;
    stats[bhl + idx + 8] = r_hi;
    stats[2 * bhl + idx + 8] = c_hi;
  }
}

// Chunk ch of staged query row `row` of the key launch from its q and do
// (zeros past L) and r: bf16(q * scale), bf16(qsc * r), do, bf16(do * r)
// into the four slots.
template <typename HD>
__device__ __forceinline__ void stage_query_chunk(unsigned char* qs, unsigned char* qr,
                                                  unsigned char* dos, unsigned char* dor, int row,
                                                  int ch, uint4 qv, uint4 dov, float r,
                                                  float scale) {
  const unsigned at = HD::staged_byte(row, ch);
  const uint4 qsc = scale8(qv, scale);
  *reinterpret_cast<uint4*>(qs + at) = qsc;
  *reinterpret_cast<uint4*>(qr + at) = scale8(qsc, r);
  *reinterpret_cast<uint4*>(dos + at) = dov;
  *reinterpret_cast<uint4*>(dor + at) = scale8(dov, r);
}

// The key launch's step over 16 queries: staged query rows 16qt..16qt+15 of
// the slots (qs_at, dos_at: rows_at of bf16(q * scale) and of do; qr_base,
// dor_base: the bases of bf16(qsc * r) and bf16(do * r)), the first of them
// query q_first, with their m and c at m_s[16qt..], c_s[16qt..]. Forms
// s^T = k qsc^T and dp^T = v do^T for the warp's 16 keys, e^T and dsp^T in
// the A layout, and adds dv += bf16(e)^T bf16(do * r), dk += dsp^T
// bf16(qsc * r): the queries are the reduction, so the staged rows are read
// transposed.
template <typename HD>
__device__ __forceinline__ void key_query_step(float (&dk)[HD::kChunks][4],
                                               float (&dv)[HD::kChunks][4], const ARows<HD>& ka,
                                               const ARows<HD>& va, RowsAt qs_at, RowsAt dos_at,
                                               unsigned qr_base, unsigned dor_base, TransAt t_at,
                                               const float* m_s, const float* c_s, int qt,
                                               int q_first, int L, bool key_lo, bool key_hi,
                                               int tg) {
  unsigned ea[4], dsa[4];
  float st2[2][4], dpt2[2][4];
  row_col_pair<HD>(st2, ka, qs_at, 2 * qt);
  row_col_pair<HD>(dpt2, va, dos_at, 2 * qt);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float(&st)[4] = st2[j], (&dpt)[4] = dpt2[j];
    const int ql = qt * 16 + j * 8 + tg * 2, q = q_first + ql;
    const float2 m2 = *reinterpret_cast<const float2*>(m_s + ql);
    const float2 c2 = *reinterpret_cast<const float2*>(c_s + ql);
    const bool q_a = q < L, q_b = q + 1 < L;
    const float e0 = key_lo && q_a ? exp_nonpos(st[0] - m2.x) : 0.f;
    const float e1 = key_lo && q_b ? exp_nonpos(st[1] - m2.y) : 0.f;
    const float e2 = key_hi && q_a ? exp_nonpos(st[2] - m2.x) : 0.f;
    const float e3 = key_hi && q_b ? exp_nonpos(st[3] - m2.y) : 0.f;
    ea[2 * j] = pack_bf16x2(e0, e1);
    ea[2 * j + 1] = pack_bf16x2(e2, e3);
    dsa[2 * j] = pack_bf16x2(dsp_of(e0, dpt[0], c2.x), dsp_of(e1, dpt[1], c2.y));
    dsa[2 * j + 1] = pack_bf16x2(dsp_of(e2, dpt[2], c2.x), dsp_of(e3, dpt[3], c2.y));
  }
  rows_product_step<HD>(dv, ea, dor_base, t_at, qt);
  rows_product_step<HD>(dk, dsa, qr_base, t_at, qt);
}

// Dynamic shared memory of attn_bwd_kv_kernel at sequence length L: four
// staged heads and the statistics m and c.
template <typename HD>
inline size_t attn_bwd_kv_smem_bytes(int L) {
  const size_t lpad = (L + 15) / 16 * 16;
  return 4 * lpad * HD::kRowBytes + 2 * lpad * sizeof(float);
}

// Row statistics, the forward output o (unless o.p is null) and dq.
// stats: m, r, c, each (B, H, L). Seq is the SeqClass of L, HD the
// HeadDim (attn_tiles.cuh).
template <typename Seq, typename HD>
__global__ void __launch_bounds__(kBwdRowWarps * 32, kBwdRowBlocksPerSm)
attn_bwd_q_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                  HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                  HeadRows<bf16> o_out, HeadRows<bf16> dq_out,
                  float* __restrict__ stats, int L, int H, float scale) {
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

  const RowsAt v_at = rows_at<HD>(v_stage, lane);
  const TransAt k_at = trans_at<HD>(lane);
  // every warp makes the same number of trips (the barriers of the first)
  const int tiles = (L + 15) / 16, per_trip = gridDim.x * kBwdRowWarps;
  const int trips = (tiles + per_trip - 1) / per_trip;
  for (int trip = 0; trip < trips; ++trip) {
    const int q0 = ((trip * gridDim.x + blockIdx.x) * kBwdRowWarps + warp) * 16;
    const bool active = q0 < L;
    ARows<HD> qa, da;
    float e[kTiles][4];
    if (active) {
      load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, scale);  // qsc = bf16(q * scale)
      load_a_rows(da, do_rows.at(b, h), do_rows.row, q0, L, lane, 1.f);
    }
    if (trip == 0) {
      cp_async_wait<1>();  // K has landed, V is still in flight
      __syncthreads();
    }
    if (active) score_tiles<kTiles, HD>(e, qa, k_stage, lane);
    if (trip == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    float m_lo, m_hi, sum_lo, sum_hi;
    softmax_rows<kTiles, Seq::kMaskFrom>(e, L, lane, m_lo, m_hi, sum_lo, sum_hi);
    const float r_lo = 1.f / sum_lo, r_hi = 1.f / sum_hi;

    if (o_out.p != nullptr) {  // the forward output bf16((bf16(e) v) * r), which K6 needs
      float o[HD::kChunks][4];
      value_tiles<kTiles, HD>(o, e, v_stage, lane);
      store_tile<HD>(o_out.at(b, h), o_out.row, q0, L, lane, o, r_lo, r_hi);
    }

    // c = rowsum(dp * e) * r with dp = do v^T, 16 keys at a time
    float c_lo = 0.f, c_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; nt += 2) {
      float dp[2][4];
      row_col_pair<HD>(dp, da, v_at, nt);
      dp_e_pair(dp, &e[nt], c_lo, c_hi);
    }
    finish_c(c_lo, c_hi, r_lo, r_hi);

    // dsp = bf16(e * (dp - c)), 16 keys at a time, in place of e, and
    // dq += dsp k
    float dq[HD::kChunks][4];
    zero_tiles(dq);
#pragma unroll
    for (int kk = 0; kk < kTiles / 2; ++kk) {
      float dp[2][4];
      row_col_pair<HD>(dp, da, v_at, 2 * kk);
      dsp_pair(&e[2 * kk], dp, c_lo, c_hi);
      unsigned a[4];
      pack_a(a, e, kk);
      rows_product_step<HD>(dq, a, k_stage, k_at, kk);
    }
    store_tile<HD>(dq_out.at(b, h), dq_out.row, q0, L, lane, dq, r_lo * scale, r_hi * scale);
    store_stats(stats, gridDim.z, H, L, b, h, q0, lane, m_lo, m_hi, r_lo, r_hi, c_lo, c_hi);
  }
}

// dk and dv of 16 keys a warp, summed over every query row.
template <typename HD>
__global__ void __launch_bounds__(kBwdKeyWarps * 32, 1)
attn_bwd_kv_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                   HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                   const float* __restrict__ stats,
                   HeadRows<bf16> dk_out, HeadRows<bf16> dv_out, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = (L + 15) / 16 * 16;
  const size_t head_bytes = static_cast<size_t>(lpad) * HD::kRowBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  unsigned char* QS = smem;                   // bf16(q * scale)
  unsigned char* QR = smem + head_bytes;      // bf16(qsc * r)
  unsigned char* DOS = smem + 2 * head_bytes; // do
  unsigned char* DOR = smem + 3 * head_bytes; // bf16(do * r)
  float* m_s = reinterpret_cast<float*>(smem + 4 * head_bytes);
  float* c_s = m_s + lpad;

  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q_rows.at(b, h);
  const bf16* dob = do_rows.at(b, h);
  const size_t bhl = static_cast<size_t>(gridDim.z) * H * L;
  const float* st_b = stats + (static_cast<size_t>(b) * H + h) * L;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < lpad * HD::kChunks; c += blockDim.x) {
    const int row = c / HD::kChunks, ch = c % HD::kChunks;
    uint4 qv = zero, dov = zero;
    float r = 0.f;
    if (row < L) {
      qv = *reinterpret_cast<const uint4*>(qb + row * q_rows.row + ch * kVec);
      dov = *reinterpret_cast<const uint4*>(dob + row * do_rows.row + ch * kVec);
      r = st_b[bhl + row];
    }
    stage_query_chunk<HD>(QS, QR, DOS, DOR, row, ch, qv, dov, r, scale);
  }
  for (int i = threadIdx.x; i < lpad; i += blockDim.x) {
    m_s[i] = i < L ? st_b[i] : 0.f;
    c_s[i] = i < L ? st_b[2 * bhl + i] : 0.f;
  }
  __syncthreads();  // the only barrier: the warps are independent below

  const unsigned qs_base = static_cast<unsigned>(__cvta_generic_to_shared(QS));
  const unsigned qr_base = static_cast<unsigned>(__cvta_generic_to_shared(QR));
  const unsigned dos_base = static_cast<unsigned>(__cvta_generic_to_shared(DOS));
  const unsigned dor_base = static_cast<unsigned>(__cvta_generic_to_shared(DOR));
  const RowsAt qs_at = rows_at<HD>(qs_base, lane), dos_at = rows_at<HD>(dos_base, lane);
  const TransAt t_at = trans_at<HD>(lane);

  for (int kt = blockIdx.x * kBwdKeyWarps + warp; kt * 16 < L; kt += gridDim.x * kBwdKeyWarps) {
    const int key0 = kt * 16;
    ARows<HD> ka, va;
    load_a_rows(ka, k_rows.at(b, h), k_rows.row, key0, L, lane, 1.f);
    load_a_rows(va, v_rows.at(b, h), v_rows.row, key0, L, lane, 1.f);
    const bool key_lo = key0 + g < L, key_hi = key0 + g + 8 < L;
    float dk[HD::kChunks][4], dv[HD::kChunks][4];
    zero_tiles(dk);
    zero_tiles(dv);
#pragma unroll 1
    for (int qt = 0; qt * 16 < lpad; ++qt)
      key_query_step<HD>(dk, dv, ka, va, qs_at, dos_at, qr_base, dor_base, t_at, m_s, c_s, qt, 0,
                         L, key_lo, key_hi, tg);
    store_tile<HD>(dk_out.at(b, h), dk_out.row, key0, L, lane, dk, 1.f, 1.f);
    store_tile<HD>(dv_out.at(b, h), dv_out.row, key0, L, lane, dv, 1.f, 1.f);
  }
}

// ---- the blocked form: lengths past kMaxSeq ----
//
// Past 272 keys neither launch can hold a whole head: the row launch's 16
// rows of e would be ~516 registers a thread at L = 1025, the key launch's
// four staged heads 540,800 bytes of shared memory at Dh = 64. So both
// stream the other side of the product in blocks of 64 rows (BwdBlk) through
// a two-stage ring, with no online rescaling: every number is formed by the
// register form's instructions in its order (the helpers above, and
// mask_keys, max_tiles, exp_tiles and quad_max / quad_sum, which split the
// forward's softmax_rows), and rows past L add exact zeros, so at any
// L <= 272 the two forms give the same bits (chip_smoke.py phase 22a holds
// them to it through duodiff_attn_bwd_core_form).
//   - attn_bwd_q_blocked_kernel: 8 warps of 16 query rows, qsc and do in the
//     A registers across three passes over the key blocks, K (every pass) and
//     V (passes 2 and 3) by cp.async into the ring, 16 keys at a time within
//     a block (two score tiles, 8 registers):
//       pass 1, the exact row max m (a max is exact in any order);
//       pass 2, e = exp(s - m), its per-lane fp32 sum in tile order, dp = do
//         v^T and the per-lane sums of dp * e in the register form's order,
//         and for K6 o += bf16(e) v chained in key order; at its end r, c and
//         o * r, as the register form forms them;
//       pass 3, e and dp once more, dsp = e * (dp - c) and dq += bf16(dsp) k
//         in key order; at its end dq * (r * scale) and the statistics.
//     One accumulator serves o in pass 2 and dq in pass 3, which holds the
//     registers under the cap of two blocks an SM. A stage is a K and a V
//     block: 16 KiB at Dh = 64, 18 KiB at 72, twice that a block.
//   - attn_bwd_kv_blocked_kernel: 8 warps of 16 keys, dk and dv in
//     registers as in the register form, the queries in blocks of 64: the
//     block's threads read the next block's q, do, r, m and c into registers
//     while its warps multiply the current one, then scale them through the
//     same instructions as the register form (stage_query_chunk) into the
//     other stage: bf16(q * scale), bf16(qsc * r), do and bf16(do * r), 33,280
//     bytes a stage at Dh = 64, 37,376 at 72. Scaling in the key launch, not
//     writing the three scaled copies from the row launch, keeps the scratch
//     at the statistics alone (3 * B * H * L floats) and reads q and do once
//     from device memory a block; the qt steps run in the register form's
//     order, qt = 0, 1, ... over the whole head.
// K and V (the row launch) and q and do (the key launch) are read again by
// each block of a head, from L2 after the first.
constexpr int kBwdBlkWarps = 8;         // 16 rows (row launch) or keys (key launch) each
constexpr int kBwdBlkRowBlocksPerSm = 2;  // what the row launch's register cap (128) is set for
constexpr int kBwdBlkStages = 2;
using BwdBlk = KeyBlock<8>;             // 64 keys (row launch) or queries (key launch) a stage

template <typename HD>
constexpr size_t attn_bwd_q_blocked_smem() {
  return static_cast<size_t>(kBwdBlkStages) * 2 * head_bytes<BwdBlk, HD>();
}

// A stage of the key launch: the four staged slots, then m and c.
template <typename HD>
__host__ __device__ constexpr size_t attn_bwd_kv_blocked_stage() {
  return 4 * head_bytes<BwdBlk, HD>() + 2 * BwdBlk::kKeys * sizeof(float);
}

template <typename HD>
constexpr size_t attn_bwd_kv_blocked_smem() {
  return kBwdBlkStages * attn_bwd_kv_blocked_stage<HD>();
}

template <typename HD>
__global__ void __launch_bounds__(kBwdBlkWarps * 32, kBwdBlkRowBlocksPerSm)
attn_bwd_q_blocked_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                          HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                          HeadRows<bf16> o_out, HeadRows<bf16> dq_out, float* __restrict__ stats,
                          int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kKeys = BwdBlk::kKeys, kSteps = BwdBlk::kTiles / 2;
  constexpr unsigned kSlot = static_cast<unsigned>(head_bytes<BwdBlk, HD>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (blockIdx.x * kBwdBlkWarps + warp) * 16;
  const bool active = q0 < L;  // a warp with no rows still stages and syncs
  const bool with_o = o_out.p != nullptr;
  const int blocks = (L + kKeys - 1) / kKeys, items = 3 * blocks;
  const bf16* k_head = k_rows.at(b, h);
  const bf16* v_head = v_rows.at(b, h);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // item i: pass i / blocks over key block i % blocks, into stage i % 2: its
  // K rows in the stage's first slot, in passes 2 and 3 its V rows in the second
  auto stage_item = [&](int i) {
    unsigned char* st = smem + (i % kBwdBlkStages) * 2 * kSlot;
    const int key0 = (i % blocks) * kKeys;
    stage_head_async<HD>(st, k_head + key0 * k_rows.row, k_rows.row, kKeys, L - key0,
                         threadIdx.x, blockDim.x);
    if (i >= blocks)
      stage_head_async<HD>(st + kSlot, v_head + key0 * v_rows.row, v_rows.row, kKeys, L - key0,
                           threadIdx.x, blockDim.x);
    cp_async_commit();
  };

  ARows<HD> qa, da;
  if (active) {
    load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, scale);  // qsc = bf16(q * scale)
    load_a_rows(da, do_rows.at(b, h), do_rows.row, q0, L, lane, 1.f);
  }
  const float neg_inf = __uint_as_float(0xff800000u);
  float m_lo = neg_inf, m_hi = neg_inf, sum_lo = 0.f, sum_hi = 0.f;
  float c_lo = 0.f, c_hi = 0.f, r_lo = 1.f, r_hi = 1.f;
  float acc[HD::kChunks][4];  // o in pass 2, dq in pass 3
  zero_tiles(acc);
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
    const unsigned k_stage = ring + (i % kBwdBlkStages) * 2 * kSlot, v_stage = k_stage + kSlot;
    if (active) {
      const RowsAt k_at = rows_at<HD>(k_stage, lane), v_at = rows_at<HD>(v_stage, lane);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        float s[2][4];
        row_col_pair<HD>(s, qa, k_at, 2 * kk);
        const int left = L - key0 - 16 * kk;
        if (left < 16) mask_keys(s, left, lane);
        if (pass == 0) {
          max_tiles(s, m_lo, m_hi);
          continue;
        }
        float none_lo = 0.f, none_hi = 0.f;  // pass 3 sums nothing
        if (pass == 1)
          exp_tiles(s, m_lo, m_hi, sum_lo, sum_hi);
        else
          exp_tiles(s, m_lo, m_hi, none_lo, none_hi);
        float dp[2][4];
        row_col_pair<HD>(dp, da, v_at, 2 * kk);
        unsigned a[4];
        if (pass == 1) {
          if (with_o) {  // o += bf16(e) v
            pack_a(a, s, 0);
            rows_product_step<HD>(acc, a, v_stage, at, kk);
          }
          dp_e_pair(dp, s, c_lo, c_hi);
        } else {  // dq += bf16(dsp) k
          dsp_pair(s, dp, c_lo, c_hi);
          pack_a(a, s, 0);
          rows_product_step<HD>(acc, a, k_stage, at, kk);
        }
      }
      if (i % blocks == blocks - 1) {  // a pass ends
        if (pass == 0) quad_max(m_lo, m_hi);
        if (pass == 1) {
          quad_sum(sum_lo, sum_hi);
          r_lo = 1.f / sum_lo;
          r_hi = 1.f / sum_hi;
          finish_c(c_lo, c_hi, r_lo, r_hi);
          if (with_o) store_tile<HD>(o_out.at(b, h), o_out.row, q0, L, lane, acc, r_lo, r_hi);
          zero_tiles(acc);
        }
        if (pass == 2) {
          store_tile<HD>(dq_out.at(b, h), dq_out.row, q0, L, lane, acc, r_lo * scale,
                         r_hi * scale);
          store_stats(stats, gridDim.z, H, L, b, h, q0, lane, m_lo, m_hi, r_lo, r_hi, c_lo, c_hi);
        }
      }
    }
    __syncthreads();  // every warp is done with stage i % 2 before item i + 2 lands there
  }
}

template <typename HD>
__global__ void __launch_bounds__(kBwdBlkWarps * 32, 1)
attn_bwd_kv_blocked_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                           HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                           const float* __restrict__ stats, HeadRows<bf16> dk_out,
                           HeadRows<bf16> dv_out, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRows = BwdBlk::kKeys, kThreads = kBwdBlkWarps * 32;
  constexpr int kChunks = kRows * HD::kChunks;
  constexpr int kJobs = (kChunks + kThreads - 1) / kThreads;  // chunks a thread stages
  constexpr unsigned kSlot = static_cast<unsigned>(head_bytes<BwdBlk, HD>());
  constexpr unsigned kStage = static_cast<unsigned>(attn_bwd_kv_blocked_stage<HD>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q_rows.at(b, h);
  const bf16* dob = do_rows.at(b, h);
  const size_t bhl = static_cast<size_t>(gridDim.z) * H * L;
  const float* st_b = stats + (static_cast<size_t>(b) * H + h) * L;
  const int blocks = (L + kRows - 1) / kRows;

  // query block blk's chunks and statistics into registers (zeros past L),
  // then into stage blk % 2
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 qv[kJobs], dov[kJobs];
  float rv[kJobs], mv = 0.f, cv = 0.f;
  auto fetch = [&](int blk) {
#pragma unroll
    for (int j = 0; j < kJobs; ++j) {
      const int c = threadIdx.x + j * kThreads;
      const int row = blk * kRows + c / HD::kChunks, ch = c % HD::kChunks;
      qv[j] = dov[j] = zero;
      rv[j] = 0.f;
      if (c < kChunks && row < L) {
        qv[j] = *reinterpret_cast<const uint4*>(qb + row * q_rows.row + ch * kVec);
        dov[j] = *reinterpret_cast<const uint4*>(dob + row * do_rows.row + ch * kVec);
        rv[j] = st_b[bhl + row];
      }
    }
    const int row = blk * kRows + threadIdx.x;
    if (threadIdx.x < kRows) {
      mv = row < L ? st_b[row] : 0.f;
      cv = row < L ? st_b[2 * bhl + row] : 0.f;
    }
  };
  auto put = [&](int blk) {
    unsigned char* st = smem + (blk % kBwdBlkStages) * kStage;
#pragma unroll
    for (int j = 0; j < kJobs; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < kChunks)
        stage_query_chunk<HD>(st, st + kSlot, st + 2 * kSlot, st + 3 * kSlot, c / HD::kChunks,
                              c % HD::kChunks, qv[j], dov[j], rv[j], scale);
    }
    if (threadIdx.x < kRows) {
      float* ms = reinterpret_cast<float*>(st + 4 * kSlot);
      ms[threadIdx.x] = mv;
      ms[kRows + threadIdx.x] = cv;
    }
  };

  const int key0 = (blockIdx.x * kBwdBlkWarps + warp) * 16;
  const bool active = key0 < L;  // a warp with no keys still stages and syncs
  const bool key_lo = key0 + g < L, key_hi = key0 + g + 8 < L;
  ARows<HD> ka, va;
  if (active) {
    load_a_rows(ka, k_rows.at(b, h), k_rows.row, key0, L, lane, 1.f);
    load_a_rows(va, v_rows.at(b, h), v_rows.row, key0, L, lane, 1.f);
  }
  float dk[HD::kChunks][4], dv[HD::kChunks][4];
  zero_tiles(dk);
  zero_tiles(dv);
  const TransAt t_at = trans_at<HD>(lane);
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  fetch(0);
  put(0);
  __syncthreads();
  for (int blk = 0; blk < blocks; ++blk) {
    if (blk + 1 < blocks) fetch(blk + 1);  // in flight while this block is multiplied
    if (active) {
      const unsigned base = ring + (blk % kBwdBlkStages) * kStage;
      const RowsAt qs_at = rows_at<HD>(base, lane), dos_at = rows_at<HD>(base + 2 * kSlot, lane);
      const float* m_s =
          reinterpret_cast<const float*>(smem + (blk % kBwdBlkStages) * kStage + 4 * kSlot);
#pragma unroll 1
      for (int qt = 0; qt < kRows / 16; ++qt)
        key_query_step<HD>(dk, dv, ka, va, qs_at, dos_at, base + kSlot, base + 3 * kSlot, t_at,
                           m_s, m_s + kRows, qt, blk * kRows, L, key_lo, key_hi, tg);
    }
    // stage (blk + 1) % 2 was last read in step blk - 1, which every warp has left
    if (blk + 1 < blocks) put(blk + 1);
    __syncthreads();
  }
  if (active) {
    store_tile<HD>(dk_out.at(b, h), dk_out.row, key0, L, lane, dk, 1.f, 1.f);
    store_tile<HD>(dv_out.at(b, h), dv_out.row, key0, L, lane, dv, 1.f, 1.f);
  }
}

// Warps a block of the row launch (key false) or of the key launch (key
// true) at sequence length L, dynamic shared memory a block at L and head
// width Dh, and the blocks one SM holds, as the runtime reckons them (0 on
// an error or a length or width the core does not take).
inline int attn_bwd_core_warps(int L, bool key) {
  if (L > kMaxSeq) return kBwdBlkWarps;
  return key ? kBwdKeyWarps : kBwdRowWarps;
}

inline int attn_bwd_core_smem_bytes(int L, bool key, int Dh) {
  if (L < 1 || L > kMaxSeqBlocked) return 0;
  return with_head_dim(Dh, 0, [&](auto hd) {
    using HD = decltype(hd);
    if (L > kMaxSeq)
      return static_cast<int>(key ? attn_bwd_kv_blocked_smem<HD>() : attn_bwd_q_blocked_smem<HD>());
    if (key) return static_cast<int>(attn_bwd_kv_smem_bytes<HD>(L));
    return with_seq_class(L, [](auto seq) {
      return static_cast<int>(2 * head_bytes<decltype(seq), HD>());
    });
  });
}

inline int attn_bwd_core_blocks_per_sm(int L, bool key, int Dh) {
  const size_t smem = attn_bwd_core_smem_bytes(L, key, Dh);
  if (smem == 0) return 0;
  const int threads = attn_bwd_core_warps(L, key) * 32;
  return with_head_dim(Dh, 0, [&](auto hd) {
    using HD = decltype(hd);
    if (L > kMaxSeq)
      return key ? resident_blocks(attn_bwd_kv_blocked_kernel<HD>, threads, smem)
                 : resident_blocks(attn_bwd_q_blocked_kernel<HD>, threads, smem);
    if (key) return resident_blocks(attn_bwd_kv_kernel<HD>, threads, smem);
    return with_seq_class(L, [&](auto seq) {
      return resident_blocks(attn_bwd_q_kernel<decltype(seq), HD>, threads, smem);
    });
  });
}

template <typename HD>
cudaError_t launch_attn_bwd_core_blocked(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                         HeadRows<const bf16> v, HeadRows<const bf16> dout,
                                         HeadRows<bf16> o_out, HeadRows<bf16> dq,
                                         HeadRows<bf16> dk, HeadRows<bf16> dv, float* stats,
                                         int B, int L, int H, float scale, cudaStream_t stream) {
  // one block a group of kBwdBlkWarps 16-row tiles (query rows, then keys):
  // each block streams the other side of the head anyway
  const dim3 grid((L + 16 * kBwdBlkWarps - 1) / (16 * kBwdBlkWarps), H, B);
  constexpr size_t smem_q = attn_bwd_q_blocked_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_blocked_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  attn_bwd_q_blocked_kernel<HD><<<grid, kBwdBlkWarps * 32, smem_q, stream>>>(
      q, k, v, dout, o_out, dq, stats, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem_kv = attn_bwd_kv_blocked_smem<HD>();
  err = cudaFuncSetAttribute(attn_bwd_kv_blocked_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  attn_bwd_kv_blocked_kernel<HD><<<grid, kBwdBlkWarps * 32, smem_kv, stream>>>(
      q, k, v, dout, stats, dk, dv, L, H, scale);
  return cudaGetLastError();
}

// dq, dk, dv (and the forward output o_out unless its p is null) from q, k,
// v and dout at head width Dh (64 or 72) and 1 <= L <= kMaxSeqBlocked, in the
// form `form` (CoreForm: by L, or one forced, the register form only up to
// kMaxSeq); anything else is refused. stats is scratch of 3 * B * H * L
// floats.
inline cudaError_t launch_attn_bwd_core(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                        HeadRows<const bf16> v, HeadRows<const bf16> dout,
                                        HeadRows<bf16> o_out, HeadRows<bf16> dq,
                                        HeadRows<bf16> dk, HeadRows<bf16> dv, float* stats, int B,
                                        int L, int H, int Dh, float scale, cudaStream_t stream,
                                        int form = kCoreAuto) {
  if (L < 1 || L > kMaxSeqBlocked || (form == kCoreRegisters && L > kMaxSeq))
    return cudaErrorInvalidValue;
  return with_head_dim(Dh, cudaErrorInvalidValue, [&](auto hd) {
    using HD = decltype(hd);
    if (blocked_form(L, form))
      return launch_attn_bwd_core_blocked<HD>(q, k, v, dout, o_out, dq, dk, dv, stats, B, L, H,
                                              scale, stream);
    cudaError_t err = with_seq_class(L, [&](auto seq) {
      using Seq = decltype(seq);
      constexpr size_t smem = 2 * head_bytes<Seq, HD>();
      cudaError_t e = cudaFuncSetAttribute(attn_bwd_q_kernel<Seq, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      const dim3 grid(head_splits(B * H, L, kBwdRowWarps, 2 * kSmCount * kBwdRowBlocksPerSm), H,
                      B);
      attn_bwd_q_kernel<Seq, HD><<<grid, kBwdRowWarps * 32, smem, stream>>>(
          q, k, v, dout, o_out, dq, stats, L, H, scale);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    const size_t smem_kv = attn_bwd_kv_smem_bytes<HD>(L);
    err = cudaFuncSetAttribute(attn_bwd_kv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    // one block a head (and an SM) when there is a head for every SM
    const dim3 grid_kv(head_splits(B * H, L, kBwdKeyWarps, kSmCount), H, B);
    attn_bwd_kv_kernel<HD><<<grid_kv, kBwdKeyWarps * 32, smem_kv, stream>>>(
        q, k, v, dout, stats, dk, dv, L, H, scale);
    return cudaGetLastError();
  });
}

// The core on a packed (B, L, 3A) qkv and dm (B, L, A), A = H * Dh: merged
// heads, and dq, dk, dv into the packed dqkv.
inline cudaError_t launch_attn_bwd_core(const bf16* qkv, const bf16* dm, bf16* merged,
                                        bf16* dqkv, float* stats, int B, int L, int H, int Dh,
                                        float scale, cudaStream_t stream) {
  return launch_attn_bwd_core(
      packed_third(qkv, 0, L, H, Dh), packed_third(qkv, 1, L, H, Dh),
      packed_third(qkv, 2, L, H, Dh), merged_heads(dm, L, H, Dh), merged_heads(merged, L, H, Dh),
      packed_third(dqkv, 0, L, H, Dh), packed_third(dqkv, 1, L, H, Dh),
      packed_third(dqkv, 2, L, H, Dh), stats, B, L, H, Dh, scale, stream);
}

}  // namespace
}  // namespace duodiff
