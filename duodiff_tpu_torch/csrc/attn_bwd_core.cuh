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
// Determinism: every sum runs in a fixed order inside one warp; no atomics.
// L = 257 or 258 is ragged: keys past L are masked (e = 0), query rows past
// L are zeros with e = 0 in the key launch, so they add nothing to dk and
// dv; rows past L are never written.
#pragma once

#include "attn_tiles.cuh"
#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kBwdDh = kHeadDim;       // head width the core takes
constexpr int kBwdRowWarps = 4;        // 16 query rows each, per trip
constexpr int kBwdRowBlocksPerSm = 2;  // what the row launch's register cap is set for
constexpr int kBwdKeyWarps = 9;        // 16 keys each, per trip

// Dynamic shared memory of attn_bwd_kv_kernel at sequence length L: four
// staged heads and the statistics m and c.
__host__ __device__ inline size_t attn_bwd_kv_smem_bytes(int L) {
  const size_t lpad = (L + 15) / 16 * 16;
  return 4 * lpad * kHeadRowBytes + 2 * lpad * sizeof(float);
}

// Row statistics, the forward output o (unless o.p is null) and dq.
// stats: m, r, c, each (B, H, L). Seq is the SeqClass of L (attn_tiles.cuh).
template <typename Seq>
__global__ void __launch_bounds__(kBwdRowWarps * 32, kBwdRowBlocksPerSm)
attn_bwd_q_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                  HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                  HeadRows<bf16> o_out, HeadRows<bf16> dq_out,
                  float* __restrict__ stats, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTiles = Seq::kTiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Seq::kHeadBytes;
  const unsigned k_stage = static_cast<unsigned>(__cvta_generic_to_shared(Ks));
  const unsigned v_stage = static_cast<unsigned>(__cvta_generic_to_shared(Vs));

  const int b = blockIdx.z, h = blockIdx.y;
  stage_head_async(Ks, k_rows.at(b, h), k_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();
  stage_head_async(Vs, v_rows.at(b, h), v_rows.row, Seq::kKeys, L, threadIdx.x, blockDim.x);
  cp_async_commit();

  const unsigned v_off0 = v_stage + rows_offset(lane, 0), v_off1 = v_stage + rows_offset(lane, 4);
  const unsigned toff = trans_offset(lane, 0);
  // every warp makes the same number of trips (the barriers of the first)
  const int tiles = (L + 15) / 16, per_trip = gridDim.x * kBwdRowWarps;
  const int trips = (tiles + per_trip - 1) / per_trip;
  for (int trip = 0; trip < trips; ++trip) {
    const int q0 = ((trip * gridDim.x + blockIdx.x) * kBwdRowWarps + warp) * 16;
    const bool active = q0 < L;
    unsigned qa[4][4], da[4][4];
    float e[kTiles][4];
    if (active) {
      load_a_rows(qa, q_rows.at(b, h), q_rows.row, q0, L, lane, scale);  // qsc = bf16(q * scale)
      load_a_rows(da, do_rows.at(b, h), do_rows.row, q0, L, lane, 1.f);
    }
    if (trip == 0) {
      cp_async_wait<1>();  // K has landed, V is still in flight
      __syncthreads();
    }
    if (active) score_tiles<kTiles>(e, qa, k_stage, lane);
    if (trip == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    float m_lo, m_hi, sum_lo, sum_hi;
    softmax_rows<kTiles, Seq::kMaskFrom>(e, L, lane, m_lo, m_hi, sum_lo, sum_hi);
    const float r_lo = 1.f / sum_lo, r_hi = 1.f / sum_hi;

    if (o_out.p != nullptr) {  // the forward output bf16((bf16(e) v) * r), which K6 needs
      float o[8][4];
      value_tiles<kTiles>(o, e, v_stage, lane);
      store_tile64(o_out.at(b, h), o_out.row, q0, L, lane, o, r_lo, r_hi);
    }

    // c = rowsum(dp * e) * r with dp = do v^T, 16 keys at a time
    float c_lo = 0.f, c_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; nt += 2) {
      float dp[2][4];
      row_col_pair(dp, da, v_off0, v_off1, nt);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        c_lo += dp[t][0] * e[nt + t][0] + dp[t][1] * e[nt + t][1];
        c_hi += dp[t][2] * e[nt + t][2] + dp[t][3] * e[nt + t][3];
      }
    }
    c_lo += __shfl_xor_sync(0xffffffffu, c_lo, 1);
    c_lo += __shfl_xor_sync(0xffffffffu, c_lo, 2);
    c_hi += __shfl_xor_sync(0xffffffffu, c_hi, 1);
    c_hi += __shfl_xor_sync(0xffffffffu, c_hi, 2);
    c_lo *= r_lo;
    c_hi *= r_hi;

    // dsp = bf16(e * (dp - c)), 16 keys at a time, in place of e, and
    // dq += dsp k
    float dq[8][4];
    zero_tile64(dq);
#pragma unroll
    for (int kk = 0; kk < kTiles / 2; ++kk) {
      float dp[2][4];
      row_col_pair(dp, da, v_off0, v_off1, 2 * kk);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float(&et)[4] = e[2 * kk + t];
        et[0] *= dp[t][0] - c_lo;
        et[1] *= dp[t][1] - c_lo;
        et[2] *= dp[t][2] - c_hi;
        et[3] *= dp[t][3] - c_hi;
      }
      unsigned a[4];
      pack_a(a, e, kk);
      rows_product_step(dq, a, k_stage, toff, kk);
    }
    store_tile64(dq_out.at(b, h), dq_out.row, q0, L, lane, dq, r_lo * scale, r_hi * scale);

    if (tg == 0) {
      const size_t bhl = static_cast<size_t>(gridDim.z) * H * L;
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
  }
}

// dk and dv of 16 keys a warp, summed over every query row.
__global__ void __launch_bounds__(kBwdKeyWarps * 32, 1)
attn_bwd_kv_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                   HeadRows<const bf16> v_rows, HeadRows<const bf16> do_rows,
                   const float* __restrict__ stats,
                   HeadRows<bf16> dk_out, HeadRows<bf16> dv_out, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lpad = (L + 15) / 16 * 16;
  const size_t head_bytes = static_cast<size_t>(lpad) * kHeadRowBytes;
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
  for (int c = threadIdx.x; c < lpad * 8; c += blockDim.x) {
    const int row = c >> 3, ch = c & 7;
    uint4 qv = zero, dov = zero;
    float r = 0.f;
    if (row < L) {
      qv = *reinterpret_cast<const uint4*>(qb + row * q_rows.row + ch * kVec);
      dov = *reinterpret_cast<const uint4*>(dob + row * do_rows.row + ch * kVec);
      r = st_b[bhl + row];
    }
    const unsigned at = staged_byte(row, ch);
    const uint4 qsc = scale8(qv, scale);
    *reinterpret_cast<uint4*>(QS + at) = qsc;
    *reinterpret_cast<uint4*>(QR + at) = scale8(qsc, r);
    *reinterpret_cast<uint4*>(DOS + at) = dov;
    *reinterpret_cast<uint4*>(DOR + at) = scale8(dov, r);
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
  const unsigned roff0 = rows_offset(lane, 0), roff1 = rows_offset(lane, 4);
  const unsigned toff = trans_offset(lane, 0);

  for (int kt = blockIdx.x * kBwdKeyWarps + warp; kt * 16 < L; kt += gridDim.x * kBwdKeyWarps) {
    const int key0 = kt * 16;
    unsigned ka[4][4], va[4][4];
    load_a_rows(ka, k_rows.at(b, h), k_rows.row, key0, L, lane, 1.f);
    load_a_rows(va, v_rows.at(b, h), v_rows.row, key0, L, lane, 1.f);
    const bool key_lo = key0 + g < L, key_hi = key0 + g + 8 < L;
    float dk[8][4], dv[8][4];
    zero_tile64(dk);
    zero_tile64(dv);
#pragma unroll 1
    for (int qt = 0; qt * 16 < lpad; ++qt) {
      // e^T and dsp^T of (16 keys x 16 queries), packed as A operands
      unsigned ea[4], dsa[4];
      float st2[2][4], dpt2[2][4];
      row_col_pair(st2, ka, qs_base + roff0, qs_base + roff1, 2 * qt);
      row_col_pair(dpt2, va, dos_base + roff0, dos_base + roff1, 2 * qt);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float(&st)[4] = st2[j], (&dpt)[4] = dpt2[j];
        const int q = qt * 16 + j * 8 + tg * 2;
        const float2 m2 = *reinterpret_cast<const float2*>(m_s + q);
        const float2 c2 = *reinterpret_cast<const float2*>(c_s + q);
        const bool q_a = q < L, q_b = q + 1 < L;
        const float e0 = key_lo && q_a ? exp_nonpos(st[0] - m2.x) : 0.f;
        const float e1 = key_lo && q_b ? exp_nonpos(st[1] - m2.y) : 0.f;
        const float e2 = key_hi && q_a ? exp_nonpos(st[2] - m2.x) : 0.f;
        const float e3 = key_hi && q_b ? exp_nonpos(st[3] - m2.y) : 0.f;
        ea[2 * j] = pack_bf16x2(e0, e1);
        ea[2 * j + 1] = pack_bf16x2(e2, e3);
        dsa[2 * j] = pack_bf16x2(e0 * (dpt[0] - c2.x), e1 * (dpt[1] - c2.y));
        dsa[2 * j + 1] = pack_bf16x2(e2 * (dpt[2] - c2.x), e3 * (dpt[3] - c2.y));
      }
      // dv += bf16(e)^T bf16(do * r), dk += dsp^T bf16(qsc * r): the queries
      // are the reduction, so the staged rows are read transposed
      rows_product_step(dv, ea, dor_base, toff, qt);
      rows_product_step(dk, dsa, qr_base, toff, qt);
    }
    store_tile64(dk_out.at(b, h), dk_out.row, key0, L, lane, dk, 1.f, 1.f);
    store_tile64(dv_out.at(b, h), dv_out.row, key0, L, lane, dv, 1.f, 1.f);
  }
}

// Dynamic shared memory of a block of the row launch (key false: K and V of
// the head) or of the key launch (key true) at sequence length L, and the
// blocks of it that one SM holds, as the runtime reckons them (0 on an
// error).
inline int attn_bwd_core_smem_bytes(int L, bool key) {
  if (key) return static_cast<int>(attn_bwd_kv_smem_bytes(L));
  return with_seq_class(L, [](auto seq) {
    return static_cast<int>(2 * decltype(seq)::kHeadBytes);
  });
}

inline int attn_bwd_core_blocks_per_sm(int L, bool key) {
  const size_t smem = attn_bwd_core_smem_bytes(L, key);
  int blocks = 0;
  if (key) {
    if (cudaFuncSetAttribute(attn_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_bwd_kv_kernel,
                                                      kBwdKeyWarps * 32, smem) != cudaSuccess)
      return 0;
    return blocks;
  }
  return with_seq_class(L, [&](auto seq) {
    using Seq = decltype(seq);
    if (cudaFuncSetAttribute(attn_bwd_q_kernel<Seq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_bwd_q_kernel<Seq>,
                                                      kBwdRowWarps * 32, smem) != cudaSuccess)
      return 0;
    return blocks;
  });
}

// dq, dk, dv (and the forward output o_out unless its p is null) from q, k,
// v and dout; stats is scratch of 3 * B * H * L floats.
inline cudaError_t launch_attn_bwd_core(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                        HeadRows<const bf16> v, HeadRows<const bf16> dout,
                                        HeadRows<bf16> o_out, HeadRows<bf16> dq,
                                        HeadRows<bf16> dk, HeadRows<bf16> dv, float* stats, int B,
                                        int L, int H, float scale, cudaStream_t stream) {
  if (L < 1 || L > kMaxSeq) return cudaErrorInvalidValue;
  cudaError_t err = with_seq_class(L, [&](auto seq) {
    using Seq = decltype(seq);
    constexpr size_t smem = 2 * Seq::kHeadBytes;
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_q_kernel<Seq>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(head_splits(B * H, L, kBwdRowWarps, 2 * kSmCount * kBwdRowBlocksPerSm), H,
                    B);
    attn_bwd_q_kernel<Seq><<<grid, kBwdRowWarps * 32, smem, stream>>>(q, k, v, dout, o_out, dq,
                                                                      stats, L, H, scale);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const size_t smem_kv = attn_bwd_kv_smem_bytes(L);
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  // one block a head (and an SM) when there is a head for every SM
  const dim3 grid_kv(head_splits(B * H, L, kBwdKeyWarps, kSmCount), H, B);
  attn_bwd_kv_kernel<<<grid_kv, kBwdKeyWarps * 32, smem_kv, stream>>>(q, k, v, dout, stats, dk,
                                                                      dv, L, H, scale);
  return cudaGetLastError();
}

// The core on a packed (B, L, 3A) qkv and dm (B, L, A): merged heads, and
// dq, dk, dv into the packed dqkv.
inline cudaError_t launch_attn_bwd_core(const bf16* qkv, const bf16* dm, bf16* merged,
                                        bf16* dqkv, float* stats, int B, int L, int H,
                                        float scale, cudaStream_t stream) {
  constexpr int Dh = kBwdDh;
  return launch_attn_bwd_core(
      packed_third(qkv, 0, L, H, Dh), packed_third(qkv, 1, L, H, Dh),
      packed_third(qkv, 2, L, H, Dh), merged_heads(dm, L, H, Dh), merged_heads(merged, L, H, Dh),
      packed_third(dqkv, 0, L, H, Dh), packed_third(dqkv, 1, L, H, Dh),
      packed_third(dqkv, 2, L, H, Dh), stats, B, L, H, scale, stream);
}

}  // namespace
}  // namespace duodiff
