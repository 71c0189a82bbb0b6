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
// One block per (query tile of 64 rows, head, sample):
//   - K and V rows of the head (L x 64 bf16 each, 33 KB at L = 257) are
//     staged once in shared memory and shared by 4 warps of 16 query rows;
//   - q, k and v rows come through their views (column slices of qkv, or
//     separate tensors);
//   - s = q k^T in fp32 (WMMA), key columns past L masked to -inf before
//     the row max, e = exp(s - m), denom = fp32 sum of the unrounded e;
//   - e rounded to bf16 for e v (fp32 accumulation), then divided by denom;
//   - the head's output goes to its rows of the output view, in bf16.
// Bound: the core does 4*L*L*Dh flops per (sample, head) against
// 8*L*Dh bytes of bf16 q, k, v and output (L/2, ~128 flop/byte at
// L = 257, under the card's ~295 balance point), and it keeps each warp's
// full (16 x L) fp32 score rows in shared memory (194 KB per block at
// L = 257), so one block fits an SM: it is bound by latency and
// occupancy, not by bandwidth. Design: simple and exact first (two passes
// over stored scores keep the TPU kernel's rounding points: an exact row
// max, one bf16 rounding of e); a register-resident online softmax is
// later work.
// kNormFirst is the per-head attention sublayer's form (K1-v1, the Pallas
// _kernel :79-86): q comes unscaled, the fp32 scores are multiplied by
// `scale`, and p = e / sum is rounded to bf16 BEFORE the value product, so
// nothing is divided afterwards. It is a template argument: the default
// form's code does not change.
// L = 257 or 258 is no multiple of 16: K/V/q rows past L are zero-filled,
// scores past L masked, and output rows past L never written.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace duodiff {
namespace {

using namespace nvcuda;

constexpr int kDh = 64;                  // head width the core takes
constexpr int kAttnWarps = 4;            // 16 query rows each
constexpr int kQRows = 16 * kAttnWarps;  // query rows per block
constexpr int kKvPitch = kDh + 8;        // bf16 per staged K/V/q row
constexpr int kOPitch = kDh + 4;         // fp32 per output-tile row

struct AttnSmem {
  int lpad;          // L rounded up to 16
  int s_pitch;       // fp32 per score row (the output tile reuses it)
  int p_pitch;       // bf16 per probability row
  size_t kv_bytes;   // K (or V) stage
  size_t q_bytes;    // per warp
  size_t s_bytes;    // per warp
  size_t p_bytes;    // per warp
  size_t total;
};

__host__ __device__ inline AttnSmem attn_smem(int L) {
  AttnSmem m;
  m.lpad = (L + 15) / 16 * 16;
  m.s_pitch = (m.lpad > kDh ? m.lpad : kDh) + 4;
  m.p_pitch = m.lpad + 8;
  m.kv_bytes = static_cast<size_t>(m.lpad) * kKvPitch * sizeof(bf16);
  m.q_bytes = 16 * kKvPitch * sizeof(bf16);
  m.s_bytes = static_cast<size_t>(16) * m.s_pitch * sizeof(float);
  m.p_bytes = static_cast<size_t>(16) * m.p_pitch * sizeof(bf16);
  m.total = 2 * m.kv_bytes + kAttnWarps * (m.q_bytes + m.s_bytes + m.p_bytes);
  return m;
}

// scale: q is multiplied by it and rounded to bf16 (1: q comes pre-scaled);
// with kNormFirst q stays as it is and the fp32 scores are multiplied by it.
template <bool kNormFirst>
__global__ void __launch_bounds__(kAttnWarps * 32)
attn_core_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                 HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float denom_s[kAttnWarps][16];
  const AttnSmem sm = attn_smem(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + sm.kv_bytes);
  unsigned char* mine = smem + 2 * sm.kv_bytes + warp * (sm.q_bytes + sm.s_bytes + sm.p_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(mine);
  float* Ss = reinterpret_cast<float*>(mine + sm.q_bytes);
  bf16* Ps = reinterpret_cast<bf16*>(mine + sm.q_bytes + sm.s_bytes);

  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q_rows.at(b, h);
  const bf16* kb = k_rows.at(b, h);
  const bf16* vb = v_rows.at(b, h);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = threadIdx.x; c < sm.lpad * (kDh / kVec); c += blockDim.x) {
    const int j = c / (kDh / kVec), col = (c % (kDh / kVec)) * kVec;
    uint4 kv = zero, vv = zero;
    if (j < L) {
      kv = *reinterpret_cast<const uint4*>(kb + j * k_rows.row + col);
      vv = *reinterpret_cast<const uint4*>(vb + j * v_rows.row + col);
    }
    *reinterpret_cast<uint4*>(Ks + j * kKvPitch + col) = kv;
    *reinterpret_cast<uint4*>(Vs + j * kKvPitch + col) = vv;
  }
  const int q0 = blockIdx.x * kQRows + warp * 16;
  for (int c = lane; c < 16 * (kDh / kVec); c += 32) {
    const int r = c / (kDh / kVec), col = (c % (kDh / kVec)) * kVec;
    uint4 qv = zero;
    if (q0 + r < L) {
      qv = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_rows.row + col);
      if (!kNormFirst && scale != 1.f) qv = scale8(qv, scale);  // bf16(q * scale), K9's rounding
    }
    *reinterpret_cast<uint4*>(Qs + r * kKvPitch + col) = qv;
  }
  __syncthreads();  // the only block-wide barrier: warps are independent below
  if (q0 >= L) return;

  // scores s = q k^T, (16 x lpad) fp32
  const int ntiles = sm.lpad / 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, kKvPitch);
  for (int nt = 0; nt < ntiles; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      // k^T as a column-major (Dh x 16) operand: element (k, n) = K[n][k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + nt * 16 * kKvPitch + kk * 16, kKvPitch);
      wmma::mma_sync(s, qa[kk], kf, s);
    }
    wmma::store_matrix_sync(Ss + nt * 16, s, sm.s_pitch, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax numerator in bf16, denominator in fp32 (normalised after e v)
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int r = 0; r < 16; ++r) {
    float* srow = Ss + r * sm.s_pitch;
    bf16* prow = Ps + r * sm.p_pitch;
    float m = neg_inf;
    if (kNormFirst) {
      // p = softmax(s * scale) in fp32, one rounding to bf16 after the
      // division; each lane owns the same columns in all three passes
      for (int j = lane; j < sm.lpad; j += 32) m = fmaxf(m, j < L ? srow[j] * scale : neg_inf);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < sm.lpad; j += 32) {
        const float e = j < L ? expf(srow[j] * scale - m) : 0.f;
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < sm.lpad; j += 32) prow[j] = __float2bfloat16(srow[j] / sum);
      continue;
    }
    for (int j = lane; j < sm.lpad; j += 32) m = fmaxf(m, j < L ? srow[j] : neg_inf);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < sm.lpad; j += 32) {
      const float e = expf((j < L ? srow[j] : neg_inf) - m);
      sum += e;
      prow[j] = __float2bfloat16(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) denom_s[warp][r] = sum;
  }
  __syncwarp();

  // o = e v, (16 x 64) fp32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kDh / 16];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  for (int kt = 0; kt < ntiles; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, Ps + kt * 16, sm.p_pitch);
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, Vs + kt * 16 * kKvPitch + n * 16, kKvPitch);
      wmma::mma_sync(o[n], pa, vf, o[n]);
    }
  }
  float* Os = Ss;  // the scores are consumed
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n)
    wmma::store_matrix_sync(Os + n * 16, o[n], kOPitch, wmma::mem_row_major);
  __syncwarp();

  // each lane writes 32 columns of one row: o / denom, rounded to bf16
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  if (q0 + r < L) {
    const float den = kNormFirst ? 1.f : denom_s[warp][r];
    bf16* dst = out.at(b, h) + (q0 + r) * out.row + c0;
#pragma unroll
    for (int c = 0; c < 32; c += kVec) {
      float v[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[e] = Os[r * kOPitch + c0 + c + e];
        if (!kNormFirst) v[e] /= den;
      }
      *reinterpret_cast<uint4*>(dst + c) = pack8(v);
    }
  }
}

template <bool kNormFirst>
cudaError_t launch_attn_core_form(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                  HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L, int H,
                                  float scale, cudaStream_t stream) {
  const size_t smem = attn_smem(L).total;
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<kNormFirst>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kQRows - 1) / kQRows, H, B);
  attn_core_kernel<kNormFirst><<<grid, kAttnWarps * 32, smem, stream>>>(q, k, v, out, L, scale);
  return cudaGetLastError();
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
