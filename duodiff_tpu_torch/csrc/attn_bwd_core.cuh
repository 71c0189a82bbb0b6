// The attention core of K6: the backward of softmax(q k^T * scale) v per
// (sample, head) on the packed (B, L, 3A) bf16 qkv (unscaled q), with the
// merged-head gradient dm = dy Wp^T (B, L, A) bf16 as the incoming do.
//
// Replaces: the per-head loop of duodiff_tpu/ops/pallas_block.py
// _attn_bwd_kernel (:289-341). With e = exp(s - m) and r = 1 / rowsum(e):
//   qsc = bf16(q * scale), s = qsc k^T (fp32);
//   o   = bf16((bf16(e) v) * r)                      -> merged heads
//   dv  = bf16(bf16(e)^T bf16(do * r))
//   dp  = do v^T, c = rowsum(dp * e) * r, dsp = bf16(e * (dp - c))
//   dq  = bf16((dsp k) * (r * scale)), dk = bf16(dsp^T bf16(qsc * r))
// every rounding at the Pallas kernel's own point.
//
// The Pallas kernel holds a whole (L, L) head in VMEM. Here the rows and
// the columns of that matrix are reduced by different blocks, and nothing
// is carried from one block to another, so the core is two launches:
//   - attn_bwd_q_kernel, one block per (64 query rows, head, sample), the
//     forward core's layout (K and V of the head staged once, whole 16 x L
//     score rows per warp in shared memory): the row statistics m, r and c,
//     the merged output o, and dq (a sum over keys, inside the row);
//   - attn_bwd_kv_kernel, one block per (64 keys, head, sample): it walks
//     all query tiles, recomputes s and dp for its keys with the same WMMA
//     tiles (the same bits as the first launch), takes e and dsp from the
//     stored m, r and c, and sums dk and dv over the queries in registers.
// Bound: latency and occupancy, as the forward core: 4 * L^2 * Dh flops
// per (sample, head) for the first launch and 8 * L^2 * Dh for the second,
// on mma.sync tiles fed from shared memory; the first launch keeps two
// fp32 16 x L row blocks per warp (220 KB at L = 257, one block per SM).
// Determinism: every sum runs in a fixed order inside one warp; no atomics.
// L = 257 is ragged: keys past L are masked (e = 0), and query rows past L
// are zero in the staged q and do, with zero statistics, so they add
// nothing to dk and dv; their outputs are never written.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace duodiff {
namespace {

using namespace nvcuda;

constexpr int kBwdDh = 64;                // head width the core takes
constexpr int kBwdWarps = 4;              // 16 query rows (or keys) each
constexpr int kBwdRows = 16 * kBwdWarps;  // query rows (or keys) per block
constexpr int kBwdPitch = kBwdDh + 8;     // bf16 per staged q/k/v/do row
constexpr int kBwdOPitch = kBwdDh + 4;    // fp32 per output-tile row

// Dynamic shared memory of attn_bwd_q_kernel at sequence length L.
struct AttnBwdQSmem {
  int lpad;         // L rounded up to 16
  int s_pitch;      // fp32 per score / e row
  int p_pitch;      // bf16 per e / dsp row
  size_t kv_bytes;  // K (or V) stage
  size_t row_bytes; // a warp's 16 staged q (or do) rows
  size_t s_bytes, p_bytes, o_bytes, stat_bytes, per_warp, total;
};

__host__ __device__ inline AttnBwdQSmem attn_bwd_q_smem(int L) {
  AttnBwdQSmem m;
  m.lpad = (L + 15) / 16 * 16;
  m.s_pitch = m.lpad + 4;
  m.p_pitch = m.lpad + 8;
  m.kv_bytes = static_cast<size_t>(m.lpad) * kBwdPitch * sizeof(bf16);
  m.row_bytes = 16 * kBwdPitch * sizeof(bf16);
  m.s_bytes = static_cast<size_t>(16) * m.s_pitch * sizeof(float);
  m.p_bytes = static_cast<size_t>(16) * m.p_pitch * sizeof(bf16);
  m.o_bytes = 16 * kBwdOPitch * sizeof(float);
  m.stat_bytes = 256;  // m, r, c of 16 rows, padded
  m.per_warp = 2 * m.row_bytes + m.s_bytes + m.p_bytes + m.o_bytes + m.stat_bytes;
  m.total = 2 * m.kv_bytes + kBwdWarps * m.per_warp;
  return m;
}

// Dynamic shared memory of attn_bwd_kv_kernel (independent of L).
constexpr size_t kKvStageBytes = kBwdRows * kBwdPitch * sizeof(bf16);
constexpr size_t kKvWarpBytes = 2 * 256 * sizeof(float) + 2 * 256 * sizeof(bf16);
constexpr size_t kKvSmemBytes =
    6 * kKvStageBytes + 3 * kBwdRows * sizeof(float) + kBwdWarps * kKvWarpBytes;
static_assert(kBwdWarps * 16 * kBwdOPitch * sizeof(float) <= 4 * kKvStageBytes,
              "the dk/dv output tiles reuse the query stage");

// Stage rows [row0, row0 + n) of column block col of a row-major bf16
// matrix with row stride `stride` into dst (pitch kBwdPitch), rows past L
// as zeros; each thread of `threads` copies 16 bytes at a time.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride, int col,
                                           int row0, int n, int L, int tid, int threads) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < n * (kBwdDh / kVec); c += threads) {
    const int r = c / (kBwdDh / kVec), k = (c % (kBwdDh / kVec)) * kVec;
    uint4 v = zero;
    if (row0 + r < L) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + col + k);
    *reinterpret_cast<uint4*>(dst + r * kBwdPitch + k) = v;
  }
}

__device__ __forceinline__ uint4 scale8(const uint4& raw, float s) {
  float v[kVec];
  unpack8(raw, v);
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] *= s;
  return pack8(v);
}

// Writes the 16 x 64 fp32 tile os (pitch kBwdOPitch) times mul(row), as
// bf16, to rows row0.. (< L) of dst with row stride `stride`; each lane
// writes 32 columns of one row.
template <typename Mul>
__device__ __forceinline__ void store_tile(const float* os, bf16* dst, size_t stride, int row0,
                                           int L, int lane, Mul mul) {
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  if (row0 + r >= L) return;
  const float s = mul(r);
  bf16* out = dst + static_cast<size_t>(row0 + r) * stride + c0;
#pragma unroll
  for (int c = 0; c < 32; c += kVec) {
    float v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = os[r * kBwdOPitch + c0 + c + e] * s;
    *reinterpret_cast<uint4*>(out + c) = pack8(v);
  }
}

using BwdFragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BwdFragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using BwdFragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using BwdFragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using BwdAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The 16 x 16 product rows(16 x 64) cols(16 x 64)^T of two staged tiles:
// the score (or dp) tile of 16 query rows and 16 keys. Both launches form
// these tiles the same way, so they agree to the bit.
__device__ __forceinline__ void row_col_tile(BwdAcc& acc, const bf16* rows, const bf16* cols) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < kBwdDh / 16; ++kk) {
    BwdFragA a;
    BwdFragBT b;
    wmma::load_matrix_sync(a, rows + kk * 16, kBwdPitch);
    wmma::load_matrix_sync(b, cols + kk * 16, kBwdPitch);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// Row statistics, merged output and dq. stats: m, r, c, each (B, H, L).
__global__ void __launch_bounds__(kBwdWarps * 32)
attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dm,
                  bf16* __restrict__ merged, bf16* __restrict__ dqkv, float* __restrict__ stats,
                  int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdQSmem sm = attn_bwd_q_smem(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + sm.kv_bytes);
  unsigned char* mine = smem + 2 * sm.kv_bytes + warp * sm.per_warp;
  bf16* Qs = reinterpret_cast<bf16*>(mine);
  bf16* DOs = reinterpret_cast<bf16*>(mine + sm.row_bytes);
  float* Ss = reinterpret_cast<float*>(mine + 2 * sm.row_bytes);
  bf16* Ps = reinterpret_cast<bf16*>(mine + 2 * sm.row_bytes + sm.s_bytes);
  float* Os = reinterpret_cast<float*>(mine + 2 * sm.row_bytes + sm.s_bytes + sm.p_bytes);
  float* stat = reinterpret_cast<float*>(mine + 2 * sm.row_bytes + sm.s_bytes + sm.p_bytes +
                                         sm.o_bytes);
  float* m_s = stat;
  float* r_s = stat + 16;
  float* c_s = stat + 32;

  const int b = blockIdx.z, h = blockIdx.y;
  const int A = H * kBwdDh;
  const size_t qkv_stride = 3 * static_cast<size_t>(A);
  const bf16* base = qkv + static_cast<size_t>(b) * L * qkv_stride;
  const bf16* dmb = dm + static_cast<size_t>(b) * L * A;
  stage_rows(Ks, base, qkv_stride, A + h * kBwdDh, 0, sm.lpad, L, threadIdx.x, blockDim.x);
  stage_rows(Vs, base, qkv_stride, 2 * A + h * kBwdDh, 0, sm.lpad, L, threadIdx.x, blockDim.x);
  const int q0 = blockIdx.x * kBwdRows + warp * 16;
  stage_rows(Qs, base, qkv_stride, h * kBwdDh, q0, 16, L, lane, 32);
  stage_rows(DOs, dmb, A, h * kBwdDh, q0, 16, L, lane, 32);
  __syncwarp();
  for (int c = lane; c < 16 * (kBwdDh / kVec); c += 32) {  // qsc = bf16(q * scale)
    const int r = c / (kBwdDh / kVec), k = (c % (kBwdDh / kVec)) * kVec;
    uint4* p = reinterpret_cast<uint4*>(Qs + r * kBwdPitch + k);
    *p = scale8(*p, scale);
  }
  __syncthreads();  // the only block-wide barrier: warps are independent below
  if (q0 >= L) return;

  const int ntiles = sm.lpad / 16;
  for (int nt = 0; nt < ntiles; ++nt) {  // s = qsc k^T
    BwdAcc s;
    row_col_tile(s, Qs, Ks + nt * 16 * kBwdPitch);
    wmma::store_matrix_sync(Ss + nt * 16, s, sm.s_pitch, wmma::mem_row_major);
  }
  __syncwarp();

  // m, e = exp(s - m) (0 past L) kept in fp32 in place of s, bf16(e), r
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int r = 0; r < 16; ++r) {
    float* srow = Ss + r * sm.s_pitch;
    bf16* prow = Ps + r * sm.p_pitch;
    float m = neg_inf;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < sm.lpad; j += 32) {
      const float e = j < L ? expf(srow[j] - m) : 0.f;
      sum += e;
      srow[j] = e;
      prow[j] = __float2bfloat16(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = m;
      r_s[r] = 1.f / sum;
    }
  }
  __syncwarp();

  // o = bf16(e) v, merged = bf16(o * r)
  BwdAcc o[kBwdDh / 16];
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  for (int kt = 0; kt < ntiles; ++kt) {
    BwdFragA pa;
    wmma::load_matrix_sync(pa, Ps + kt * 16, sm.p_pitch);
#pragma unroll
    for (int n = 0; n < kBwdDh / 16; ++n) {
      BwdFragB vb;
      wmma::load_matrix_sync(vb, Vs + kt * 16 * kBwdPitch + n * 16, kBwdPitch);
      wmma::mma_sync(o[n], pa, vb, o[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n)
    wmma::store_matrix_sync(Os + n * 16, o[n], kBwdOPitch, wmma::mem_row_major);
  __syncwarp();
  bf16* merged_b = merged + static_cast<size_t>(b) * L * A + h * kBwdDh;
  store_tile(Os, merged_b, A, q0, L, lane, [&](int r) { return r_s[r]; });
  __syncwarp();

  // c = rowsum(dp * e) * r with dp = do v^T, tile by tile; each lane sums
  // 8 columns of row lane / 2 of every tile, then the two lanes of a row
  const int rr = lane >> 1, cc = (lane & 1) * kVec;
  float cacc = 0.f;
  for (int nt = 0; nt < ntiles; ++nt) {
    BwdAcc dp;
    row_col_tile(dp, DOs, Vs + nt * 16 * kBwdPitch);
    wmma::store_matrix_sync(Os, dp, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kVec; ++e) cacc += Os[rr * 16 + cc + e] * Ss[rr * sm.s_pitch + nt * 16 + cc + e];
    __syncwarp();
  }
  cacc += __shfl_xor_sync(0xffffffffu, cacc, 1);
  if ((lane & 1) == 0) c_s[rr] = cacc * r_s[rr];
  __syncwarp();

  // dsp = bf16(e * (dp - c)) in place of bf16(e)
  const float c_row = c_s[rr];
  for (int nt = 0; nt < ntiles; ++nt) {
    BwdAcc dp;
    row_col_tile(dp, DOs, Vs + nt * 16 * kBwdPitch);
    wmma::store_matrix_sync(Os, dp, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int j = nt * 16 + cc + e;
      Ps[rr * sm.p_pitch + j] = __float2bfloat16(Ss[rr * sm.s_pitch + j] * (Os[rr * 16 + cc + e] - c_row));
    }
    __syncwarp();
  }

  // dq = bf16((dsp k) * (r * scale))
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n) wmma::fill_fragment(o[n], 0.f);
  for (int kt = 0; kt < ntiles; ++kt) {
    BwdFragA pa;
    wmma::load_matrix_sync(pa, Ps + kt * 16, sm.p_pitch);
#pragma unroll
    for (int n = 0; n < kBwdDh / 16; ++n) {
      BwdFragB kb;
      wmma::load_matrix_sync(kb, Ks + kt * 16 * kBwdPitch + n * 16, kBwdPitch);
      wmma::mma_sync(o[n], pa, kb, o[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n)
    wmma::store_matrix_sync(Os + n * 16, o[n], kBwdOPitch, wmma::mem_row_major);
  __syncwarp();
  bf16* dq_b = dqkv + static_cast<size_t>(b) * L * qkv_stride + h * kBwdDh;
  store_tile(Os, dq_b, qkv_stride, q0, L, lane, [&](int r) { return r_s[r] * scale; });

  if (lane < 16 && q0 + lane < L) {
    const size_t bhl = static_cast<size_t>(gridDim.z) * H * L;
    const size_t idx = (static_cast<size_t>(b) * H + h) * L + q0 + lane;
    stats[idx] = m_s[lane];
    stats[bhl + idx] = r_s[lane];
    stats[2 * bhl + idx] = c_s[lane];
  }
}

// dk and dv of 64 keys, summed over every query row.
__global__ void __launch_bounds__(kBwdWarps * 32)
attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dm,
                   const float* __restrict__ stats, bf16* __restrict__ dqkv, int L, int H,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kKvStageBytes);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * kKvStageBytes);   // bf16(q * scale)
  bf16* QRs = reinterpret_cast<bf16*>(smem + 3 * kKvStageBytes);  // bf16(qsc * r)
  bf16* DOs = reinterpret_cast<bf16*>(smem + 4 * kKvStageBytes);
  bf16* DORs = reinterpret_cast<bf16*>(smem + 5 * kKvStageBytes); // bf16(do * r)
  float* ms = reinterpret_cast<float*>(smem + 6 * kKvStageBytes);
  float* rs = ms + kBwdRows;
  float* cs = rs + kBwdRows;
  unsigned char* mine = smem + 6 * kKvStageBytes + 3 * kBwdRows * sizeof(float) +
                        warp * kKvWarpBytes;
  float* St = reinterpret_cast<float*>(mine);
  float* Dt = St + 256;
  bf16* Eb = reinterpret_cast<bf16*>(Dt + 256);
  bf16* Db = Eb + 256;

  const int b = blockIdx.z, h = blockIdx.y;
  const int A = H * kBwdDh;
  const size_t qkv_stride = 3 * static_cast<size_t>(A);
  const bf16* base = qkv + static_cast<size_t>(b) * L * qkv_stride;
  const bf16* dmb = dm + static_cast<size_t>(b) * L * A;
  const size_t bhl = static_cast<size_t>(gridDim.z) * H * L;
  const float* st_b = stats + (static_cast<size_t>(b) * H + h) * L;
  const int key_base = blockIdx.x * kBwdRows;
  const int key0 = key_base + warp * 16;
  stage_rows(Ks, base, qkv_stride, A + h * kBwdDh, key_base, kBwdRows, L, threadIdx.x, blockDim.x);
  stage_rows(Vs, base, qkv_stride, 2 * A + h * kBwdDh, key_base, kBwdRows, L, threadIdx.x,
             blockDim.x);

  BwdAcc dk[kBwdDh / 16], dv[kBwdDh / 16];
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  const int i = lane >> 1, jj = (lane & 1) * kVec;  // this lane's row, 8 columns of a tile
  for (int qt = 0; qt * kBwdRows < L; ++qt) {
    const int qbase = qt * kBwdRows;
    __syncthreads();  // the previous query tile is consumed
    if (threadIdx.x < kBwdRows) {
      const int q = qbase + threadIdx.x;
      const bool ok = q < L;
      ms[threadIdx.x] = ok ? st_b[q] : 0.f;
      rs[threadIdx.x] = ok ? st_b[bhl + q] : 0.f;
      cs[threadIdx.x] = ok ? st_b[2 * bhl + q] : 0.f;
    }
    stage_rows(Qs, base, qkv_stride, h * kBwdDh, qbase, kBwdRows, L, threadIdx.x, blockDim.x);
    stage_rows(DOs, dmb, A, h * kBwdDh, qbase, kBwdRows, L, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int c = threadIdx.x; c < kBwdRows * (kBwdDh / kVec); c += blockDim.x) {
      const int r = c / (kBwdDh / kVec), k = (c % (kBwdDh / kVec)) * kVec;
      const int off = r * kBwdPitch + k;
      const uint4 qsc = scale8(*reinterpret_cast<const uint4*>(Qs + off), scale);
      *reinterpret_cast<uint4*>(Qs + off) = qsc;
      *reinterpret_cast<uint4*>(QRs + off) = scale8(qsc, rs[r]);
      *reinterpret_cast<uint4*>(DORs + off) =
          scale8(*reinterpret_cast<const uint4*>(DOs + off), rs[r]);
    }
    __syncthreads();
    if (key0 >= L) continue;
    for (int st = 0; st < kBwdWarps && qbase + st * 16 < L; ++st) {
      const int qrow = st * 16;
      BwdAcc s, dp;
      row_col_tile(s, Qs + qrow * kBwdPitch, Ks + warp * 16 * kBwdPitch);
      row_col_tile(dp, DOs + qrow * kBwdPitch, Vs + warp * 16 * kBwdPitch);
      wmma::store_matrix_sync(St, s, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(Dt, dp, 16, wmma::mem_row_major);
      __syncwarp();
      const int q = qbase + qrow + i;
      const float m = ms[qrow + i], c = cs[qrow + i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int idx = i * 16 + jj + e;
        const bool valid = q < L && key0 + jj + e < L;
        const float ev = valid ? expf(St[idx] - m) : 0.f;
        Eb[idx] = __float2bfloat16(ev);
        Db[idx] = __float2bfloat16(ev * (Dt[idx] - c));
      }
      __syncwarp();
      // dv += bf16(e)^T bf16(do * r), dk += dsp^T bf16(qsc * r); the
      // (query, key) tiles read column-major are their transposes
      BwdFragAT ea, da;
      wmma::load_matrix_sync(ea, Eb, 16);
      wmma::load_matrix_sync(da, Db, 16);
#pragma unroll
      for (int n = 0; n < kBwdDh / 16; ++n) {
        BwdFragB bv, bk;
        wmma::load_matrix_sync(bv, DORs + qrow * kBwdPitch + n * 16, kBwdPitch);
        wmma::mma_sync(dv[n], ea, bv, dv[n]);
        wmma::load_matrix_sync(bk, QRs + qrow * kBwdPitch + n * 16, kBwdPitch);
        wmma::mma_sync(dk[n], da, bk, dk[n]);
      }
      __syncwarp();
    }
  }
  __syncthreads();  // the query stage becomes the output tiles
  if (key0 >= L) return;
  float* Os = reinterpret_cast<float*>(Qs) + warp * 16 * kBwdOPitch;
  bf16* dq_b = dqkv + static_cast<size_t>(b) * L * qkv_stride + h * kBwdDh;
  auto one = [](int) { return 1.f; };
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n)
    wmma::store_matrix_sync(Os + n * 16, dk[n], kBwdOPitch, wmma::mem_row_major);
  __syncwarp();
  store_tile(Os, dq_b + A, qkv_stride, key0, L, lane, one);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kBwdDh / 16; ++n)
    wmma::store_matrix_sync(Os + n * 16, dv[n], kBwdOPitch, wmma::mem_row_major);
  __syncwarp();
  store_tile(Os, dq_b + 2 * A, qkv_stride, key0, L, lane, one);
}

// merged, dq, dk and dv (into dqkv) from qkv and dm; stats is scratch of
// 3 * B * H * L floats.
inline cudaError_t launch_attn_bwd_core(const bf16* qkv, const bf16* dm, bf16* merged,
                                        bf16* dqkv, float* stats, int B, int L, int H,
                                        float scale, cudaStream_t stream) {
  const size_t smem_q = attn_bwd_q_smem(L).total;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kKvSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBwdRows - 1) / kBwdRows, H, B);
  attn_bwd_q_kernel<<<grid, kBwdWarps * 32, smem_q, stream>>>(qkv, dm, merged, dqkv, stats, L, H,
                                                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<<<grid, kBwdWarps * 32, kKvSmemBytes, stream>>>(qkv, dm, stats, dqkv, L, H,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
