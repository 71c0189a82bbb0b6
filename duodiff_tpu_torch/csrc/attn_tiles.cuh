// Register-resident tensor-core tiles for the attention cores
// (attn_core.cuh, attn_bwd_core.cuh): mma.sync m16n8k16 on bf16 with fp32
// accumulators, ldmatrix from a swizzled shared-memory stage of a head's
// rows, the A operand straight from device memory, and 16-byte stores of an
// accumulator tile without a pass through shared memory.
//
// Layouts (PTX ISA, mma.m16n8k16, with g = lane / 4 and tg = lane % 4):
//   accumulator c[0..3]: (row g, cols 2tg, 2tg+1), (row g+8, same cols);
//   A a[0..3]: (row g, k 2tg..), (row g+8, k 2tg..), (row g, k 8+2tg..),
//     (row g+8, k 8+2tg..), two bf16 a register;
//   B b0, b1: (k 2tg.., col g), (k 8+2tg.., col g).
// Two neighbouring accumulator tiles (16 columns) of one product are, packed
// to bf16, exactly the A operand of a k-step of the next one, so a softmax
// between two products never leaves the registers.
#pragma once

#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kHeadDim = 64;          // head width the cores take
constexpr int kHeadRowBytes = 128;    // a staged row: 8 chunks of 16 bytes
constexpr int kMaxSeq = 272;          // 34 score tiles of 8 keys = 136 registers a thread
constexpr int kSmCount = 132;         // an H100 SXM's SMs

// The blocks a head's 16-row tiles are split over: one when the heads alone
// make `wanted` blocks (a few for every SM), more while they are fewer and a
// block of `warps` warps would still have a tile for each warp.
inline int head_splits(int heads, int L, int warps, int wanted) {
  const int tiles = (L + 15) / 16;
  int splits = 1;
  while (heads * splits < wanted && splits * warps < tiles) ++splits;
  return splits;
}

__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4], unsigned b0,
                                          unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}

// Both halves of a packed pair times s, each product rounded to bf16.
__device__ __forceinline__ unsigned scale_bf16x2(unsigned w, float s) {
  const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return pack_bf16x2(__low2float(t) * s, __high2float(t) * s);
}

// A staged head: row r (64 bf16) at byte r * 128, its 16-byte chunk c at
// chunk c ^ (r & 7) of the row, so that the eight rows an ldmatrix reads at
// one chunk index fall into eight different bank groups without padding.
__device__ __forceinline__ unsigned staged_byte(int row, int chunk) {
  return static_cast<unsigned>(row * kHeadRowBytes + ((chunk ^ (row & 7)) << 4));
}

// Rows [0, rows_pad) of a head into the stage at dst, 16 bytes a copy, in
// flight behind whatever follows until cp_async_wait; rows past L arrive as
// zeros (nothing is read for them).
__device__ __forceinline__ void stage_head_async(unsigned char* dst, const bf16* src,
                                                 size_t stride, int rows_pad, int L, int tid,
                                                 int threads) {
  for (int c = tid; c < rows_pad * 8; c += threads) {
    const int r = c >> 3, ch = c & 7;
    const bool ok = r < L;
    cp_async16(dst + staged_byte(r, ch), src + (ok ? r : 0) * stride + ch * kVec, ok);
  }
}

// Per-lane byte offsets into a stage for the two ldmatrix patterns below.
// rows_offset(lane, c0): matrices 0..3 are rows r0..r0+7 at chunks c0..c0+3
//   (add r0 * 128, r0 a multiple of 8): for a stage of [n][k] rows this
//   gives b0, b1 of k-step c0 / 2 in r[0], r[1] and of the next in r[2], r[3].
// trans_offset(lane, c0): matrices are (rows r0..r0+7, chunk c0), (rows
//   r0+8..r0+15, chunk c0), then the same rows at chunk c0 + 1 (add r0 * 128,
//   r0 a multiple of 16): with .trans, for a stage of [k][n] rows this gives
//   b0, b1 of column tile c0 in r[0], r[1] and of tile c0 + 1 in r[2], r[3].
__device__ __forceinline__ unsigned rows_offset(int lane, int c0) {
  return staged_byte(lane & 7, c0 + (lane >> 3));
}

__device__ __forceinline__ unsigned trans_offset(int lane, int c0) {
  return staged_byte((lane & 7) + ((lane >> 3) & 1) * 8, c0 + (lane >> 4));
}

// The A operand (16 rows x 64, four k-steps) of rows row0.. of a head read
// from device memory, rows past L as zeros; scale != 1 multiplies and rounds
// each value to bf16.
__device__ __forceinline__ void load_a_rows(unsigned a[4][4], const bf16* src, size_t stride,
                                            int row0, int L, int lane, float scale) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    const bool ok = r < L;
    const unsigned* p = reinterpret_cast<const unsigned*>(src + (ok ? r : 0) * stride) + tg;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned lo = ok ? p[kk * 8] : 0u, hi = ok ? p[kk * 8 + 4] : 0u;
      if (scale != 1.f) {
        lo = scale_bf16x2(lo, scale);
        hi = scale_bf16x2(hi, scale);
      }
      a[kk][half] = lo;
      a[kk][2 + half] = hi;
    }
  }
}

__device__ __forceinline__ unsigned sel4(int i, unsigned a, unsigned b, unsigned c, unsigned d) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// One row of a 16 x 64 accumulator tile out as two 16-byte stores: the
// thread holds w[n] = columns 8n + 2tg, 8n + 2tg + 1 (packed bf16) of the
// row, n = 0..7; the four lanes of the row exchange words so that lane tg
// holds columns 16tg..16tg+15. All 32 lanes call it; `ok` guards the store.
__device__ __forceinline__ void store_row64(bf16* row, const unsigned w[8], int tg, bool ok) {
  uint4 v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    unsigned got[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // lane t^r wants this lane's word of segment 2(t^r) + j
      const unsigned send = sel4(tg ^ r, w[j], w[2 + j], w[4 + j], w[6 + j]);
      got[r] = r == 0 ? send : __shfl_xor_sync(0xffffffffu, send, r);
    }
    // got[r] came from lane tg ^ r and is word tg ^ r of the segment
    v[j].x = sel4(tg, got[0], got[1], got[2], got[3]);
    v[j].y = sel4(tg ^ 1, got[0], got[1], got[2], got[3]);
    v[j].z = sel4(tg ^ 2, got[0], got[1], got[2], got[3]);
    v[j].w = sel4(tg ^ 3, got[0], got[1], got[2], got[3]);
  }
  if (ok) {
    uint4* dst = reinterpret_cast<uint4*>(row + 16 * tg);
    dst[0] = v[0];
    dst[1] = v[1];
  }
}

// Both rows (g and g + 8) of a 16 x 64 fp32 accumulator tile o[n][0..3],
// each times its own factor, rounded to bf16, to rows row0 + g and
// row0 + g + 8 (< L) of dst.
__device__ __forceinline__ void store_tile64(bf16* dst, size_t stride, int row0, int L, int lane,
                                             const float o[8][4], float mul_lo, float mul_hi) {
  const int g = lane >> 2, tg = lane & 3;
  unsigned w[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) w[n] = pack_bf16x2(o[n][0] * mul_lo, o[n][1] * mul_lo);
  store_row64(dst + static_cast<size_t>(row0 + g) * stride, w, tg, row0 + g < L);
#pragma unroll
  for (int n = 0; n < 8; ++n) w[n] = pack_bf16x2(o[n][2] * mul_hi, o[n][3] * mul_hi);
  store_row64(dst + static_cast<size_t>(row0 + g + 8) * stride, w, tg, row0 + g + 8 < L);
}

// ---- the row blocks of the attention cores ----
//
// A warp's 16 x L block of scores is kTiles accumulator tiles of 8 keys.
// kTiles is a template argument, so that every loop over the tiles unrolls
// into straight-line code with the tiles in registers and no branch between
// two tensor-core instructions; a launch picks the smallest of three classes
// that holds its L (SeqClass). Keys from L up to 8 * kTiles are rows of zeros
// in the stage and are masked; tiles under kMaskFrom (the class below's
// size) hold valid keys only and skip the masking.

template <int kTilesArg, int kMaskFromArg>
struct SeqClass {
  static constexpr int kTiles = kTilesArg;        // 8 keys each; even
  static constexpr int kMaskFrom = kMaskFromArg;  // the first tile that may hold a key past L
  static constexpr int kKeys = 8 * kTilesArg;     // rows of a staged head
  static constexpr size_t kHeadBytes = static_cast<size_t>(kKeys) * kHeadRowBytes;
};

// f(SeqClass) for the class of sequence length L (L <= kMaxSeq).
template <typename F>
inline auto with_seq_class(int L, F&& f) {
  if (L <= 80) return f(SeqClass<10, 0>{});
  if (L <= 144) return f(SeqClass<18, 10>{});
  return f(SeqClass<kMaxSeq / 8, 18>{});
}

// exp(x) for x <= 0 (a score less its row maximum) as one multiplication
// and one ex2.approx: 2 ulp of the fp32 result, far inside the bf16 rounding
// e gets next, and a third of expf's instructions in a loop that its
// instruction count bounds. exp(-inf) = 0, and results under 2^-126 flush to 0. Both
// launches of the backward core form e with it, so their e agree.
__device__ __forceinline__ float exp_nonpos(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The two neighbouring tiles nt0, nt0 + 1 (16 keys) of
// c = a(16 x 64) rows(8 x 64)^T, rows 8nt..8nt+7 of a stage a tile, formed
// together: the two accumulator chains are independent and their k-steps
// alternate. Each tile sums its four k-steps in order. off0 and
// off1 are the stage's address plus rows_offset(lane, 0) and
// rows_offset(lane, 4).
__device__ __forceinline__ void row_col_pair(float (*c)[4], const unsigned (&a)[4][4],
                                             unsigned off0, unsigned off1, int nt0) {
  unsigned f[2][2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    ldmatrix_x4(f[t][0], off0 + (nt0 + t) * 8 * kHeadRowBytes);
    ldmatrix_x4(f[t][1], off1 + (nt0 + t) * 8 * kHeadRowBytes);
    c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
      mma_16816(c[t], a[kk], f[t][kk >> 1][(kk & 1) * 2], f[t][kk >> 1][(kk & 1) * 2 + 1]);
  }
}

// s = a k^T for the staged rows of k: tile nt holds keys 8nt..8nt+7.
template <int kTiles>
__device__ __forceinline__ void score_tiles(float (&s)[kTiles][4], const unsigned (&a)[4][4],
                                            unsigned k_stage, int lane) {
  const unsigned off0 = k_stage + rows_offset(lane, 0), off1 = k_stage + rows_offset(lane, 4);
#pragma unroll
  for (int nt = 0; nt < kTiles; nt += 2) row_col_pair(&s[nt], a, off0, off1, nt);
}

// In place: s -> e = exp(s - m) with keys past L masked (e = 0); returns
// the row maxima and the fp32 sums of e of rows g (lo) and g + 8 (hi).
template <int kTiles, int kMaskFrom>
__device__ __forceinline__ void softmax_rows(float (&s)[kTiles][4], int L, int lane, float& m_lo,
                                             float& m_hi, float& sum_lo, float& sum_hi) {
  const float neg_inf = __uint_as_float(0xff800000u);
  const int left = L - (lane & 3) * 2;  // key 8nt + 2tg (+ 1) is past L iff 8nt (+ 1) >= left
  m_lo = neg_inf;
  m_hi = neg_inf;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    if (nt >= kMaskFrom) {
      if (nt * 8 >= left) s[nt][0] = s[nt][2] = neg_inf;
      if (nt * 8 + 1 >= left) s[nt][1] = s[nt][3] = neg_inf;
    }
    m_lo = fmaxf(m_lo, fmaxf(s[nt][0], s[nt][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[nt][2], s[nt][3]));
  }
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));
  sum_lo = 0.f;
  sum_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    s[nt][0] = exp_nonpos(s[nt][0] - m_lo);
    s[nt][1] = exp_nonpos(s[nt][1] - m_lo);
    s[nt][2] = exp_nonpos(s[nt][2] - m_hi);
    s[nt][3] = exp_nonpos(s[nt][3] - m_hi);
    sum_lo += s[nt][0] + s[nt][1];
    sum_hi += s[nt][2] + s[nt][3];
  }
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
}

// The A operand of k-step kk (16 keys) of a product over the keys, from the
// fp32 accumulator tiles 2kk and 2kk + 1, rounded to bf16.
template <int kTiles>
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&p)[kTiles][4], int kk) {
  a[0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// o += a rows(16 x 64) for rows 16kk..16kk+15 of a stage, the rows being the
// reduction (ldmatrix.trans): eight independent accumulator tiles. toff is
// trans_offset(lane, 0); the swizzle is an XOR on its chunk bits.
__device__ __forceinline__ void rows_product_step(float (&o)[8][4], const unsigned (&a)[4],
                                                  unsigned stage, unsigned toff, int kk) {
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    unsigned f[4];
    ldmatrix_x4_trans(f, stage + (toff ^ (c << 4)) + kk * 16 * kHeadRowBytes);
    mma_16816(o[c], a, f[0], f[1]);
    mma_16816(o[c + 1], a, f[2], f[3]);
  }
}

__device__ __forceinline__ void zero_tile64(float (&o)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
}

// o = bf16(p) v for the staged rows of v, p given as fp32 accumulator tiles.
template <int kTiles>
__device__ __forceinline__ void value_tiles(float (&o)[8][4], const float (&p)[kTiles][4],
                                            unsigned v_stage, int lane) {
  const unsigned toff = trans_offset(lane, 0);
  zero_tile64(o);
#pragma unroll
  for (int kk = 0; kk < kTiles / 2; ++kk) {
    unsigned a[4];
    pack_a(a, p, kk);
    rows_product_step(o, a, v_stage, toff, kk);
  }
}

}  // namespace
}  // namespace duodiff
