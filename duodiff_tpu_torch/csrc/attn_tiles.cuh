// Register-resident tensor-core tiles for the attention cores
// (attn_core.cuh, attn_bwd_core.cuh): mma.sync m16n8k16 on bf16 with fp32
// accumulators, ldmatrix from a shared-memory stage of a head's rows, the A
// operand straight from device memory, and 16-byte stores of an accumulator
// tile without a pass through shared memory.
//
// Layouts (PTX ISA, mma.m16n8k16, with g = lane / 4 and tg = lane % 4):
//   accumulator c[0..3]: (row g, cols 2tg, 2tg+1), (row g+8, same cols);
//   A a[0..3]: (row g, k 2tg..), (row g+8, k 2tg..), (row g, k 8+2tg..),
//     (row g+8, k 8+2tg..), two bf16 a register;
//   B b0, b1: (k 2tg.., col g), (k 8+2tg.., col g).
// mma.m16n8k8 (bf16) is the first half of it: A a[0..1], B b0.
// Two neighbouring accumulator tiles (16 columns) of one product are, packed
// to bf16, exactly the A operand of a k-step of the next one, so a softmax
// between two products never leaves the registers.
//
// The head width Dh is a template argument (HeadDim): 64, every config of
// the repository, and 72, U-ViT-H's and DiT-XL's (D = 1152, 16 heads). A
// product over Dh is Dh / 16 m16n8k16 steps and, at 72 = 4 * 16 + 8, one
// m16n8k8 step after them; a 16 x Dh output is Dh / 8 accumulator tiles.
#pragma once

#include "common.cuh"

namespace duodiff {
namespace {

constexpr int kMaxSeq = 272;          // 34 score tiles of 8 keys = 136 registers a thread
// The blocked forms of the cores (attn_core.cuh, attn_bwd_core.cuh) take the
// lengths past kMaxSeq up to this one: a thread sums its quarter of a score
// row's unrounded e (and, in the backward, of dp * e) one by one in fp32, L / 4
// terms, whose rounding error stays under (L / 4) * 2^-24 = 2^-12 of the sum
// of their magnitudes at L = 2^14, far inside the bf16 rounding of the
// outputs; no register or shared-memory size depends on L.
constexpr int kMaxSeqBlocked = 16384;
constexpr int kSmCount = 132;         // an H100 SXM's SMs

// Which form of a core (attn_core.cuh, attn_bwd_core.cuh) a launch takes: by
// L (kCoreAuto: the register form up to kMaxSeq, the blocked one past it),
// or one of them forced at a length both take (the measuring entries
// duodiff_attn_core_form and duodiff_attn_bwd_core_form).
enum CoreForm : int { kCoreAuto = 0, kCoreRegisters = 1, kCoreBlocked = 2 };

inline bool blocked_form(int L, int form) {
  return form == kCoreBlocked || (form == kCoreAuto && L > kMaxSeq);
}

// A head of width kDhArg as the cores stage and multiply it. A staged row is
// Dh bf16, 2 Dh bytes: at 64 a row is 128 bytes, and its 16-byte chunk c
// sits at chunk c ^ (r & 7) (an XOR swizzle), so that the eight rows an
// ldmatrix reads at one chunk index fall into eight different groups of 4
// banks without padding. At 72 a row is 144 bytes = 36 words: row r starts
// at bank 4r mod 32, so eight consecutive rows at one chunk index start at
// banks 0, 4, ..., 28 (plus the chunk's offset) and again fall into eight
// different groups of 4 banks, with no swizzle and no padding.
template <int kDhArg>
struct HeadDim {
  static constexpr int kDh = kDhArg;
  static constexpr int kChunks = kDh / 8;       // 16-byte chunks a row = 8-column output tiles
  static constexpr int kK16 = kDh / 16;         // m16n8k16 steps of a product over Dh
  static constexpr bool kK8 = kDh % 16 != 0;    // and one m16n8k8 step after them
  static constexpr int kRowBytes = 2 * kDh;
  static constexpr bool kSwizzled = kRowBytes == 128;
  static_assert(kK16 == 4 && (kDh == 64 || kDh == 72), "the cores take head width 64 or 72");

  // byte offset of chunk `chunk` of staged row `row`
  __device__ static __forceinline__ unsigned staged_byte(int row, int chunk) {
    return static_cast<unsigned>(row * kRowBytes +
                                 ((kSwizzled ? chunk ^ (row & 7) : chunk) << 4));
  }
  // chunk c of a row from the offset of its chunk 0 (or 1, for odd lanes'
  // halves of an x4 pattern; c even when swizzled)
  __device__ static __forceinline__ unsigned at_chunk(unsigned off, int c) {
    return kSwizzled ? off ^ static_cast<unsigned>(c << 4) : off + static_cast<unsigned>(c << 4);
  }
};

// f(HeadDim<Dh>) for a head width the cores take, else `none`.
template <typename R, typename F>
inline R with_head_dim(int Dh, R none, F&& f) {
  if (Dh == 64) return f(HeadDim<64>{});
  if (Dh == 72) return f(HeadDim<72>{});
  return none;
}

// The head widths the cores take, in order (the library reports them).
constexpr int kHeadWidths[] = {64, 72};

// The blocks a head's 16-row tiles are split over: one when the heads alone
// make `wanted` blocks (a few for every SM), more while they are fewer and a
// block of `warps` warps would still have a tile for each warp.
inline int head_splits(int heads, int L, int warps, int wanted) {
  const int tiles = (L + 15) / 16;
  int splits = 1;
  while (heads * splits < wanted && splits * warps < tiles) ++splits;
  return splits;
}

// The blocks of `kernel` an SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory a block, as the runtime reckons them (0 on an error).
template <typename K>
inline int resident_blocks(K* kernel, int threads, size_t smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4], unsigned b0,
                                          unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k = 8 step of a product over Dh = 72: A a[0..1] (rows g and g + 8,
// k 2tg..), B b0.
__device__ __forceinline__ void mma_1688(float c[4], const unsigned a[2], unsigned b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Two 8 x 8 matrices; lanes 0-15 give the rows' addresses.
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
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

// Rows [0, rows_pad) of a head into the stage at dst, 16 bytes a copy, in
// flight behind whatever follows until cp_async_wait; rows past L arrive as
// zeros (nothing is read for them).
template <typename HD>
__device__ __forceinline__ void stage_head_async(unsigned char* dst, const bf16* src,
                                                 size_t stride, int rows_pad, int L, int tid,
                                                 int threads) {
  for (int c = tid; c < rows_pad * HD::kChunks; c += threads) {
    const int r = c / HD::kChunks, ch = c % HD::kChunks;
    const bool ok = r < L;
    cp_async16(dst + HD::staged_byte(r, ch), src + (ok ? r : 0) * stride + ch * kVec, ok);
  }
}

// Per-lane byte offsets into a stage for the ldmatrix patterns below.
// rows_offset(lane, c0): matrices 0..3 are rows r0..r0+7 at chunks c0..c0+3
//   (add r0 * kRowBytes, r0 a multiple of 8): for a stage of [n][k] rows
//   this gives b0, b1 of k-step c0 / 2 in r[0], r[1] and of the next in
//   r[2], r[3].
// trans_offset(lane, c0): matrices are (rows r0..r0+7, chunk c0), (rows
//   r0+8..r0+15, chunk c0), then the same rows at chunk c0 + 1 (add
//   r0 * kRowBytes, r0 a multiple of 16): with .trans, for a stage of [k][n]
//   rows this gives b0, b1 of column tile c0 in r[0], r[1] and of tile
//   c0 + 1 in r[2], r[3].
// tail_offset(lane): the x2 pattern of the last chunk (Dh = 72's ninth):
//   matrices (rows r0..r0+7) and (rows r0+8..r0+15) at chunk kChunks - 1.
//   Without .trans, for a stage of [n][k] rows (add r0 * kRowBytes, r0 a
//   multiple of 8) it gives b0 of the m16n8k8 step of tile r0 / 8 in r[0]
//   and of tile r0 / 8 + 1 in r[1]; with .trans, for a stage of [k][n] rows,
//   b0 and b1 of the last column tile.
template <typename HD>
__device__ __forceinline__ unsigned rows_offset(int lane, int c0) {
  return HD::staged_byte(lane & 7, c0 + (lane >> 3));
}

template <typename HD>
__device__ __forceinline__ unsigned trans_offset(int lane, int c0) {
  return HD::staged_byte((lane & 7) + ((lane >> 3) & 1) * 8, c0 + (lane >> 4));
}

template <typename HD>
__device__ __forceinline__ unsigned tail_offset(int lane) {
  return HD::staged_byte((lane & 7) + ((lane >> 3) & 1) * 8, HD::kChunks - 1);
}

// The A operand of 16 rows x Dh: kK16 k-steps of 16, and at Dh = 72 the
// m16n8k8 step's two registers in k8 (unused at 64).
template <typename HD>
struct ARows {
  unsigned k16[HD::kK16][4];
  unsigned k8[2];
};

// The A operand of rows row0.. of a head read from device memory, rows past
// L as zeros; scale != 1 multiplies and rounds each value to bf16.
template <typename HD>
__device__ __forceinline__ void load_a_rows(ARows<HD>& a, const bf16* src, size_t stride,
                                            int row0, int L, int lane, float scale) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    const bool ok = r < L;
    const unsigned* p = reinterpret_cast<const unsigned*>(src + (ok ? r : 0) * stride) + tg;
#pragma unroll
    for (int kk = 0; kk < HD::kK16; ++kk) {
      unsigned lo = ok ? p[kk * 8] : 0u, hi = ok ? p[kk * 8 + 4] : 0u;
      if (scale != 1.f) {
        lo = scale_bf16x2(lo, scale);
        hi = scale_bf16x2(hi, scale);
      }
      a.k16[kk][half] = lo;
      a.k16[kk][2 + half] = hi;
    }
    if constexpr (HD::kK8) {
      unsigned t = ok ? p[HD::kK16 * 8] : 0u;
      if (scale != 1.f) t = scale_bf16x2(t, scale);
      a.k8[half] = t;
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

// Both rows (g and g + 8) of a 16 x Dh fp32 accumulator tile o[n][0..3],
// each times its own factor, rounded to bf16, to rows row0 + g and
// row0 + g + 8 (< L) of dst: columns 0..63 as store_row64's 16-byte stores,
// and at Dh = 72 the last tile as the row's four lanes' 4-byte words, which
// together are its 16 contiguous bytes.
template <typename HD>
__device__ __forceinline__ void store_tile(bf16* dst, size_t stride, int row0, int L, int lane,
                                           const float (&o)[HD::kChunks][4], float mul_lo,
                                           float mul_hi) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float mul = half ? mul_hi : mul_lo;
    bf16* row = dst + static_cast<size_t>(row0 + g + 8 * half) * stride;
    const bool ok = row0 + g + 8 * half < L;
    unsigned w[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) w[n] = pack_bf16x2(o[n][2 * half] * mul, o[n][2 * half + 1] * mul);
    store_row64(row, w, tg, ok);
    if constexpr (HD::kChunks > 8) {
      if (ok)
        reinterpret_cast<unsigned*>(row + 64)[tg] =
            pack_bf16x2(o[8][2 * half] * mul, o[8][2 * half + 1] * mul);
    }
  }
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
};

// Bytes of a staged head of class Seq and width HD.
template <typename Seq, typename HD>
__host__ __device__ constexpr size_t head_bytes() {
  return static_cast<size_t>(Seq::kKeys) * HD::kRowBytes;
}

// f(SeqClass) for the class of sequence length L (L <= kMaxSeq).
template <typename F>
inline auto with_seq_class(int L, F&& f) {
  if (L <= 80) return f(SeqClass<10, 0>{});
  if (L <= 144) return f(SeqClass<18, 10>{});
  return f(SeqClass<kMaxSeq / 8, 18>{});
}

// A block of keys of the blocked core: kTiles accumulator tiles of 8 keys a
// warp holds at a time, kKeys rows of K (and of V) staged at a time. Any
// tile of the last block may hold a key past L, so masking is decided per
// block at run time (mask_keys), not by a first masked tile.
template <int kTilesArg>
struct KeyBlock {
  static constexpr int kTiles = kTilesArg;  // 8 keys each; even
  static constexpr int kKeys = 8 * kTilesArg;
};

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

// The offsets a warp's row_col_pair reads a stage at: the stage's address
// plus rows_offset(lane, 0), rows_offset(lane, 4) and tail_offset(lane).
struct RowsAt {
  unsigned off0, off1, tail;
};

template <typename HD>
__device__ __forceinline__ RowsAt rows_at(unsigned stage, int lane) {
  return {stage + rows_offset<HD>(lane, 0), stage + rows_offset<HD>(lane, 4),
          stage + tail_offset<HD>(lane)};
}

// The two neighbouring tiles nt0, nt0 + 1 (16 keys) of
// c = a(16 x Dh) rows(8 x Dh)^T, rows 8nt..8nt+7 of a stage a tile, formed
// together: the two accumulator chains are independent and their k-steps
// alternate. Each tile sums its four k16 steps in order, then at Dh = 72
// its k8 step.
template <typename HD>
__device__ __forceinline__ void row_col_pair(float (*c)[4], const ARows<HD>& a, RowsAt at,
                                             int nt0) {
  constexpr unsigned kTileBytes = 8 * HD::kRowBytes;
  unsigned f[2][2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    ldmatrix_x4(f[t][0], at.off0 + (nt0 + t) * kTileBytes);
    ldmatrix_x4(f[t][1], at.off1 + (nt0 + t) * kTileBytes);
    c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < HD::kK16; ++kk) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
      mma_16816(c[t], a.k16[kk], f[t][kk >> 1][(kk & 1) * 2], f[t][kk >> 1][(kk & 1) * 2 + 1]);
  }
  if constexpr (HD::kK8) {
    unsigned b[2];
    ldmatrix_x2(b, at.tail + nt0 * kTileBytes);
#pragma unroll
    for (int t = 0; t < 2; ++t) mma_1688(c[t], a.k8, b[t]);
  }
}

// s = a k^T for the staged rows of k: tile nt holds keys 8nt..8nt+7.
template <int kTiles, typename HD>
__device__ __forceinline__ void score_tiles(float (&s)[kTiles][4], const ARows<HD>& a,
                                            unsigned k_stage, int lane) {
  const RowsAt at = rows_at<HD>(k_stage, lane);
#pragma unroll
  for (int nt = 0; nt < kTiles; nt += 2) row_col_pair<HD>(&s[nt], a, at, nt);
}

// In place: the scores of keys at or past `left` + 2tg, counted from the
// first key of tile 0, to -inf (softmax_rows' masking, for every tile).
template <int kTiles>
__device__ __forceinline__ void mask_keys(float (&s)[kTiles][4], int left, int lane) {
  const float neg_inf = __uint_as_float(0xff800000u);
  left -= (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    if (nt * 8 >= left) s[nt][0] = s[nt][2] = neg_inf;
    if (nt * 8 + 1 >= left) s[nt][1] = s[nt][3] = neg_inf;
  }
}

// The row maxima of rows g (lo) and g + 8 (hi) over the four lanes that hold
// them, from each lane's own.
__device__ __forceinline__ void quad_max(float& m_lo, float& m_hi) {
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));
}

// The same for the row sums, in softmax_rows' order.
__device__ __forceinline__ void quad_sum(float& sum_lo, float& sum_hi) {
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
}

// The running row maxima of rows g (lo) and g + 8 (hi): this lane's, over
// tiles [0, kTiles) of s, onto m_lo and m_hi.
template <int kTiles>
__device__ __forceinline__ void max_tiles(const float (&s)[kTiles][4], float& m_lo, float& m_hi) {
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    m_lo = fmaxf(m_lo, fmaxf(s[nt][0], s[nt][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[nt][2], s[nt][3]));
  }
}

// In place: s -> e = exp(s - m), each tile's four e added to this lane's
// running sums in tile order (pairs first, as one row's two columns).
template <int kTiles>
__device__ __forceinline__ void exp_tiles(float (&s)[kTiles][4], float m_lo, float m_hi,
                                          float& sum_lo, float& sum_hi) {
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    s[nt][0] = exp_nonpos(s[nt][0] - m_lo);
    s[nt][1] = exp_nonpos(s[nt][1] - m_lo);
    s[nt][2] = exp_nonpos(s[nt][2] - m_hi);
    s[nt][3] = exp_nonpos(s[nt][3] - m_hi);
    sum_lo += s[nt][0] + s[nt][1];
    sum_hi += s[nt][2] + s[nt][3];
  }
}

// In place: s -> e = exp(s - m) with keys past L masked (e = 0); returns
// the row maxima and the fp32 sums of e of rows g (lo) and g + 8 (hi).
template <int kTiles, int kMaskFrom>
__device__ __forceinline__ void softmax_rows(float (&s)[kTiles][4], int L, int lane, float& m_lo,
                                             float& m_hi, float& sum_lo, float& sum_hi) {
  const float neg_inf = __uint_as_float(0xff800000u);
  const int left = L - (lane & 3) * 2;  // key 8nt + 2tg (+ 1) is past L iff 8nt (+ 1) >= left
#pragma unroll
  for (int nt = kMaskFrom; nt < kTiles; ++nt) {
    if (nt * 8 >= left) s[nt][0] = s[nt][2] = neg_inf;
    if (nt * 8 + 1 >= left) s[nt][1] = s[nt][3] = neg_inf;
  }
  m_lo = neg_inf;
  m_hi = neg_inf;
  max_tiles(s, m_lo, m_hi);
  quad_max(m_lo, m_hi);
  sum_lo = 0.f;
  sum_hi = 0.f;
  exp_tiles(s, m_lo, m_hi, sum_lo, sum_hi);
  quad_sum(sum_lo, sum_hi);
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

// The offsets a warp's rows_product_step reads a stage at: trans_offset(lane,
// 0) and tail_offset(lane), from the stage's start.
struct TransAt {
  unsigned toff, tail;
};

template <typename HD>
__device__ __forceinline__ TransAt trans_at(int lane) {
  return {trans_offset<HD>(lane, 0), tail_offset<HD>(lane)};
}

// o += a rows(16 x Dh) for rows 16kk..16kk+15 of a stage, the rows being the
// reduction (ldmatrix.trans): Dh / 8 independent accumulator tiles.
template <typename HD>
__device__ __forceinline__ void rows_product_step(float (&o)[HD::kChunks][4],
                                                  const unsigned (&a)[4], unsigned stage,
                                                  TransAt at, int kk) {
  const unsigned rows = stage + kk * 16 * HD::kRowBytes;
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    unsigned f[4];
    ldmatrix_x4_trans(f, rows + HD::at_chunk(at.toff, c));
    mma_16816(o[c], a, f[0], f[1]);
    mma_16816(o[c + 1], a, f[2], f[3]);
  }
  if constexpr (HD::kChunks > 8) {
    unsigned f[2];
    ldmatrix_x2_trans(f, rows + at.tail);
    mma_16816(o[HD::kChunks - 1], a, f[0], f[1]);
  }
}

template <int kN>
__device__ __forceinline__ void zero_tiles(float (&o)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
}

// o = bf16(p) v for the staged rows of v, p given as fp32 accumulator tiles.
template <int kTiles, typename HD>
__device__ __forceinline__ void value_tiles(float (&o)[HD::kChunks][4],
                                            const float (&p)[kTiles][4], unsigned v_stage,
                                            int lane) {
  const TransAt at = trans_at<HD>(lane);
  zero_tiles(o);
#pragma unroll
  for (int kk = 0; kk < kTiles / 2; ++kk) {
    unsigned a[4];
    pack_a(a, p, kk);
    rows_product_step<HD>(o, a, v_stage, at, kk);
  }
}

}  // namespace
}  // namespace duodiff
