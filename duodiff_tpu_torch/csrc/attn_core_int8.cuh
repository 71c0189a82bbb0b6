// The int8 attention core of K15: softmax(q k^T) v per (sample, head) with
// both contractions on the int8 tensor cores, no 1/sqrt(Dh) scale, on bf16
// rows given as HeadRows views (common.cuh).
//
// Replaces: tools/probe_int8_sdpa.py _sdpa_int8_kernel (:68-90) with its
// _quant_rows (:62-65). The rounding points are that body's:
//   - q and k rows widened to fp32 and quantized per row: amax over the 64
//     values, inv = amax > 0 ? 127/amax : 1 (one IEEE division), codes
//     clip(rint(v * inv), +-127), scale amax/127;
//   - s = float(s32) * (sq[i] * sk[j]): the two scales multiplied first,
//     each product a separate fp32 rounding;
//   - key columns past L masked before the row max; e = exp(s - m) in fp32,
//     denom the fp32 sum of the unrounded e; e8 = rint(e * 127), half to
//     even, no clip (the largest e is 1);
//   - v quantized per column over the L tokens of the (sample, head):
//     vmax[c] = max_j |v[j, c]|, the same inv rule, codes clipped to +-127;
//   - o = float(o32) * ((vmax[c] / 127) / 127), then / denom, one rounding
//     to bf16.
// int32 sums are exact in any order, so the kernel and its plain version
// differ only through expf against torch.exp, the order of the fp32 sum of
// e, and an e code flipping by one at a rounding boundary.
//
// Bound: 4*L*L*Dh int8 operations per (sample, head) against 8*L*Dh bytes,
// as the bf16 form: bytes at the roofline. On the card such a small kernel
// pays for its instructions and for latency with few warps resident. The
// first design kept each warp's fp32 score rows in shared memory (~143 KB a
// block at L = 257: one block of 4 warps an SM) and quantized k and v again
// for every 64-row query tile. This one has the shape of the bf16 core
// (attn_core.cuh, attn_tiles.cuh):
//   - one block a (sample, head), its 4 warps walking the 16-row query
//     tiles; a head is split over more blocks only while the heads alone do
//     not fill the card (head_splits);
//   - k and v are quantized once a block, read straight from device memory
//     into registers (8 lanes a row, 16 bytes a lane): k per row into codes
//     and sk; v per column, its maxima reduced over the rows by shuffles and
//     across the warps through shared memory, then its codes staged as v^T.
//     Shared memory then holds only int8 codes and their scales (43,584
//     bytes at L = 272), so the registers, not the shared memory, set the
//     blocks an SM: three of 4 warps (kI8BlocksPerSm, 168 registers);
//   - each warp quantizes its 16 q rows in registers (the four lanes of a
//     row hold its 64 values as the A fragments of mma.sync m16n8k32 s8 and
//     reduce the amax by two shuffles) and forms its scores tile by tile of
//     8 keys in registers, dequantized as float(s32) * (sq[i] * sk[j]), in
//     two passes: the first keeps only the row maxima; the second forms each
//     tile again, takes e, adds it to the fp32 row sums and packs
//     e8 = rint(e * 127) straight into the A fragment of the value product,
//     whose k32 step runs as soon as its 32 keys are packed. Holding all the
//     score tiles between the max and e, as the bf16 core does, takes 136
//     registers at L = 272: that form ran at 255 registers with spills, two
//     blocks an SM. Forming the scores twice costs two int8 products a tile
//     and no rounding: both passes form each tile with the same operations.
//     No score, no e and no output tile is ever in shared memory;
//   - the int32 accumulator layout is not the int8 A layout: thread (g, tg)
//     holds keys 2tg, 2tg+1 of each 8-key tile, where a k32 A fragment
//     wants k = 4tg..4tg+3 and 16+4tg..16+4tg+3. So v^T's tokens are staged
//     in the matching order inside each 32-token block: position 4tg+i holds
//     token (2tg, 2tg+1, 8+2tg, 9+2tg)[i] and position 16+4tg+i token
//     (16+2tg, 17+2tg, 24+2tg, 25+2tg)[i] (token_pos). Since the int32 sums
//     are exact in any order, this changes no bit of the result; the last
//     16 keys of a class (kTiles % 4 == 2) go through m16n8k16 s8, whose A
//     fragment is the first half of that order;
//   - k codes and v^T codes reach the B fragments by ldmatrix, 16 bytes a
//     row, from rows padded so that the eight rows of a matrix fall into
//     eight bank groups; the output leaves as 16-byte stores after a
//     four-lane exchange (store_row64).
// Rows past L: zero codes and scale 0 for k, zero codes for v^T, masked
// score columns, and query rows past L are never written.
#pragma once

#include "attn_tiles.cuh"
#include "common.cuh"
#include "quant.cuh"

namespace duodiff {
namespace {

constexpr int kI8Dh = 64;                  // head width the core takes
constexpr int kI8AttnWarps = 4;            // 16 query rows each, per trip
constexpr int kI8BlocksPerSm = 3;          // what the register cap is set for
constexpr int kI8CodePitch = kI8Dh + 16;   // bytes a k code row: 20 words, conflict-free ldmatrix

// c (+)= a b, int8 in, int32 sums: m16n8k32 (A 4 registers, B 2) and
// m16n8k16 (A 2, B 1).
__device__ __forceinline__ void mma_s8_16832(int c[4], const unsigned a[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16816(int c[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Where token t of a 32-token block of v^T is staged (see the note above):
// the inverse of position 4tg+i -> token (2tg, 2tg+1, 8+2tg, 9+2tg)[i] in
// each half of 16.
__device__ __forceinline__ int token_pos(int t) {
  const int u = t & 15;
  return (t & 16) + 4 * ((u & 7) >> 1) + ((u >> 3) << 1) + (u & 1);
}

// Four int8 codes, the first in the low byte.
__device__ __forceinline__ unsigned pack_s8x4(int c0, int c1, int c2, int c3) {
  return (c0 & 0xff) | ((c1 & 0xff) << 8) | ((c2 & 0xff) << 16) |
         (static_cast<unsigned>(c3) << 24);
}

// Two fp32 of shared memory, read where the code stands: ptxas hoists plain
// loads of many tiles' key scales up front, into registers the score
// passes need.
__device__ __forceinline__ float2 lds_f32x2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// e8 = rint(e * 127), e in [0, 1].
__device__ __forceinline__ int e_code(float e) { return __float2int_rn(__fmul_rn(e, 127.f)); }

// The block's shared memory for a class of lengths: k codes (kKeys rows of
// kI8CodePitch bytes), v^T codes (64 rows of kKeys + 32 bytes: 16 mod 32, so
// that eight rows fall into eight bank groups), sk (kKeys), the v scales
// (64) and the warps' partial v maxima (4 x 64).
template <typename Seq>
struct Int8Smem {
  static constexpr int kVtPitch = Seq::kKeys + 32;
  static constexpr size_t kK = static_cast<size_t>(Seq::kKeys) * kI8CodePitch;
  static constexpr size_t kVt = static_cast<size_t>(kI8Dh) * kVtPitch;
  static constexpr size_t kSk = kK + kVt;
  static constexpr size_t kVscale = kSk + Seq::kKeys * sizeof(float);
  static constexpr size_t kVpart = kVscale + kI8Dh * sizeof(float);
  static constexpr size_t kBytes = kVpart + kI8AttnWarps * kI8Dh * sizeof(float);
};

template <typename Seq>
__global__ void __launch_bounds__(kI8AttnWarps * 32, kI8BlocksPerSm)
attn_core_int8_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                      HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L) {
  using Sm = Int8Smem<Seq>;
  constexpr int kTiles = Seq::kTiles;
  constexpr int kRowsPerLane = Seq::kKeys / (4 * kI8AttnWarps);  // staged rows a lane
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* K8s = reinterpret_cast<int8_t*>(smem);
  int8_t* Vt8s = reinterpret_cast<int8_t*>(smem + Sm::kK);
  float* sk = reinterpret_cast<float*>(smem + Sm::kSk);
  float* vscale = reinterpret_cast<float*>(smem + Sm::kVscale);
  float* vpart = reinterpret_cast<float*>(smem + Sm::kVpart);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // k, then v: lane (sub, chunk) takes columns 8 chunk .. + 7 of rows
  // 16 i + 4 warp + sub, all loads of a tensor in flight before the first
  // is used, one tensor at a time (rows past L read as zeros)
  const int sub = lane >> 3, chunk = lane & 7;
  const auto load_rows = [&](const HeadRows<const bf16>& rows, uint4 (&raw)[kRowsPerLane]) {
    const bf16* base = rows.at(b, h) + chunk * kVec;
    // a compiler barrier: loads of v hoisted above k's codes would hold the
    // raw rows of both in registers at once
    asm volatile("" ::: "memory");
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int j = 16 * i + 4 * warp + sub;
      raw[i] = j < L ? *reinterpret_cast<const uint4*>(base + j * rows.row) : zero;
    }
  };
  {
    // k: per-row codes and scales (rows past L: codes 0, scale 0)
    uint4 raw[kRowsPerLane];
    load_rows(k_rows, raw);
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int j = 16 * i + 4 * warp + sub;
      float v[kVec];
      unpack8(raw[i], v);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(v[e]));
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      store8_int8(K8s + j * kI8CodePitch + chunk * kVec, v, inv_scale(amax));
      if (chunk == 0) sk[j] = __fdiv_rn(amax, 127.f);
    }
  }
  {
    // v: the column maxima over the rows, lanes of one chunk by shuffles,
    // warps through shared memory
    uint4 raw[kRowsPerLane];
    load_rows(v_rows, raw);
    float vmax[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) vmax[e] = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      float v[kVec];
      unpack8(raw[i], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) vmax[e] = fmaxf(vmax[e], fabsf(v[e]));
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      vmax[e] = fmaxf(vmax[e], __shfl_xor_sync(0xffffffffu, vmax[e], 8));
      vmax[e] = fmaxf(vmax[e], __shfl_xor_sync(0xffffffffu, vmax[e], 16));
    }
    if (sub == 0) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vpart[warp * kI8Dh + chunk * kVec + e] = vmax[e];
    }
    __syncthreads();
    float vinv[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float m = vpart[chunk * kVec + e];
#pragma unroll
      for (int w = 1; w < kI8AttnWarps; ++w) m = fmaxf(m, vpart[w * kI8Dh + chunk * kVec + e]);
      vinv[e] = inv_scale(m);
      if (warp == 0 && sub == 0) vscale[chunk * kVec + e] = __fdiv_rn(__fdiv_rn(m, 127.f), 127.f);
    }
    // v^T codes: column c's row holds the tokens in token_pos order (zero
    // past L, as the zero rows loaded there quantize to 0)
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      const int j = 16 * i + 4 * warp + sub;
      const int pos = (j & ~31) + token_pos(j & 31);
      float v[kVec];
      unpack8(raw[i], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        Vt8s[(chunk * kVec + e) * Sm::kVtPitch + pos] = quant_int8(v[e], vinv[e]);
    }
  }
  __syncthreads();  // the one barrier after the staging: the warps are independent below

  const int g = lane >> 2, tg = lane & 3;
  const unsigned k_stage = static_cast<unsigned>(__cvta_generic_to_shared(K8s));
  const unsigned v_stage = static_cast<unsigned>(__cvta_generic_to_shared(Vt8s));
  // ldmatrix rows: lane l gives row l % 8 of matrix l / 8
  const unsigned k_off = k_stage + (lane & 7) * kI8CodePitch + (lane >> 3) * 16;
  const unsigned v_off = v_stage + (lane & 7) * Sm::kVtPitch;
  const bf16* qb = q_rows.at(b, h);
  const int tiles = (L + 15) / 16;
  for (int t = blockIdx.x * kI8AttnWarps + warp; t < tiles; t += gridDim.x * kI8AttnWarps) {
    const int q0 = 16 * t;
    // q: thread (g, tg) loads columns 16 c + 4 tg .. + 3, c = 0..3, of rows
    // g and g + 8, exactly its A fragments of the two k32 steps
    unsigned qa[2][4];
    float sq[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + g + 8 * half;
      const bool ok = r < L;
      const bf16* qr = qb + (ok ? r : 0) * q_rows.row + 4 * tg;
      float v[4][4];
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint2 raw = ok ? *reinterpret_cast<const uint2*>(qr + 16 * c) : make_uint2(0u, 0u);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        v[c][0] = __low2float(lo);
        v[c][1] = __high2float(lo);
        v[c][2] = __low2float(hi);
        v[c][3] = __high2float(hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[c][e]));
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      const float inv = inv_scale(amax);
      sq[half] = __fdiv_rn(amax, 127.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // c = 0, 1: step 0's a[half], a[2 + half]; c = 2, 3: step 1's
        qa[c >> 1][(c & 1) * 2 + half] =
            pack_s8x4(quant_int8(v[c][0], inv), quant_int8(v[c][1], inv),
                      quant_int8(v[c][2], inv), quant_int8(v[c][3], inv));
      }
    }

    // s = float(q8 k8^T) * (sq x sk) of tile nt (keys 8nt..8nt+7), keys
    // past L at -inf. The two passes below form each tile with the same
    // operations, so they agree to the bit: the first takes the row maxima,
    // the second e, its fp32 sums and its codes. Forming the scores twice
    // costs two int8 products a tile; holding them all between the passes
    // would take 4 kTiles registers (136 at L = 272).
    const float neg_inf = __uint_as_float(0xff800000u);
    const int left = L - 2 * tg;  // key 8nt + 2tg (+ 1) is past L iff 8nt (+ 1) >= left
    const auto score_tile = [&](int nt, float (&st)[4]) {
      unsigned f[4];
      ldmatrix_x4(f, k_off + nt * 8 * kI8CodePitch);
      int c[4] = {0, 0, 0, 0};
      mma_s8_16832(c, qa[0], f[0], f[1]);
      mma_s8_16832(c, qa[1], f[2], f[3]);
      const float2 k2 = lds_f32x2(sk + nt * 8 + 2 * tg);
      st[0] = __fmul_rn(__int2float_rn(c[0]), __fmul_rn(sq[0], k2.x));
      st[1] = __fmul_rn(__int2float_rn(c[1]), __fmul_rn(sq[0], k2.y));
      st[2] = __fmul_rn(__int2float_rn(c[2]), __fmul_rn(sq[1], k2.x));
      st[3] = __fmul_rn(__int2float_rn(c[3]), __fmul_rn(sq[1], k2.y));
      if (nt >= Seq::kMaskFrom) {
        if (nt * 8 >= left) st[0] = st[2] = neg_inf;
        if (nt * 8 + 1 >= left) st[1] = st[3] = neg_inf;
      }
    };
    // the row maxima of rows g (lo) and g + 8 (hi) over the quad
    float m_lo = neg_inf, m_hi = neg_inf;
#pragma unroll 2
    for (int nt = 0; nt < kTiles; ++nt) {
      float st[4];
      score_tile(nt, st);
      m_lo = fmaxf(m_lo, fmaxf(st[0], st[1]));
      m_hi = fmaxf(m_hi, fmaxf(st[2], st[3]));
    }
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));

    // e = exp(s - m) of tiles nt, nt + 1, added to the fp32 sums in tile
    // order and packed as e8 codes: a[0] row g, a[1] row g + 8, keys 2tg,
    // 2tg + 1, 8 + 2tg, 9 + 2tg of the 16, the order of an A fragment
    float sum_lo = 0.f, sum_hi = 0.f;
    const auto e_codes = [&](int nt, unsigned (&a)[2]) {
      float e[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float st[4];
        score_tile(nt + t, st);
        e[t][0] = expf(st[0] - m_lo);
        e[t][1] = expf(st[1] - m_lo);
        e[t][2] = expf(st[2] - m_hi);
        e[t][3] = expf(st[3] - m_hi);
        sum_lo += e[t][0] + e[t][1];
        sum_hi += e[t][2] + e[t][3];
      }
      a[0] = pack_s8x4(e_code(e[0][0]), e_code(e[0][1]), e_code(e[1][0]), e_code(e[1][1]));
      a[1] = pack_s8x4(e_code(e[0][2]), e_code(e[0][3]), e_code(e[1][2]), e_code(e[1][3]));
    };
    // o32 = e8 v8, 32 keys a step as their codes are formed: tiles 4kk ..
    // 4kk + 3 are the A fragment of k32 step kk, against v^T staged in
    // token_pos order; no e code outlives its step
    int o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0;
#pragma unroll 1
    for (int kk = 0; kk < kTiles / 4; ++kk) {
      unsigned lo[2], hi[2];
      e_codes(4 * kk, lo);
      e_codes(4 * kk + 2, hi);
      const unsigned a[4] = {lo[0], lo[1], hi[0], hi[1]};
      // matrices: (columns 8n.., tokens +0..15), (8n.., +16..31), then n + 1
      const unsigned at = v_off + 32 * kk + ((lane >> 3) & 1) * 16 + (lane >> 4) * 8 * Sm::kVtPitch;
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned f[4];
        ldmatrix_x4(f, at + n * 8 * Sm::kVtPitch);
        mma_s8_16832(o[n], a, f[0], f[1]);
        mma_s8_16832(o[n + 1], a, f[2], f[3]);
      }
    }
    if constexpr (kTiles % 4 == 2) {  // the last 16 keys: m16n8k16
      constexpr int kt = kTiles / 4;
      unsigned a[2];
      e_codes(4 * kt, a);
      // matrices: columns 8n.., 8(n+1).., 8(n+2).., 8(n+3).., tokens +0..15
      const unsigned at = v_off + 32 * kt + (lane >> 3) * 8 * Sm::kVtPitch;
#pragma unroll
      for (int n = 0; n < 8; n += 4) {
        unsigned f[4];
        ldmatrix_x4(f, at + n * 8 * Sm::kVtPitch);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16816(o[n + j], a[0], a[1], f[j]);
      }
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);

    // o = float(o32) * vscale[c] / denom, rounded to bf16: o[n][0..1] are
    // row g, columns 8n + 2tg, + 1; o[n][2..3] the same columns of row g + 8
    unsigned w_lo[8], w_hi[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 vs = *reinterpret_cast<const float2*>(vscale + 8 * n + 2 * tg);
      w_lo[n] = pack_bf16x2(__fdiv_rn(__fmul_rn(__int2float_rn(o[n][0]), vs.x), sum_lo),
                            __fdiv_rn(__fmul_rn(__int2float_rn(o[n][1]), vs.y), sum_lo));
      w_hi[n] = pack_bf16x2(__fdiv_rn(__fmul_rn(__int2float_rn(o[n][2]), vs.x), sum_hi),
                            __fdiv_rn(__fmul_rn(__int2float_rn(o[n][3]), vs.y), sum_hi));
    }
    bf16* ob = out.at(b, h);
    store_row64(ob + static_cast<size_t>(q0 + g) * out.row, w_lo, tg, q0 + g < L);
    store_row64(ob + static_cast<size_t>(q0 + g + 8) * out.row, w_hi, tg, q0 + g + 8 < L);
  }
}

// Dynamic shared memory of a block at length L (0 past kMaxSeq).
inline int attn_core_int8_smem_bytes(int L) {
  if (L < 1 || L > kMaxSeq) return 0;
  return with_seq_class(L, [](auto seq) {
    return static_cast<int>(Int8Smem<decltype(seq)>::kBytes);
  });
}

// Resident blocks an SM at length L, by registers and shared memory, as the
// runtime reckons them (0 on an error).
inline int attn_core_int8_blocks_per_sm(int L) {
  if (L < 1 || L > kMaxSeq) return 0;
  return with_seq_class(L, [](auto seq) {
    using Seq = decltype(seq);
    constexpr size_t smem = Int8Smem<Seq>::kBytes;
    int blocks = 0;
    if (cudaFuncSetAttribute(attn_core_int8_kernel<Seq>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, attn_core_int8_kernel<Seq>,
                                                      kI8AttnWarps * 32, smem) != cudaSuccess)
      return 0;
    return blocks;
  });
}

inline cudaError_t launch_attn_core_int8(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                         HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L,
                                         int H, cudaStream_t stream) {
  if (L < 1 || L > kMaxSeq) return cudaErrorInvalidValue;
  return with_seq_class(L, [&](auto seq) {
    using Seq = decltype(seq);
    constexpr size_t smem = Int8Smem<Seq>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(attn_core_int8_kernel<Seq>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // one block a head when the heads alone fill the card once over: a split
    // head quantizes its k and v once a block
    const dim3 grid(head_splits(B * H, L, kI8AttnWarps, kSmCount * kI8BlocksPerSm), H, B);
    attn_core_int8_kernel<Seq><<<grid, kI8AttnWarps * 32, smem, stream>>>(q, k, v, out, L);
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace duodiff
