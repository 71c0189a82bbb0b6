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
// One block per (query tile of 64 rows, head, sample), 4 warps of 16 query
// rows each, with the score rows in shared memory (the bf16 core,
// attn_core.cuh, keeps its own in registers):
//   - the head's k and v rows are copied once into shared memory as they
//     come (bf16, in the area the warps' score rows take later), so that the
//     quantization passes below never wait for device memory;
//   - k's rows are quantized once per block (8 lanes a row), not once per
//     warp;
//   - v's column maxima are reduced over the L rows by the whole block, then
//     the codes are staged transposed, v^T (64 x Lpad) with Lpad = L rounded
//     up to 32 and the tail zero: the instruction's second operand wants K
//     contiguous, and K is the token axis in the value product;
//   - each warp quantizes its 16 q rows, takes s with mma.sync m16n8k32
//     (two k32 steps), writes the dequantized fp32 scores to shared memory,
//     runs a two-pass softmax over those stored rows, and stores the
//     e codes (a quarter of the bf16 probabilities' bytes);
//   - o32 = e8 v8 with Lpad / 32 k32 steps into 8 column tiles of int32
//     accumulators in registers; the epilogue writes bf16 pairs.
// Rows past L: zero codes and scale 0 for k, zero codes for v^T, masked
// score columns, and query rows past L are never written.
//
// Bound: 4*L*L*Dh int8 operations per (sample, head) against 8*L*Dh bytes,
// as the bf16 form: bytes at the roofline. This simple core is bound by
// shared-memory traffic and occupancy instead: ~143 KB of shared memory at
// L = 257 (the fp32 score rows are 74 KB of it), one block an SM, and every
// query tile of a head requantizes that head's k and v (5 times at L = 257).
// Scores in registers and k, v quantized once per head are later work.
#pragma once

#include "common.cuh"
#include "quant.cuh"

namespace duodiff {
namespace {

__device__ __forceinline__ void mma_s8_16832(int c[4], const unsigned a[4], const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

constexpr int kI8Dh = 64;                     // head width the core takes
constexpr int kI8AttnWarps = 4;               // 16 query rows each
constexpr int kI8QRows = 16 * kI8AttnWarps;   // query rows per block
constexpr int kI8CodePitch = kI8Dh + 16;      // bytes per staged q / k code row

struct AttnInt8Smem {
  int lpad;            // L rounded up to 32: the K of the value product
  int s_pitch;         // fp32 per score row
  int e_pitch;         // bytes per e-code row and per v^T code row
  size_t k_bytes;      // k codes (lpad x kI8CodePitch)
  size_t vt_bytes;     // v^T codes (Dh x e_pitch)
  size_t stat_bytes;   // sk (lpad), v partial maxima (warps x Dh), vinv, vscale (Dh each)
  size_t q_bytes;      // per warp: q codes
  size_t s_bytes;      // per warp: fp32 scores
  size_t e_bytes;      // per warp: e codes
  size_t row_bytes;    // per warp: sq and denom (16 each)
  size_t total;
};

__host__ __device__ inline AttnInt8Smem attn_int8_smem(int L) {
  AttnInt8Smem m;
  m.lpad = (L + 31) / 32 * 32;
  m.s_pitch = m.lpad + 8;
  m.e_pitch = m.lpad + 16;
  m.k_bytes = static_cast<size_t>(m.lpad) * kI8CodePitch;
  m.vt_bytes = static_cast<size_t>(kI8Dh) * m.e_pitch;
  m.stat_bytes = (m.lpad + (kI8AttnWarps + 2) * kI8Dh) * sizeof(float);
  m.q_bytes = 16 * kI8CodePitch;
  m.s_bytes = static_cast<size_t>(16) * m.s_pitch * sizeof(float);
  m.e_bytes = static_cast<size_t>(16) * m.e_pitch;
  m.row_bytes = 32 * sizeof(float);
  m.total = m.k_bytes + m.vt_bytes + m.stat_bytes +
            kI8AttnWarps * (m.q_bytes + m.s_bytes + m.e_bytes + m.row_bytes);
  return m;
}

// Eight lanes quantize one row of 64 values (lane `chunk` of the eight holds
// values chunk*8 .. chunk*8+7 in v) into 64 int8 codes at dst; returns the
// row's scale amax/127. All 32 lanes of the warp must call it together: the
// amax is reduced by shuffles within each group of eight.
__device__ __forceinline__ float quant_row64(const float v[kVec], int chunk, int8_t* dst) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(v[e]));
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  store8_int8(dst + chunk * kVec, v, inv_scale(amax));
  return __fdiv_rn(amax, 127.f);
}

__global__ void __launch_bounds__(kI8AttnWarps * 32)
attn_core_int8_kernel(HeadRows<const bf16> q_rows, HeadRows<const bf16> k_rows,
                      HeadRows<const bf16> v_rows, HeadRows<bf16> out, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnInt8Smem sm = attn_int8_smem(L);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int8_t* K8s = reinterpret_cast<int8_t*>(smem);
  int8_t* Vt8s = K8s + sm.k_bytes;
  float* sk = reinterpret_cast<float*>(smem + sm.k_bytes + sm.vt_bytes);
  float* vpart = sk + sm.lpad;
  float* vinv = vpart + kI8AttnWarps * kI8Dh;
  float* vscale = vinv + kI8Dh;
  unsigned char* warps = smem + sm.k_bytes + sm.vt_bytes + sm.stat_bytes;
  unsigned char* mine = warps + warp * (sm.q_bytes + sm.s_bytes + sm.e_bytes + sm.row_bytes);
  int8_t* Q8s = reinterpret_cast<int8_t*>(mine);
  float* Ss = reinterpret_cast<float*>(mine + sm.q_bytes);
  int8_t* E8s = reinterpret_cast<int8_t*>(mine + sm.q_bytes + sm.s_bytes);
  float* sq = reinterpret_cast<float*>(mine + sm.q_bytes + sm.s_bytes + sm.e_bytes);
  float* denom = sq + 16;
  // Until the warps start on their own rows, their area holds the head's k
  // and v rows as they come, bf16 (2 * L * 128 bytes, less than the area for
  // any L), so that the quantization passes read shared memory and only this
  // one copy waits for device memory.
  bf16* Kst = reinterpret_cast<bf16*>(warps);
  bf16* Vst = Kst + static_cast<size_t>(L) * kI8Dh;

  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* qb = q_rows.at(b, h);
  const bf16* kb = k_rows.at(b, h);
  const bf16* vb = v_rows.at(b, h);
  const int sub = lane >> 3, chunk = lane & 7;  // 4 rows a warp trip, 8 lanes a row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // this warp's 16 q rows, kept in registers until its code rows are free
  const int q0 = blockIdx.x * kI8QRows + warp * 16;
  uint4 qraw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + i * 4 + sub;
    qraw[i] = r < L ? *reinterpret_cast<const uint4*>(qb + r * q_rows.row + chunk * kVec) : zero;
  }
  for (int c = tid; c < L * (kI8Dh / kVec); c += blockDim.x) {
    const int j = c / (kI8Dh / kVec), col = (c % (kI8Dh / kVec)) * kVec;
    *reinterpret_cast<uint4*>(Kst + j * kI8Dh + col) =
        *reinterpret_cast<const uint4*>(kb + j * k_rows.row + col);
    *reinterpret_cast<uint4*>(Vst + j * kI8Dh + col) =
        *reinterpret_cast<const uint4*>(vb + j * v_rows.row + col);
  }
  __syncthreads();

  // k: per-row codes and scales, once per block (lpad is a multiple of 16;
  // rows past L are rows of zeros)
  for (int j0 = warp * 4; j0 < sm.lpad; j0 += kI8AttnWarps * 4) {
    const int j = j0 + sub;
    float v[kVec];
    unpack8(j < L ? *reinterpret_cast<const uint4*>(Kst + j * kI8Dh + chunk * kVec) : zero, v);
    const float s = quant_row64(v, chunk, K8s + j * kI8CodePitch);
    if (chunk == 0) sk[j] = s;
  }

  // v: column maxima over the L tokens; lane owns columns 2*lane, 2*lane+1,
  // warp w the rows w, w + 4, ...
  {
    float a0 = 0.f, a1 = 0.f;
    for (int j = warp; j < L; j += kI8AttnWarps) {
      const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(Vst + j * kI8Dh + 2 * lane);
      a0 = fmaxf(a0, fabsf(__low2float(t)));
      a1 = fmaxf(a1, fabsf(__high2float(t)));
    }
    vpart[warp * kI8Dh + 2 * lane] = a0;
    vpart[warp * kI8Dh + 2 * lane + 1] = a1;
  }
  __syncthreads();
  if (tid < kI8Dh) {
    float vmax = 0.f;
#pragma unroll
    for (int w = 0; w < kI8AttnWarps; ++w) vmax = fmaxf(vmax, vpart[w * kI8Dh + tid]);
    vinv[tid] = inv_scale(vmax);
    vscale[tid] = __fdiv_rn(__fdiv_rn(vmax, 127.f), 127.f);
  }
  __syncthreads();
  // v^T codes, the token axis contiguous and zero past L
  {
    const float i0 = vinv[2 * lane], i1 = vinv[2 * lane + 1];
    for (int j = warp; j < sm.lpad; j += kI8AttnWarps) {
      int8_t c0 = 0, c1 = 0;
      if (j < L) {
        const __nv_bfloat162 t =
            *reinterpret_cast<const __nv_bfloat162*>(Vst + j * kI8Dh + 2 * lane);
        c0 = quant_int8(__low2float(t), i0);
        c1 = quant_int8(__high2float(t), i1);
      }
      Vt8s[(2 * lane) * sm.e_pitch + j] = c0;
      Vt8s[(2 * lane + 1) * sm.e_pitch + j] = c1;
    }
  }
  __syncthreads();  // the last block-wide barrier: the staged rows are dead,
                    // and the warps are independent below
  if (q0 >= L) return;

  // q: this warp's 16 rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 4 + sub;
    float v[kVec];
    unpack8(qraw[i], v);
    const float s = quant_row64(v, chunk, Q8s + r * kI8CodePitch);
    if (chunk == 0) sq[r] = s;
  }
  __syncwarp();

  // scores s = float(q8 k8^T) * (sq x sk), (16 x lpad) fp32
  const int g = lane >> 2;   // mma group: fragment row (A), column (B, C)
  const int tg = lane & 3;   // thread in group
  unsigned qa[kI8Dh / 32][4];
#pragma unroll
  for (int kk = 0; kk < kI8Dh / 32; ++kk) {
    const int8_t* p = Q8s + g * kI8CodePitch + kk * 32 + tg * 4;
    qa[kk][0] = lds32(p);
    qa[kk][1] = lds32(p + 8 * kI8CodePitch);
    qa[kk][2] = lds32(p + 16);
    qa[kk][3] = lds32(p + 8 * kI8CodePitch + 16);
  }
  const float sq0 = sq[g], sq1 = sq[g + 8];
  for (int nt = 0; nt < sm.lpad / 8; ++nt) {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < kI8Dh / 32; ++kk) {
      const int8_t* p = K8s + (nt * 8 + g) * kI8CodePitch + kk * 32 + tg * 4;
      const unsigned kf[2] = {lds32(p), lds32(p + 16)};
      mma_s8_16832(c, qa[kk], kf);
    }
    const int col = nt * 8 + tg * 2;
    const float k0 = sk[col], k1 = sk[col + 1];
    *reinterpret_cast<float2*>(Ss + g * sm.s_pitch + col) =
        make_float2(__fmul_rn(__int2float_rn(c[0]), __fmul_rn(sq0, k0)),
                    __fmul_rn(__int2float_rn(c[1]), __fmul_rn(sq0, k1)));
    *reinterpret_cast<float2*>(Ss + (g + 8) * sm.s_pitch + col) =
        make_float2(__fmul_rn(__int2float_rn(c[2]), __fmul_rn(sq1, k0)),
                    __fmul_rn(__int2float_rn(c[3]), __fmul_rn(sq1, k1)));
  }
  __syncwarp();

  // fp32 softmax numerator, its codes, and the fp32 sum of the unrounded e
  const float neg_inf = __uint_as_float(0xff800000u);
  for (int r = 0; r < 16; ++r) {
    const float* srow = Ss + r * sm.s_pitch;
    int8_t* erow = E8s + r * sm.e_pitch;
    float m = neg_inf;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < sm.lpad; j += 32) {
      const float e = j < L ? expf(srow[j] - m) : 0.f;
      sum += e;
      erow[j] = static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(e, 127.f))));
    }
    sum = warp_sum(sum);
    if (lane == 0) denom[r] = sum;
  }
  __syncwarp();

  // o32 = e8 v8, (16 x 64) int32 in registers
  int o[kI8Dh / 8][4];
#pragma unroll
  for (int n = 0; n < kI8Dh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0;
  for (int kk = 0; kk < sm.lpad; kk += 32) {
    const int8_t* p = E8s + g * sm.e_pitch + kk + tg * 4;
    const unsigned ea[4] = {lds32(p), lds32(p + 8 * sm.e_pitch), lds32(p + 16),
                            lds32(p + 8 * sm.e_pitch + 16)};
#pragma unroll
    for (int n = 0; n < kI8Dh / 8; ++n) {
      const int8_t* pv = Vt8s + (n * 8 + g) * sm.e_pitch + kk + tg * 4;
      const unsigned vf[2] = {lds32(pv), lds32(pv + 16)};
      mma_s8_16832(o[n], ea, vf);
    }
  }

  // o = float(o32) * vscale[c] / denom, rounded to bf16: c[0..1] are row g,
  // columns tg*2 and tg*2+1 of a tile; c[2..3] the same columns of row g+8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + half * 8;
    if (q0 + r >= L) continue;
    const float den = denom[r];
    bf16* dst = out.at(b, h) + (q0 + r) * out.row;
#pragma unroll
    for (int n = 0; n < kI8Dh / 8; ++n) {
      const int col = n * 8 + tg * 2;
      const float v0 = __fdiv_rn(__fmul_rn(__int2float_rn(o[n][half * 2]), vscale[col]), den);
      const float v1 =
          __fdiv_rn(__fmul_rn(__int2float_rn(o[n][half * 2 + 1]), vscale[col + 1]), den);
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

inline cudaError_t launch_attn_core_int8(HeadRows<const bf16> q, HeadRows<const bf16> k,
                                         HeadRows<const bf16> v, HeadRows<bf16> out, int B, int L,
                                         int H, cudaStream_t stream) {
  const size_t smem = attn_int8_smem(L).total;
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kI8QRows - 1) / kI8QRows, H, B);
  attn_core_int8_kernel<<<grid, kI8AttnWarps * 32, smem, stream>>>(q, k, v, out, L);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
