// Tiled int8 GEMM on the tensor cores with an fp32 dequant epilogue, the
// four W8A8 projections of K11 (qkv, proj) and K12 (fc1, fc2):
//
//   acc[m, n] = sum_k A[m, k] * B[n, k]                    int32, exact
//   v = float(acc) * (row_scale[m] * col_scale[n])         (row_scale null:
//                                                           col_scale[n] only)
// then, by epilogue mode:
//   kEpiBias       C bf16 = bf16(v + bias?)                   qkv
//   kEpiResidual   C bf16 = bf16((residual + v) + bias)       proj, fc2
//   kEpiGeluF32    C fp32 = gelu(v + bias)                    fc1, dynamic scales
//   kEpiGeluQuant  C int8 = clip(rint(gelu(v + bias) * inv))  fc1, static scales
//
// Replaces: the _dot_int8 products and their dequant lines in
// duodiff_tpu/ops/pallas_block_int8.py _kernel_v2_int8 (qkv :124-128,
// proj :148-152) and _mlp_kernel_int8 (fc1 :188-192, fc2 :195-201). The
// epilogue keeps their order and rounding: the (row x col) scale product
// first, then the multiply, then the bias; the residual before the bias;
// every step a separate fp32 rounding (__fmul_rn/__fadd_rn, no FMA
// contraction), one rounding to the output type at the end.
//
// Operands: A (M, K) int8 row-major (activation codes), B (N, K) int8
// row-major, the torch Linear layout, which is the "col" operand of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. M = B*257 is ragged: rows past
// M are zero-filled by cp.async's src-size operand and never stored.
// Needs K % 16 == 0 (16-byte chunks) and N % 8 == 0.
//
// Bound: at the sampling shapes (M = B*257, K in {512, 2048}) these GEMMs
// are ~92% of a block's operations, so tensor-core throughput bounds them;
// int8 halves the operand bytes of the bf16 GEMM. Design (simple first,
// wgmma/TMA later): 128x128 block tile with a 64-byte K slab, 8 warps each
// owning a 64x32 tile of 4x4 m16n8k32 fragments with int32 accumulators in
// registers, a two-stage cp.async pipeline, rows padded to 80 bytes so the
// 32-bit fragment loads from shared memory are free of bank conflicts.
#pragma once

#include "common.cuh"
#include "quant.cuh"

namespace duodiff {
namespace {

enum Int8Epilogue : int { kEpiBias = 0, kEpiResidual = 1, kEpiGeluF32 = 2, kEpiGeluQuant = 3 };

struct Int8GemmArgs {
  int mode;                // Int8Epilogue
  int gelu_mode;           // GeluMode, for kEpiGelu*
  const float* row_scale;  // (M,) or null (static scales folded into col_scale)
  const float* col_scale;  // (N,)
  const float* bias;       // (N,) or null
  const bf16* residual;    // (M, N), kEpiResidual
  const float* quant_inv;  // quant_inv[0], kEpiGeluQuant
  void* out;               // (M, N): bf16, fp32 or int8 by mode
};

constexpr int kI8BM = 128;
constexpr int kI8BN = 128;
constexpr int kI8BK = 64;             // int8 values (bytes) of K per stage
constexpr int kI8Threads = 256;
constexpr int kI8Pitch = kI8BK + 16;  // bytes per staged row

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

__global__ void __launch_bounds__(kI8Threads)
gemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N,
                 int K, Int8GemmArgs ep) {
  __shared__ __align__(128) int8_t As[2][kI8BM * kI8Pitch];
  __shared__ __align__(128) int8_t Bs[2][kI8BN * kI8Pitch];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2;  // 2 warp rows of 64
  const int wn = warp & 3;   // 4 warp columns of 32
  const int g = lane >> 2;   // mma group: fragment row (A), column (B, C)
  const int tg = lane & 3;   // thread in group
  const int m0 = blockIdx.y * kI8BM;
  const int n0 = blockIdx.x * kI8BN;

  auto load_tile = [&](int stage, int k0) {
    constexpr int kChunks = kI8BK / 16;  // 16-byte chunks per row
    for (int c = tid; c < kI8BM * kChunks; c += kI8Threads) {
      const int r = c / kChunks, col = (c % kChunks) * 16;
      const bool ok = m0 + r < M && k0 + col < K;
      const int8_t* src = ok ? A + static_cast<size_t>(m0 + r) * K + k0 + col : A;
      cp_async16(&As[stage][r * kI8Pitch + col], src, ok);
    }
    for (int c = tid; c < kI8BN * kChunks; c += kI8Threads) {
      const int r = c / kChunks, col = (c % kChunks) * 16;
      const bool ok = n0 + r < N && k0 + col < K;
      const int8_t* src = ok ? B + static_cast<size_t>(n0 + r) * K + k0 + col : B;
      cp_async16(&Bs[stage][r * kI8Pitch + col], src, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int num_k = (K + kI8BK - 1) / kI8BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < num_k) {
      load_tile(st ^ 1, (kt + 1) * kI8BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kI8BK; kk += 32) {
      // A fragment (16 x 32): rows g, g+8; bytes tg*4.. and 16 + tg*4..
      // B fragment (32 x 8): column g; bytes tg*4.. and 16 + tg*4..
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = &As[st][(wm * 64 + i * 16 + g) * kI8Pitch + kk + tg * 4];
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kI8Pitch);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kI8Pitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = &Bs[st][(wn * 32 + j * 8 + g) * kI8Pitch + kk + tg * 4];
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the next iteration overwrites the other stage
  }

  // Epilogue straight from the accumulators: c[0..1] are row g, columns
  // tg*2 and tg*2+1 of the fragment; c[2..3] the same columns of row g+8.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + i * 16 + g + half * 8;
      if (r >= M) continue;
      const float rs = ep.row_scale != nullptr ? ep.row_scale[r] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + tg * 2;
        if (c >= N) continue;  // N % 8 == 0: both columns are in or out
        const size_t off = static_cast<size_t>(r) * N + c;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = ep.row_scale != nullptr ? __fmul_rn(rs, ep.col_scale[c + e])
                                                  : ep.col_scale[c + e];
          v[e] = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), s);
        }
        if (ep.mode == kEpiResidual) {
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(ep.residual + off);
          v[0] = __fadd_rn(__fadd_rn(__low2float(res), v[0]), ep.bias[c]);
          v[1] = __fadd_rn(__fadd_rn(__high2float(res), v[1]), ep.bias[c + 1]);
        } else if (ep.bias != nullptr) {
          v[0] = __fadd_rn(v[0], ep.bias[c]);
          v[1] = __fadd_rn(v[1], ep.bias[c + 1]);
        }
        if (ep.mode == kEpiBias || ep.mode == kEpiResidual) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + off) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else if (ep.mode == kEpiGeluF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + off) =
              make_float2(gelu(v[0], ep.gelu_mode), gelu(v[1], ep.gelu_mode));
        } else {  // kEpiGeluQuant
          const float inv = ep.quant_inv[0];
          char2 q;
          q.x = quant_int8(gelu(v[0], ep.gelu_mode), inv);
          q.y = quant_int8(gelu(v[1], ep.gelu_mode), inv);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(ep.out) + off) = q;
        }
      }
    }
  }
}

inline cudaError_t launch_gemm_int8(const int8_t* A, const int8_t* B, int M, int N, int K,
                                    const Int8GemmArgs& ep, cudaStream_t stream) {
  const dim3 grid((N + kI8BN - 1) / kI8BN, (M + kI8BM - 1) / kI8BM);
  gemm_int8_kernel<<<grid, kI8Threads, 0, stream>>>(A, B, M, N, K, ep);
  return cudaGetLastError();
}

}  // namespace
}  // namespace duodiff
