// int8 GEMM on Hopper's tensor cores with an fp32 dequant epilogue, the four
// W8A8 projections of K11 (qkv, proj) and K12 (fc1, fc2), also run by K13
// and K14:
//
//   acc[m, n] = sum_k A[m, k] * B[n, k]                    int32, exact
//   v = float(acc) * (row_scale[m] * col_scale[n])         (row_scale null:
//                                                           col_scale[n] only)
// then, by epilogue mode:
//   kEpiBias       C bf16 = bf16(v + bias?)                   qkv
//   kEpiResidual   C bf16 = bf16((residual + v) + bias?)      proj, fc2
//   kEpiGeluF32    C fp32 = gelu(v + bias?)                   fc1, dynamic scales
//   kEpiGeluQuant  C int8 = clip(rint(gelu(v + bias?) * inv)) fc1, static scales
//
// Replaces: the _dot_int8 products and their dequant lines in
// duodiff_tpu/ops/pallas_block_int8.py _kernel_v2_int8 (qkv :124-128,
// proj :148-152) and _mlp_kernel_int8 (fc1 :186-192, fc2 :195-198). The
// epilogue keeps their order and rounding: the (row x col) scale product
// first, then the multiply, then the bias; the residual before the bias;
// every step a separate fp32 rounding (__fmul_rn/__fadd_rn, no FMA
// contraction), one rounding to the output type at the end. The int32 sums
// are exact in any order, so only those fp32 steps can differ from the plain
// version.
//
// Operands: A (M, K) int8 row-major (activation codes) and B (N, K) int8
// row-major, the torch Linear layout: both K-major, the only layout wgmma
// takes for 8-bit operands, so no weight is repacked. M = B*257 is ragged.
//
// Bound: at the sampling shapes (M = B*257, K in {512, 2048}) these GEMMs
// are ~92% of a block's operations at twice the bf16 tensor-core rate, so
// tensor-core throughput bounds them, and only wgmma reaches it. A 128 x 128
// tile takes 256 bytes from L2 per 2*128*128 operations of each K step: half
// the bf16 tile's intensity per operation at twice the rate. The weights (at
// most 2.4 MB) stay in L2.
// Design: gemm.cuh's, for 8-bit operands. One persistent block an SM walks
// the 128 x 128 output tiles, row of tiles by row of tiles, so the blocks
// running together share the A rows in L2. Five warpgroups, each with one
// job:
// - the producer (one thread issues) keeps a ring of four 128-deep K slabs
//   in flight by TMA with a 128-byte swizzle (one swizzle row is 128 int8
//   values): A and B each as one 128 x 128 box, 16 KB; each stage has a
//   "full" mbarrier (TMA bytes) and an "empty" one (the eight MMA warps);
// - two MMA warpgroups each own 64 rows of the tile and issue wgmma
//   m64n128k32 s8 x s8 -> s32 from shared memory, four a slab, keeping one
//   slab's products in flight while the previous slab is released; at the
//   end of a tile they write the int32 sums to a shared-memory staging tile
//   and go on to the next tile at once;
// - two epilogue warpgroups read the staged tile row by row (8 consecutive
//   values a lane, so the residual, the scales and the bias are read and C
//   is written as whole rows), dequantize, add, apply GELU, quantize or
//   round, while the MMA warpgroups already multiply the next tile. A pair
//   of mbarriers hands the staging tile back and forth.
// At K = 512 a tile's products take about half a bf16 tile's time, so the
// epilogue (fc1's GELU and quant above all) sets the pace: it has the two
// warpgroups to itself, takes registers from the producer (setmaxnreg), and
// keeps the exact erff / tanhf. The register file bounds the design: 640
// threads get 96 registers each, 64 of them an MMA thread's accumulators, so
// neither more epilogue warpgroups nor a 128 x 256 tile (128 accumulators a
// thread) fit beside the MMA warpgroups.
// TMA zero-fills the rows past M and N and the K tail; stores are masked at
// M and N. K % 16 == 0 (the TMA row stride), N % 8 == 0 (N % 16 == 0 for
// int8 output, which a next GEMM takes as its A) and 16-byte aligned
// operands are required, else the launch returns cudaErrorInvalidValue /
// cudaErrorMisalignedAddress and nothing runs. Every mbarrier wait traps
// after 10 s (hopper.cuh).
#pragma once

#include "common.cuh"
#include "hopper.cuh"
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

constexpr int kI8BM = 128;           // two MMA warpgroups of 64 rows
constexpr int kI8BN = 128;
constexpr int kI8BK = 128;           // one 128-byte swizzle row of int8
constexpr int kI8Stages = 4;
constexpr int kI8Threads = 640;      // producer, two MMA and two epilogue warpgroups
constexpr int kI8MmaThreads = 256;
constexpr int kI8EpiThreads = 256;
constexpr int kI8EpiRows = kI8BM * (kI8BN / 8) / kI8EpiThreads;  // 8 rows a lane
constexpr int kI8EpiPre = 4;         // residual rows a lane keeps loaded ahead of their use
// registers a thread after the hand-over (setmaxnreg): the producer gives
// back 56 of the launch's 96 (its one issuing thread needs few), and the
// epilogue takes 24 more for its prefetched rows and scales and for running
// rows' GELU side by side; 256 x 24 <= 128 x 56. The MMA warpgroups keep 96
// (64 of them the accumulators).
constexpr int kI8ProducerRegs = 40;
constexpr int kI8EpilogueRegs = 120;
constexpr int kI8BoxBytes = 128 * 128;                  // one 128 x 128 int8 TMA box
constexpr int kI8StageBytes = 2 * kI8BoxBytes;          // A and B: 32 KB
// int32 words a staged row: 128 + 8 keeps both the fragment writes and the
// row reads free of bank conflicts
constexpr int kI8StagePitch = kI8BN + 8;
constexpr int kI8StagingOffset = kI8Stages * kI8StageBytes;
constexpr int kI8BarOffset = kI8StagingOffset + kI8BM * kI8StagePitch * 4;
// the ring starts on a 1024-byte boundary (the swizzle atom); 2 barriers a
// stage and the staging tile's pair
constexpr int kI8SmemBytes = 1024 + kI8BarOffset + (2 * kI8Stages + 2) * 8;

#define DUODIFF_IACC8(i)                                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),            \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define DUODIFF_IACC32(i) DUODIFF_IACC8(i), DUODIFF_IACC8(i + 8), DUODIFF_IACC8(i + 16), \
                          DUODIFF_IACC8(i + 24)

// d (+)= A B^T for a 64 x 128 x 32 step of one warpgroup: A and B both
// K-major in shared memory (8-bit operands have no transpose); scale_d 0
// starts the sum.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : DUODIFF_IACC32(0), DUODIFF_IACC32(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef DUODIFF_IACC32
#undef DUODIFF_IACC8

// Keep the compiler from moving accumulator reads across the wgmma wait.
__device__ __forceinline__ void fence_int_accumulators(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// 8 int8 codes clip(rint(v * inv), +-127) = one 8-byte store: quant_int8's
// codes for every v * inv but NaN, with one conversion (round to nearest
// even, to int32, saturating) and an integer clip in place of rintf, two
// float clips and a second conversion.
__device__ __forceinline__ void store8_codes(int8_t* p, const float v[kVec], float inv) {
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int q = min(max(__float2int_rn(__fmul_rn(v[e], inv)), -127), 127);
    word[e / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * (e % 4));
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(word[0], word[1]);
}

// The epilogue warpgroups' part of one tile: lane t of the 256 takes the 8
// columns 8 (t % 16) .. + 7 of rows t / 16 + 16 r, r = 0 .. 7, of the
// staged int32 sums; rows past M and columns past N are not stored. The
// column scales, the bias, the 8 row scales and the first kI8EpiPre residual
// rows are loaded before the wait on `staged`, and each residual row
// kI8EpiPre rows ahead of its use after it, so no load from memory waits in
// the loop. The GELU form is a template argument, so a row's 8 values are
// one straight run of code, and a tile with all its rows below M runs the
// rows with no exit between them.
template <int kMode, int kGelu>
__device__ __forceinline__ void int8_epilogue(const int* staging, uint64_t* staged,
                                              uint32_t parity, int et, const Int8GemmArgs& ep,
                                              int m0, int n0, int M, int N) {
  const int seg = et & 15, row0 = et >> 4;
  const int gn = n0 + 8 * seg;
  const bool cols_in = gn < N;  // N % 8 == 0: the 8 columns are all in or all out
  const bool has_bias = ep.bias != nullptr, has_rows = ep.row_scale != nullptr;
  const auto residual_row = [&](int r) {
    return *reinterpret_cast<const uint4*>(ep.residual +
                                           static_cast<size_t>(m0 + row0 + 16 * r) * N + gn);
  };
  float cs[kVec], b[kVec], rs[kI8EpiRows];
  uint4 pre[kI8EpiPre];
  if (cols_in) {
    load_row8(ep.col_scale + gn, cs);
    if (has_bias) load_row8(ep.bias + gn, b);
    if (has_rows) {
#pragma unroll
      for (int r = 0; r < kI8EpiRows; ++r) {
        const int gm = m0 + row0 + 16 * r;
        rs[r] = gm < M ? ep.row_scale[gm] : 0.f;
      }
    }
    if (kMode == kEpiResidual) {
#pragma unroll
      for (int r = 0; r < kI8EpiPre; ++r)
        if (m0 + row0 + 16 * r < M) pre[r] = residual_row(r);
    }
  }
  const float inv = kMode == kEpiGeluQuant ? ep.quant_inv[0] : 1.f;
  mbar_wait(staged, parity);
  if (!cols_in) return;
  // lanes 4-7 of each quarter warp read their two halves the other way
  // round, so the eight 16-byte reads of a quarter hit distinct banks
  const int h = seg & 4;
  const auto row_out = [&](int r) {
    const int row = row0 + 16 * r;
    const int gm = m0 + row;
    const int* src = staging + row * kI8StagePitch + 8 * seg;
    const int4 first = *reinterpret_cast<const int4*>(src + h);
    const int4 second = *reinterpret_cast<const int4*>(src + 4 - h);
    const int4 lo = h ? second : first, hi = h ? first : second;
    const int acc[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = __fmul_rn(__int2float_rn(acc[e]), has_rows ? __fmul_rn(rs[r], cs[e]) : cs[e]);
    const size_t off = static_cast<size_t>(gm) * N + gn;
    if (kMode == kEpiResidual) {
      float res[kVec];
      unpack8(pre[r % kI8EpiPre], res);
      if (r + kI8EpiPre < kI8EpiRows && gm + 16 * kI8EpiPre < M)
        pre[r % kI8EpiPre] = residual_row(r + kI8EpiPre);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = __fadd_rn(res[e], v[e]);
    }
    if (has_bias) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = __fadd_rn(v[e], b[e]);
    }
    if (kMode == kEpiBias || kMode == kEpiResidual) {
      store_row8(static_cast<bf16*>(ep.out) + off, v);
    } else if (kMode == kEpiGeluF32) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = gelu(v[e], kGelu);
      store_row8(static_cast<float*>(ep.out) + off, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = gelu(v[e], kGelu);
      store8_codes(static_cast<int8_t*>(ep.out) + off, v, inv);
    }
  };
  if (m0 + kI8BM <= M) {
#pragma unroll
    for (int r = 0; r < kI8EpiRows; ++r) row_out(r);
  } else {
#pragma unroll
    for (int r = 0; r < kI8EpiRows; ++r) {
      if (m0 + row0 + 16 * r >= M) break;
      row_out(r);
    }
  }
}

template <int kMode, int kGelu>
__global__ void __launch_bounds__(kI8Threads, 1)
gemm_int8_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b, int M, int N, int K,
                 const Int8GemmArgs ep) {
  extern __shared__ unsigned char gemm_int8_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_int8_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  int* staging = reinterpret_cast<int*>(smem + kI8StagingOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kI8BarOffset);
  uint64_t* empty = full + kI8Stages;
  uint64_t* staged = empty + kI8Stages;  // the MMA warpgroups wrote a tile
  uint64_t* drained = staged + 1;        // the epilogue warpgroups read it

  const int n_tiles = (N + kI8BN - 1) / kI8BN;
  const int num_tiles = ((M + kI8BM - 1) / kI8BM) * n_tiles;
  const int num_k = (K + kI8BK - 1) / kI8BK;
  // the warpgroup's role, read from lane 0 so that the compiler sees it
  // uniform across the warp: a branch it took for divergent would make ptxas
  // serialise the wgmma products
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kI8Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kI8MmaThreads / 32);
    }
    mbar_init(staged, kI8MmaThreads);
    mbar_init(drained, kI8EpiThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load of the block's tiles
    setmaxnreg_dec<kI8ProducerRegs>();
    if (threadIdx.x != 0) return;
    prefetch_tma_map(&tma_a);
    prefetch_tma_map(&tma_b);
    int it = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kI8BM, n0 = tile % n_tiles * kI8BN;
      for (int kb = 0; kb < num_k; ++kb, ++it) {
        const int s = it % kI8Stages;
        mbar_wait(&empty[s], ((it / kI8Stages) & 1) ^ 1);
        unsigned char* a = smem + s * kI8StageBytes;
        mbar_arrive_expect_tx(&full[s], kI8StageBytes);
        tma_load_2d(a, &tma_a, &full[s], kb * kI8BK, m0);
        tma_load_2d(a + kI8BoxBytes, &tma_b, &full[s], kb * kI8BK, n0);
      }
    }
  } else if (wg >= 3) {
    // epilogue: each staged tile to C
    setmaxnreg_inc<kI8EpilogueRegs>();
    const int et = threadIdx.x - 3 * 128;
    int i = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++i) {
      int8_epilogue<kMode, kGelu>(staging, staged, i & 1, et, ep, tile / n_tiles * kI8BM,
                                  tile % n_tiles * kI8BN, M, N);
      mbar_arrive(drained);
    }
  } else {
    // MMA warpgroup w multiplies rows 64 w .. 64 w + 63 of each tile
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    // the accumulator fragment: row 16 (warp in group) + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1), j = 0 .. 15
    int* frag = staging + (64 * w + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2)) *
                              kI8StagePitch + 2 * (lane & 3);
    int d[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) d[r] = 0;
    int it = 0, i = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++i) {
      int prev = 0;
      for (int kb = 0; kb < num_k; ++kb, ++it) {
        const int s = it % kI8Stages;
        mbar_wait(&full[s], (it / kI8Stages) & 1);
        const uint32_t a = smem_u32(smem + s * kI8StageBytes) + w * 64 * 128;
        const uint32_t b = smem_u32(smem + s * kI8StageBytes + kI8BoxBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kI8BK / 32; ++kk) {
          // 32 K values = 32 bytes along the swizzled rows of both operands,
          // 8-row groups 1 KB apart
          wgmma_m64n128k32_s8(d, smem_desc(a + 32 * kk, 16, 1024),
                              smem_desc(b + 32 * kk, 16, 1024), (kb | kk) != 0);
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();  // the previous slab's products are done with it
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      fence_int_accumulators(d);
      mbar_wait(drained, (i & 1) ^ 1);  // the epilogue has read the last tile
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<int2*>(frag + 8 * j) = make_int2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<int2*>(frag + 8 * kI8StagePitch + 8 * j) =
            make_int2(d[4 * j + 2], d[4 * j + 3]);
      }
      mbar_arrive(staged);
    }
  }
}

// The TMA map of a row-major (rows, K) int8 matrix in 128 x 128 boxes.
inline cudaError_t int8_tma_map(CUtensorMap* map, const int8_t* base, int rows, int K) {
  return swizzled_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, K, 128);
}

// The kernel's dynamic shared memory opt-in, once per form.
template <int kMode, int kGelu>
inline cudaError_t gemm_int8_attributes() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gemm_int8_kernel<kMode, kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, kI8SmemBytes);
  return err;
}

// Resident blocks an SM (the occupancy call), for reports.
inline int gemm_int8_blocks_per_sm() {
  if (gemm_int8_attributes<kEpiBias, kGeluNone>() != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gemm_int8_kernel<kEpiBias, kGeluNone>,
                                                kI8Threads, kI8SmemBytes);
  return blocks;
}

template <int kMode, int kGelu>
inline cudaError_t launch_gemm_int8_form(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                         int M, int N, int K, const Int8GemmArgs& ep,
                                         cudaStream_t stream) {
  const cudaError_t err = gemm_int8_attributes<kMode, kGelu>();
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kI8BM - 1) / kI8BM) * ((N + kI8BN - 1) / kI8BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_int8_kernel<kMode, kGelu><<<grid, kI8Threads, kI8SmemBytes, stream>>>(map_a, map_b, M, N,
                                                                             K, ep);
  return cudaGetLastError();
}

// The GELU forms of an epilogue that applies GELU.
template <int kMode>
inline cudaError_t launch_gemm_int8_gelu(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                         int M, int N, int K, const Int8GemmArgs& ep,
                                         cudaStream_t stream) {
  if (ep.gelu_mode == kGeluErf)
    return launch_gemm_int8_form<kMode, kGeluErf>(map_a, map_b, M, N, K, ep, stream);
  if (ep.gelu_mode == kGeluTanh)
    return launch_gemm_int8_form<kMode, kGeluTanh>(map_a, map_b, M, N, K, ep, stream);
  return launch_gemm_int8_form<kMode, kGeluNone>(map_a, map_b, M, N, K, ep, stream);
}

// C = epilogue(A (M, K) @ B (N, K)^T), by ep.mode. Refuses, with nothing
// launched, what TMA or the row vectors cannot take.
inline cudaError_t launch_gemm_int8(const int8_t* A, const int8_t* B, int M, int N, int K,
                                    const Int8GemmArgs& ep, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0 || ep.mode < kEpiBias ||
      ep.mode > kEpiGeluQuant || ep.gelu_mode < kGeluNone || ep.gelu_mode > kGeluTanh ||
      ep.col_scale == nullptr || ep.out == nullptr ||
      (ep.mode == kEpiResidual && ep.residual == nullptr) ||
      (ep.mode == kEpiGeluQuant && (ep.quant_inv == nullptr || N % 16 != 0)))
    return cudaErrorInvalidValue;
  if (misaligned16(A) || misaligned16(B) || misaligned16(ep.out) || misaligned16(ep.col_scale) ||
      misaligned16(ep.bias) || misaligned16(ep.residual))
    return cudaErrorMisalignedAddress;
  CUtensorMap map_a, map_b;
  cudaError_t err = int8_tma_map(&map_a, A, M, K);
  if (err != cudaSuccess) return err;
  err = int8_tma_map(&map_b, B, N, K);
  if (err != cudaSuccess) return err;
  switch (ep.mode) {
    case kEpiBias:
      return launch_gemm_int8_form<kEpiBias, kGeluNone>(map_a, map_b, M, N, K, ep, stream);
    case kEpiResidual:
      return launch_gemm_int8_form<kEpiResidual, kGeluNone>(map_a, map_b, M, N, K, ep, stream);
    case kEpiGeluF32:
      return launch_gemm_int8_gelu<kEpiGeluF32>(map_a, map_b, M, N, K, ep, stream);
    default:
      return launch_gemm_int8_gelu<kEpiGeluQuant>(map_a, map_b, M, N, K, ep, stream);
  }
}

}  // namespace
}  // namespace duodiff
