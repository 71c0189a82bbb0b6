// The hidden-activation stage of the MLP sublayer's backward, shared by the
// monolithic kernel K7 (mlp_sublayer_bwd.cu) and the row-chunked kernel K8
// (mlp_sublayer_bwd_split.cu): for each (128 rows, 64 hidden columns) tile,
// h_pre = xn W1 + b1 and dh = dy W2^T in fp32, and in the epilogue
// hgb = bf16(gelu(h_pre)), dhp = dh * gelu'(h_pre) stored as bf16, and the
// tile's fp32 column sums of the unrounded dhp (db1 partials).
//
// Replaces: the h_pre / hgb / dh / dhp chain of duodiff_tpu/ops/
// pallas_block.py _mlp_bwd_kernel (:1074-1091) and _mlp_bwd_partial_kernel
// (:1206-1220). M and Hd are the rows and hidden columns of THIS call: all
// rows for K7, one row chunk for K8, whose xn and dy then point at the
// chunk's first row; Hd may be a slice of the hidden width, w1 then pointing
// at the slice's first column (row pitch ld_w1 = the whole width, a TMA
// stride), b1 at its first entry and w2 at its first row; hgb, dhp (M, Hd)
// and db1_part (row tiles, Hd) are the call's own.
//
// Bound: two products of 2 * M * D * Hd flops each (69 GFLOP each at D =
// 512, batch 128), tensor-core bound, and an epilogue over M * Hd outputs
// (67.4 M at D = 512) that evaluates GELU and its derivative: at about a
// tile's product time per tile, the epilogue sets the pace as fc1's does in
// the forward GEMMs.
// Design: gemm.cuh's, with both products in one tile. One persistent block
// an SM walks the (row tile, hidden tile) pairs, row by row; five
// warpgroups:
// - the producer keeps a ring of three 64-deep K slabs by TMA (128-byte
//   swizzle): xn and dy rows as 128 x 64 boxes, the W1 slice N-major as a 64
//   x 64 box (read through wgmma's transpose bit) and the W2 rows K-major as
//   a 64 x 64 box, 48 KB a slab;
// - two MMA warpgroups each own 64 rows and issue, per 16-deep step, wgmma
//   m64n64k16 for h and for dh into two 32-register accumulators: the 64
//   registers a thread that gemm.cuh's single 64 x 128 accumulator takes.
//   Two 64 x 128 accumulators (128 registers) do not fit beside the
//   epilogue warpgroups at 640 threads (96 registers each), so the hidden
//   tile is 64 wide rather than 128 wide or staged in two passes;
// - two epilogue warpgroups read both staged fp32 tiles (h and dh, 128 x
//   64 each) while the next tile is multiplied: lane t takes the 8 columns
//   8 (t % 8) .. + 7 of rows t / 8 + 32 r, r = 0 .. 3; one erff (or tanhf)
//   per value gives both GELU and its derivative (the halvings are exact:
//   h * (0.5 (1 + e)) rounds as 0.5 h (1 + e)); the column sums go across
//   the lanes of a warp by shuffles and across the warps through shared
//   memory, always in the same order.
// TMA zero-fills the rows past M and the K tail; stores are masked at M and
// Hd. D % 8 == 0, Hd % 8 == 0, ld_w1 % 8 == 0 and 16-byte aligned operands
// are required, else the launch returns cudaErrorInvalidValue /
// cudaErrorMisalignedAddress and nothing runs. Every mbarrier wait traps
// after 10 s (hopper.cuh).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace duodiff {
namespace {

constexpr int kHidBM = 128;          // two MMA warpgroups of 64 rows
constexpr int kHidBN = 64;
constexpr int kHidBK = 64;           // one 128-byte swizzle row of bf16
constexpr int kHidStages = 3;
constexpr int kHidThreads = 640;     // producer, two MMA and two epilogue warpgroups
constexpr int kHidMmaThreads = 256;
constexpr int kHidEpiThreads = 256;
constexpr int kHidEpiRows = kHidBM * (kHidBN / 8) / kHidEpiThreads;  // 4 rows a lane
constexpr int kHidActBytes = kHidBM * kHidBK * 2;     // an xn or dy box, 16 KB
constexpr int kHidWBytes = kHidBK * kHidBN * 2;       // a W1 or W2 box, 8 KB
constexpr int kHidDyOffset = kHidActBytes;
constexpr int kHidW1Offset = 2 * kHidActBytes;
constexpr int kHidW2Offset = 2 * kHidActBytes + kHidWBytes;
constexpr int kHidStageBytes = 2 * kHidActBytes + 2 * kHidWBytes;  // 48 KB
// fp32 words a staged row: 64 + 8 keeps the fragment writes and the row
// reads free of bank conflicts
constexpr int kHidPitch = kHidBN + 8;
constexpr int kHidTileBytes = kHidBM * kHidPitch * 4;
constexpr int kHidStagingOffset = kHidStages * kHidStageBytes;
constexpr int kHidColsOffset = kHidStagingOffset + 2 * kHidTileBytes;
// two buffers of (8 epilogue warps x 64 columns) column sums
constexpr int kHidBarOffset = kHidColsOffset + 2 * 8 * kHidBN * 4;
constexpr int kHidSmemBytes = 1024 + kHidBarOffset + (2 * kHidStages + 2) * 8;

#define DUODIFF_HACC8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B for a 64 x 64 x 16 step of one warpgroup from shared memory: A
// K-major; kTransB 1 B N-major, 0 K-major; scale_d 0 starts the sum.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : DUODIFF_HACC8(0), DUODIFF_HACC8(8), DUODIFF_HACC8(16), DUODIFF_HACC8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

#undef DUODIFF_HACC8

__device__ __forceinline__ void fence_hidden_accumulators(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// gelu(h) and d gelu(h) / dh in fp32 from one erff or tanhf
// (pallas_block._gelu_grad's forms).
template <int kGelu>
__device__ __forceinline__ void gelu_and_grad(float h, float& g, float& dg) {
  if (kGelu == kGeluTanh) {
    const float c = 0.79788456080286536f, a = 0.044715f;
    const float t = tanhf(c * (h + a * h * h * h));
    g = 0.5f * h * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * c * (1.f + 3.f * a * h * h);
  } else {
    const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    g = h * cdf;
    dg = cdf + h * (expf(-0.5f * h * h) * 0.3989422804014327f);
  }
}

__device__ __forceinline__ void hidden_epilogue_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kHidEpiThreads) : "memory");
}

template <int kGelu>
__global__ void __launch_bounds__(kHidThreads, 1)
mlp_bwd_hidden_kernel(const __grid_constant__ CUtensorMap tma_x,
                      const __grid_constant__ CUtensorMap tma_dy,
                      const __grid_constant__ CUtensorMap tma_w1,
                      const __grid_constant__ CUtensorMap tma_w2, const float* __restrict__ b1,
                      bf16* __restrict__ hgb, bf16* __restrict__ dhp,
                      float* __restrict__ db1_part, int M, int D, int Hd) {
  extern __shared__ unsigned char hidden_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(hidden_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* staged_h = reinterpret_cast<float*>(smem + kHidStagingOffset);
  float* staged_g = reinterpret_cast<float*>(smem + kHidStagingOffset + kHidTileBytes);
  float* cols = reinterpret_cast<float*>(smem + kHidColsOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kHidBarOffset);
  uint64_t* empty = full + kHidStages;
  uint64_t* staged = empty + kHidStages;  // the MMA warpgroups wrote a tile
  uint64_t* drained = staged + 1;         // the epilogue warpgroups read it

  const int n_tiles = (Hd + kHidBN - 1) / kHidBN;
  const int num_tiles = ((M + kHidBM - 1) / kHidBM) * n_tiles;
  const int num_k = (D + kHidBK - 1) / kHidBK;
  // the role from lane 0, uniform across the warp (see gemm.cuh)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kHidStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHidMmaThreads / 32);
    }
    mbar_init(staged, kHidMmaThreads);
    mbar_init(drained, kHidEpiThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dependency_wait();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    if (threadIdx.x != 0) return;
    prefetch_tma_map(&tma_x);
    prefetch_tma_map(&tma_dy);
    prefetch_tma_map(&tma_w1);
    prefetch_tma_map(&tma_w2);
    int it = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * kHidBM, n0 = tile % n_tiles * kHidBN;
      for (int kb = 0; kb < num_k; ++kb, ++it) {
        const int s = it % kHidStages;
        const int k0 = kb * kHidBK;
        mbar_wait(&empty[s], ((it / kHidStages) & 1) ^ 1);
        unsigned char* st = smem + s * kHidStageBytes;
        mbar_arrive_expect_tx(&full[s], kHidStageBytes);
        tma_load_2d(st, &tma_x, &full[s], k0, m0);
        tma_load_2d(st + kHidDyOffset, &tma_dy, &full[s], k0, m0);
        tma_load_2d(st + kHidW1Offset, &tma_w1, &full[s], n0, k0);  // 64 K rows of W1's slice
        tma_load_2d(st + kHidW2Offset, &tma_w2, &full[s], k0, n0);  // 64 hidden rows of W2
      }
    }
  } else if (wg >= 3) {
    // epilogue: both staged tiles to hgb, dhp and the column sums
    const int et = threadIdx.x - 3 * 128;
    const int seg = et & 7, row0 = et >> 3, warp = et >> 5, lane = et & 31;
    const int h = seg & 4;  // lanes 4-7 of a quarter warp read their halves the other way round
    int i = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++i) {
      const int m0 = tile / n_tiles * kHidBM, n0 = tile % n_tiles * kHidBN;
      const int gn = n0 + 8 * seg;
      const bool cols_in = gn < Hd;  // Hd % 8 == 0: the 8 columns are all in or all out
      float b[kVec], sum[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) b[e] = sum[e] = 0.f;
      if (cols_in) load_row8(b1 + gn, b);
      mbar_wait(staged, i & 1);
#pragma unroll
      for (int r = 0; r < kHidEpiRows; ++r) {
        const int row = row0 + 32 * r;
        const int gm = m0 + row;
        if (!cols_in || gm >= M) continue;
        const int at = row * kHidPitch + 8 * seg;
        const float4 h0 = *reinterpret_cast<const float4*>(staged_h + at + h);
        const float4 h1 = *reinterpret_cast<const float4*>(staged_h + at + 4 - h);
        const float4 g0 = *reinterpret_cast<const float4*>(staged_g + at + h);
        const float4 g1 = *reinterpret_cast<const float4*>(staged_g + at + 4 - h);
        const float4 hl = h ? h1 : h0, hh = h ? h0 : h1;
        const float4 gl = h ? g1 : g0, gh = h ? g0 : g1;
        const float hv[kVec] = {hl.x, hl.y, hl.z, hl.w, hh.x, hh.y, hh.z, hh.w};
        const float dv[kVec] = {gl.x, gl.y, gl.z, gl.w, gh.x, gh.y, gh.z, gh.w};
        float act[kVec], grad[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float dg;
          gelu_and_grad<kGelu>(hv[e] + b[e], act[e], dg);
          grad[e] = dv[e] * dg;
          sum[e] += grad[e];
        }
        const size_t off = static_cast<size_t>(gm) * Hd + gn;
        store_row8(hgb + off, act);
        store_row8(dhp + off, grad);
      }
      mbar_arrive(drained);
      // column sums: the 4 lanes of a warp with the same columns (lane,
      // lane ^ 8, ^ 16, ^ 24), then the 8 warps in order
      float* buf = cols + (i & 1) * 8 * kHidBN;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float v = sum[e];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) buf[warp * kHidBN + 8 * seg + e] = v;
      }
      hidden_epilogue_sync();
      if (et < kHidBN && n0 + et < Hd) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += buf[w * kHidBN + et];
        db1_part[static_cast<size_t>(tile / n_tiles) * Hd + n0 + et] = s;
      }
    }
  } else {
    // MMA warpgroup w multiplies rows 64 w .. 64 w + 63 of each tile
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    // the accumulator fragment: row 16 (warp in group) + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1), j = 0 .. 7
    const int frag = (64 * w + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2)) * kHidPitch +
                     2 * (lane & 3);
    float dh[32], dd[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) dh[r] = dd[r] = 0.f;
    int it = 0, i = 0;
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++i) {
      int prev = 0;
      for (int kb = 0; kb < num_k; ++kb, ++it) {
        const int s = it % kHidStages;
        mbar_wait(&full[s], (it / kHidStages) & 1);
        const uint32_t st = smem_u32(smem + s * kHidStageBytes);
        const uint32_t x = st + w * 64 * 128, y = st + kHidDyOffset + w * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHidBK / 16; ++kk) {
          // xn, dy and W2 K-major: 32 bytes along the swizzled rows, 8-row
          // groups 1 KB apart; W1 N-major: 16 K rows = 2 KB down
          wgmma_m64n64k16<1>(dh, smem_desc(x + 32 * kk, 16, 1024),
                             smem_desc(st + kHidW1Offset + 2048 * kk, kHidWBytes, 1024),
                             (kb | kk) != 0);
          wgmma_m64n64k16<0>(dd, smem_desc(y + 32 * kk, 16, 1024),
                             smem_desc(st + kHidW2Offset + 32 * kk, 16, 1024), (kb | kk) != 0);
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
      fence_hidden_accumulators(dh);
      fence_hidden_accumulators(dd);
      mbar_wait(drained, (i & 1) ^ 1);  // the epilogue has read the last tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(staged_h + frag + 8 * j) = make_float2(dh[4 * j], dh[4 * j + 1]);
        *reinterpret_cast<float2*>(staged_h + frag + 8 * kHidPitch + 8 * j) =
            make_float2(dh[4 * j + 2], dh[4 * j + 3]);
        *reinterpret_cast<float2*>(staged_g + frag + 8 * j) = make_float2(dd[4 * j], dd[4 * j + 1]);
        *reinterpret_cast<float2*>(staged_g + frag + 8 * kHidPitch + 8 * j) =
            make_float2(dd[4 * j + 2], dd[4 * j + 3]);
      }
      mbar_arrive(staged);
    }
  }
}

inline int row_tiles(int M) { return (M + kHidBM - 1) / kHidBM; }

template <int kGelu>
inline cudaError_t mlp_bwd_hidden_attributes() {
  static const cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_hidden_kernel<kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, kHidSmemBytes);
  return err;
}

// Resident blocks an SM (the occupancy call), for reports.
inline int mlp_bwd_hidden_blocks_per_sm() {
  if (mlp_bwd_hidden_attributes<kGeluErf>() != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mlp_bwd_hidden_kernel<kGeluErf>,
                                                kHidThreads, kHidSmemBytes);
  return blocks;
}

// xn, dy (M, D); w1 (D, Hd) with row pitch ld_w1; b1 (Hd,); w2 (Hd, D);
// hgb, dhp (M, Hd) bf16; db1_part (row_tiles(M), Hd) fp32. gelu_mode 1
// exact, 2 tanh.
inline cudaError_t launch_mlp_bwd_hidden(const bf16* xn, const bf16* w1, int ld_w1,
                                         const float* b1, const bf16* dy, const bf16* w2,
                                         bf16* hgb, bf16* dhp, float* db1_part, int M, int D,
                                         int Hd, int gelu_mode, cudaStream_t stream,
                                         bool pdl = false) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || D <= 0 || Hd <= 0 || D % 8 != 0 || Hd % 8 != 0 || ld_w1 % 8 != 0 ||
      (gelu_mode != kGeluErf && gelu_mode != kGeluTanh))
    return cudaErrorInvalidValue;
  if (misaligned16(xn) || misaligned16(w1) || misaligned16(b1) || misaligned16(dy) ||
      misaligned16(w2) || misaligned16(hgb) || misaligned16(dhp))
    return cudaErrorMisalignedAddress;
  CUtensorMap map_x, map_dy, map_w1, map_w2;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err = swizzled_tma_map(&map_x, type, 2, xn, M, D, kHidBM);
  if (err == cudaSuccess) err = swizzled_tma_map(&map_dy, type, 2, dy, M, D, kHidBM);
  if (err == cudaSuccess) err = swizzled_tma_map(&map_w1, type, 2, w1, D, Hd, kHidBK, ld_w1);
  if (err == cudaSuccess) err = swizzled_tma_map(&map_w2, type, 2, w2, Hd, D, kHidBN);
  if (err != cudaSuccess) return err;
  const int tiles = row_tiles(M) * ((Hd + kHidBN - 1) / kHidBN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  if (gelu_mode == kGeluTanh) {
    err = mlp_bwd_hidden_attributes<kGeluTanh>();
    if (err != cudaSuccess) return err;
    return launch_kernel(mlp_bwd_hidden_kernel<kGeluTanh>, grid, kHidThreads, kHidSmemBytes,
                         stream, pdl, map_x, map_dy, map_w1, map_w2, b1, hgb, dhp, db1_part, M,
                         D, Hd);
  }
  err = mlp_bwd_hidden_attributes<kGeluErf>();
  if (err != cudaSuccess) return err;
  return launch_kernel(mlp_bwd_hidden_kernel<kGeluErf>, grid, kHidThreads, kHidSmemBytes, stream,
                       pdl, map_x, map_dy, map_w1, map_w2, b1, hgb, dhp, db1_part, M, D, Hd);
}

}  // namespace
}  // namespace duodiff
