// bf16 GEMM with an fp32 epilogue for Hopper: every bf16 matrix product of
// the block kernels but the MLP backward's hidden stage (mlp_bwd_hidden.cuh),
// forward and backward.
//
//   acc[M, N] = A(m, k) B(k, n) in fp32 from bf16 operands, where by form
//   A(m, k) = A[m * lda + k] (A K-major, rows of activations), or with kTA
//             A[k * lda + m] (A stored (K, M): a weight gradient's
//             contraction over the rows);
//   B(k, n) = B[k * ldb + n] (B N-major, the packed (K, N) weights or a
//             gradient's rows), or with kTB B[n * ldb + k] (B stored (N, K):
//             a weight read transposed, W^T);
// and by epilogue (a template argument):
//   RowEpilogue       C = cast(gelu?(acc + residual? + bias?)), bf16 or fp32
//                     rows: the forward projections, dm and dxn;
//   SplitSumEpilogue  C fp32 = the row splits' sums added in split order (a
//                     weight gradient, or K8's pair of them a row chunk),
//                     with split 0 adding to C when asked (K8's chunks after
//                     the first, the measuring entry's C += acc).
//
// The forward form (A K-major, B N-major, RowEpilogue) carries qkv and proj
// (K1, K1-v1, K6's qkv recompute), fc1 and fc2 (K2), and all four in the
// whole-block kernel K5. The row types of the residual and of C are template
// arguments (bf16 or fp32): K5 writes its intermediate residual stream u as
// fp32 from the proj epilogue and adds it as fp32 in the fc2 epilogue; every
// other forward caller takes bf16 for both (launch_gemm). The backward
// launchers are gemm_t.cuh's: dm = dy Wp^T (bf16) and dxn = dqkv Wqkv^T /
// dhp W1^T (fp32) in the form (A K-major, B K-major), the weight gradients
// dWp, dWqkv, dW1, dW2 in the form (A stored (K, M), B N-major).
//
// Replaces: the jnp.dot(..., preferred_element_type=f32) projections inside
// duodiff_tpu/ops/pallas_block.py _kernel_v2 (qkv, :132-135; proj with the
// fp32 residual and bias, :161-164) and _mlp_kernel (fc1 + bias + GELU,
// :405-408; fc2 with the fp32 residual and bias, :409-412), and the
// jax.lax.dot_general contractions of _attn_bwd_kernel (dm :283, dWp :347,
// dWqkv :351, dxn :360) and _mlp_bwd_kernel (dW2 :1079, dW1 :1092, dxn
// :1097). The forward epilogue keeps their order: residual first, then
// bias, then GELU, all in fp32, one rounding at the end. GELU is exact
// (erff) or tanh.
//
// Bound: at the sampling and training shapes (M = B*257 or B*258, K in
// {512, 768, 2048, 3072}, and K = B*L rows for the weight gradients) these
// are the tensor-core work of the blocks, so the bound is tensor-core
// throughput, which only wgmma reaches; a 128x128 tile takes 2*(128+128)*64
// bytes from L2 per 2*128*128*64 flops, and the weights (at most 4.7 MB)
// stay in L2.
// Design: one persistent block an SM walks the units of work (a 128 x 128
// output tile of one row split), row of tiles by row of tiles, so the
// blocks running together share the A rows in L2. Five warpgroups, each
// with one job:
// - the producer (one thread issues) keeps a ring of four 64-deep K slabs in
//   flight by TMA with a 128-byte swizzle, 16 KB of A and 16 KB of B a slab:
//   a K-major operand as one 128 x 64 box (128 rows of 64 K values), an
//   MN-major one (rows along K) as two 64 x 64 boxes (64 K rows of 64
//   columns each); each stage has a "full" mbarrier (TMA bytes) and an
//   "empty" one (the eight MMA warps);
// - two MMA warpgroups each own 64 rows of the tile and issue wgmma
//   m64n128k16 from shared memory into fp32 registers, keeping one slab's
//   products in flight while the previous slab is released; an MN-major
//   operand is read through wgmma's transpose bit for it (A or B), so no
//   operand is repacked. At the end of a tile they write the fp32 sums to a
//   shared-memory staging tile and go on to the next tile at once;
// - two epilogue warpgroups read the staged tile row by row (8 consecutive
//   values a lane: the residual read and C written as whole rows, 16 bytes
//   a lane), add the residual and the bias, apply GELU and round, while the
//   MMA warpgroups already multiply the next tile; they load the residual
//   rows of a tile before it is staged. A pair of mbarriers hands the
//   staging tile back and forth.
// Run in the MMA warpgroups, the epilogue (erff GELU at fc1, the residual
// read at proj and fc2) left the tensor cores idle for longer than the
// tile's products took.
// Weight gradients: their outputs have only 16 to 144 tiles (D x D to
// D x 4D) for 132 SMs, and contract over all B*L rows, so the rows are split
// into `splits` ranges (weight_grad_splits: waves of units against the
// cost of one more split) and unit u is tile u % tiles of split u / tiles. Split 0 stores
// its fp32 tile; split s > 0 waits until split s - 1 has set the tile's
// flag to s, adds the tile it finds in C (read from L2) to its own sums and
// stores, then sets the flag to s + 1: the splits are summed in split order
// with no partial buffer, and with no floating-point atomic, so a repeat
// call gives the same bits. A unit waits only on a unit of lower index, and
// every block of the grid (at most one a SM) is resident, so the lowest
// unfinished unit can always go on: no deadlock. (Launched as a
// programmatic dependent launch, as K8 launches it, the grid starts only
// when every block of the kernel before it has exited, since no kernel
// here signals its dependents early: its blocks are all resident too.) The
// last split of a tile clears its flag, so a launch leaves the flags zero.
// Its flag wait traps after 10 s like the mbarrier waits.
// TMA zero-fills the rows and columns past the operands' ends and the K
// tail; stores are masked at M and N. N % 8 == 0, K % 8 == 0 where an
// operand is read along K (A K-major, B K-major), M % 8 == 0 with A stored
// (K, M), row pitches % 8 == 0 and 16-byte aligned operands are required
// (the TMA strides and the row vectors), else the launch returns
// cudaErrorInvalidValue / cudaErrorMisalignedAddress and nothing runs. A
// wait on an mbarrier that does not complete within 10 s traps, so a fault
// in the ring ends the kernel with an error instead of hanging it. The
// mbarrier, TMA, descriptor and flag helpers are hopper.cuh's, shared with
// mlp_bwd_hidden.cuh and gemm_int8.cuh.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace duodiff {
namespace {

constexpr int kGemmBM = 128;        // two MMA warpgroups of 64 rows
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 64;         // one 128-byte swizzle row of bf16
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 640;   // producer, two MMA and two epilogue warpgroups
constexpr int kGemmMmaThreads = 256;
constexpr int kGemmEpiThreads = 256;
constexpr int kGemmEpiRows = kGemmBM * (kGemmBN / 8) / kGemmEpiThreads;  // 8 rows a lane
constexpr int kGemmBoxBytes = 64 * 64 * 2;   // one 64 x 64 bf16 TMA box
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2;   // 16 KB
constexpr int kGemmStageBytes = kGemmABytes + kGemmBK * kGemmBN * 2;  // 32 KB
// fp32 words a staged row: 128 + 8 keeps both the fragment writes and the
// row reads free of bank conflicts
constexpr int kGemmStagePitch = kGemmBN + 8;
constexpr int kGemmStagingOffset = kGemmStages * kGemmStageBytes;
constexpr int kGemmBarOffset = kGemmStagingOffset + kGemmBM * kGemmStagePitch * 4;
// the ring starts on a 1024-byte boundary (the swizzle atom); 2 barriers a
// stage and the staging tile's pair
constexpr int kGemmSmemBytes = 1024 + kGemmBarOffset + (2 * kGemmStages + 2) * 8;

#define DUODIFF_ACC8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DUODIFF_ACC32(i) DUODIFF_ACC8(i), DUODIFF_ACC8(i + 8), DUODIFF_ACC8(i + 16), \
                         DUODIFF_ACC8(i + 24)

// d (+)= A B for a 64 x 128 x 16 step of one warpgroup, both operands in
// shared memory: kTransA 0 A K-major, 1 MN-major; kTransB 0 B K-major, 1
// N-major (wgmma's transpose bits); scale_d 0 starts the sum.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : DUODIFF_ACC32(0), DUODIFF_ACC32(32)
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

#undef DUODIFF_ACC32
#undef DUODIFF_ACC8

// Keep the compiler from moving accumulator reads across the wgmma wait.
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 8 consecutive values of a residual row as they lie in memory: the
// epilogue issues these loads before it waits for the staged tile, so their
// latency hides behind the tile's products.
template <typename T>
struct Raw8;

template <>
struct Raw8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void add_to(float x[kVec]) const {
    float r[kVec];
    unpack8(v, r);
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] += r[e];
  }
};

template <>
struct Raw8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const float4*>(p)[0];
    hi = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void add_to(float x[kVec]) const {
    x[0] += lo.x; x[1] += lo.y; x[2] += lo.z; x[3] += lo.w;
    x[4] += hi.x; x[5] += hi.y; x[6] += hi.z; x[7] += hi.w;
  }
};

// The epilogue warpgroups' part of one tile: lane t of the 256 takes the 8
// columns 8 (t % 16) .. + 7 of rows t / 16 + 16 r, r = 0 .. 7, of the
// staged fp32 sums, adds the residual and the bias, applies GELU and stores
// once; rows past M and columns past N are not stored. The residual rows
// (all 8 in bf16, the first 4 in fp32, for the registers) are loaded before
// the wait on `staged`.
template <typename ResT, typename OutT>
__device__ __forceinline__ void gemm_epilogue(const float* staging, uint64_t* staged,
                                              uint32_t parity, int et, OutT* __restrict__ C,
                                              const float* __restrict__ bias,
                                              const ResT* __restrict__ residual, int m0, int n0,
                                              int M, int N, int gelu_mode) {
  constexpr int kPre = sizeof(ResT) == 2 ? kGemmEpiRows : kGemmEpiRows / 2;
  const int seg = et & 15, row0 = et >> 4;
  const int gn = n0 + 8 * seg;
  const bool cols_in = gn < N;  // N % 8 == 0: the 8 columns are all in or all out
  Raw8<ResT> pre[kPre];
  float b[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (cols_in) {
    if (residual != nullptr) {
#pragma unroll
      for (int r = 0; r < kPre; ++r) {
        const int gm = m0 + row0 + 16 * r;
        if (gm < M) pre[r].load(residual + static_cast<size_t>(gm) * N + gn);
      }
    }
    if (bias != nullptr) load_row8(bias + gn, b);
  }
  mbar_wait(staged, parity);
  if (!cols_in) return;
  // lanes 4-7 of each quarter warp read their two halves the other way
  // round, so the eight 16-byte reads of a quarter hit distinct banks
  const int h = seg & 4;
#pragma unroll
  for (int r = 0; r < kGemmEpiRows; ++r) {
    const int row = row0 + 16 * r;
    const int gm = m0 + row;
    if (gm >= M) break;
    const float* src = staging + row * kGemmStagePitch + 8 * seg;
    const float4 first = *reinterpret_cast<const float4*>(src + h);
    const float4 second = *reinterpret_cast<const float4*>(src + 4 - h);
    const float4 lo = h ? second : first, hi = h ? first : second;
    float v[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = static_cast<size_t>(gm) * N + gn;
    if (residual != nullptr) {
      if (r < kPre) {
        pre[r].add_to(v);
      } else {
        float res[kVec];
        load_row8(residual + off, res);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] += res[e];
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = gelu(v[e] + b[e], gelu_mode);
    store_row8(C + off, v);
  }
}

// The epilogue warpgroups meet at named barrier 1 (the block's other
// warps never wait at it).
__device__ __forceinline__ void epilogue_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kGemmEpiThreads) : "memory");
}

// C = cast(gelu?(acc + residual? + bias?)) row by row (gemm_epilogue).
template <typename ResT, typename OutT>
struct RowEpilogue {
  static constexpr bool kSplit = false;
  OutT* C;
  const float* bias;      // (N,) or null
  const ResT* residual;   // (M, N) or null
  int gelu_mode;
  __device__ __forceinline__ void operator()(const float* staging, uint64_t* staged,
                                             uint32_t parity, int et, int m0, int n0, int M,
                                             int N, int, int, int, int) const {
    gemm_epilogue<ResT, OutT>(staging, staged, parity, et, C, bias, residual, m0, n0, M, N,
                              gelu_mode);
  }
};

// C fp32 (C[problem] of a pair): split 0 stores its sums (or, with
// accumulate, adds them to what C holds), split s > 0 waits for flag == s,
// adds its sums to C's tile and stores; every split but the last then sets
// flag = s + 1. Lane t of the 256 takes the 8 columns 8 (t % 16) .. + 7 of
// rows t / 16 + 16 r.
struct SplitSumEpilogue {
  static constexpr bool kSplit = true;
  float* C[2];      // the output of each problem (the second only for a pair)
  int* flags;       // one a tile of all problems, zero before the launch; null when splits == 1
  int accumulate;   // split 0 adds to C too
  __device__ __forceinline__ void operator()(const float* staging, uint64_t* staged,
                                             uint32_t parity, int et, int m0, int n0, int M,
                                             int N, int tile, int split, int splits,
                                             int problem) const {
    const int seg = et & 15, row0 = et >> 4;
    const int gn = n0 + 8 * seg;
    if (split > 0) {
      if (et == 0) flag_wait(flags + tile, split);
      epilogue_sync();
    }
    const bool add = split > 0 || accumulate;
    mbar_wait(staged, parity);
    if (gn < N) {  // N % 8 == 0: the 8 columns are all in or all out
      const int h = seg & 4;  // gemm_epilogue's bank-conflict-free order
#pragma unroll
      for (int r = 0; r < kGemmEpiRows; ++r) {
        const int row = row0 + 16 * r;
        const int gm = m0 + row;
        if (gm >= M) break;
        const float* src = staging + row * kGemmStagePitch + 8 * seg;
        const float4 first = *reinterpret_cast<const float4*>(src + h);
        const float4 second = *reinterpret_cast<const float4*>(src + 4 - h);
        const float4 lo = h ? second : first, hi = h ? first : second;
        float v[kVec] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        float* dst = (problem ? C[1] : C[0]) + static_cast<size_t>(gm) * N + gn;
        if (add) {
          // C as the earlier splits left it, from L2 (another SM wrote it)
          const float4 c0 = __ldcg(reinterpret_cast<const float4*>(dst));
          const float4 c1 = __ldcg(reinterpret_cast<const float4*>(dst) + 1);
          const float c[kVec] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[e] = c[e] + v[e];
        }
        store_row8(dst, v);
      }
    }
    if (split + 1 < splits) {
      __threadfence();
      epilogue_sync();
      if (et == 0) flag_set(flags + tile, split + 1);
    } else if (split > 0 && et == 0) {
      flags[tile] = 0;  // no unit reads it again: the launch leaves the flags as it found them
    }
  }
};

// The operands of a launch: each product's TMA maps of A and B and its
// output shape (M, N). Two products share a launch only as a pair of weight
// gradients over the same K rows (K8's dW2 and dW1 of a row chunk), so that
// the units of both fill the card's waves together.
template <int kProblems>
struct GemmProblems {
  CUtensorMap a[kProblems], b[kProblems];
  int m[kProblems], n[kProblems];
};

// The kernel of every form: kTA A stored (K, M), kTB B stored (N, K)
// (else A (M, K), B (K, N)); Epi one of the epilogues above. `splits` row
// splits of k_per_split slabs each (1 and all slabs but for a weight
// gradient). With kProblems 2 the tiles of the second product follow those
// of the first in every split.
template <bool kTA, bool kTB, typename Epi, int kProblems = 1>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_bf16_kernel(const __grid_constant__ GemmProblems<kProblems> pr, int K, int splits,
                 int k_per_split, const Epi epi) {
  extern __shared__ unsigned char gemm_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* staging = reinterpret_cast<float*>(smem + kGemmStagingOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmBarOffset);
  uint64_t* empty = full + kGemmStages;
  uint64_t* staged = empty + kGemmStages;  // the MMA warpgroups wrote a tile
  uint64_t* drained = staged + 1;          // the epilogue warpgroups read it

  const int n_tiles0 = (pr.n[0] + kGemmBN - 1) / kGemmBN;
  const int tiles0 = ((pr.m[0] + kGemmBM - 1) / kGemmBM) * n_tiles0;
  int num_tiles = tiles0;
  if constexpr (kProblems > 1)
    num_tiles += ((pr.m[1] + kGemmBM - 1) / kGemmBM) * ((pr.n[1] + kGemmBN - 1) / kGemmBN);
  const int num_k = (K + kGemmBK - 1) / kGemmBK;
  const int num_units = Epi::kSplit ? num_tiles * splits : num_tiles;
  // unit -> (tile of all problems, the problem, its output tile (m0, n0),
  // its split's slabs [kb0, kb1))
  struct Unit {
    int tile, problem, m0, n0, M, N, split, kb0, kb1;
  };
  const auto unit_of = [&](int unit) {
    Unit u;
    u.split = Epi::kSplit ? unit / num_tiles : 0;
    u.tile = Epi::kSplit ? unit - u.split * num_tiles : unit;
    u.problem = 0;
    u.M = pr.m[0];
    u.N = pr.n[0];
    int t = u.tile, n_tiles = n_tiles0;
    if constexpr (kProblems > 1) {
      if (u.tile >= tiles0) {
        u.problem = 1;
        u.M = pr.m[1];
        u.N = pr.n[1];
        t -= tiles0;
        n_tiles = (u.N + kGemmBN - 1) / kGemmBN;
      }
    }
    u.m0 = t / n_tiles * kGemmBM;
    u.n0 = t % n_tiles * kGemmBN;
    u.kb0 = Epi::kSplit ? u.split * k_per_split : 0;
    u.kb1 = Epi::kSplit ? min(num_k, u.kb0 + k_per_split) : num_k;
    return u;
  };
  // the warpgroup's role, read from lane 0 so that the compiler sees it
  // uniform across the warp: a branch it took for divergent would make ptxas
  // serialise the wgmma products
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGemmMmaThreads / 32);
    }
    mbar_init(staged, kGemmMmaThreads);
    mbar_init(drained, kGemmEpiThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dependency_wait();

  if (wg == 0) {
    // producer: one thread issues every TMA load of the block's tiles
    if (threadIdx.x != 0) return;
#pragma unroll
    for (int p = 0; p < kProblems; ++p) {
      prefetch_tma_map(&pr.a[p]);
      prefetch_tma_map(&pr.b[p]);
    }
    int it = 0;
    for (int tile = blockIdx.x; tile < num_units; tile += gridDim.x) {
      const Unit u = unit_of(tile);
      const int m0 = u.m0, n0 = u.n0;
      const CUtensorMap* tma_a = &pr.a[0];
      const CUtensorMap* tma_b = &pr.b[0];
      if constexpr (kProblems > 1) {
        if (u.problem) {
          tma_a = &pr.a[1];
          tma_b = &pr.b[1];
        }
      }
      for (int kb = u.kb0; kb < u.kb1; ++kb, ++it) {
        const int s = it % kGemmStages;
        mbar_wait(&empty[s], ((it / kGemmStages) & 1) ^ 1);
        unsigned char* a = smem + s * kGemmStageBytes;
        unsigned char* b = a + kGemmABytes;
        const int k0 = kb * kGemmBK;
        mbar_arrive_expect_tx(&full[s], kGemmStageBytes);
        if (kTA) {  // two boxes of 64 K rows x 64 of the M columns
          tma_load_2d(a, tma_a, &full[s], m0, k0);
          tma_load_2d(a + kGemmBoxBytes, tma_a, &full[s], m0 + 64, k0);
        } else {    // one box of 128 rows x 64 K values
          tma_load_2d(a, tma_a, &full[s], k0, m0);
        }
        if (kTB) {  // one box of 128 N rows x 64 K values
          tma_load_2d(b, tma_b, &full[s], k0, n0);
        } else {    // two boxes of 64 K rows x 64 of the N columns
          tma_load_2d(b, tma_b, &full[s], n0, k0);
          tma_load_2d(b + kGemmBoxBytes, tma_b, &full[s], n0 + 64, k0);
        }
      }
    }
  } else if (wg >= 3) {
    // epilogue: each staged tile to C
    const int et = threadIdx.x - 3 * 128;
    int i = 0;
    for (int tile = blockIdx.x; tile < num_units; tile += gridDim.x, ++i) {
      const Unit u = unit_of(tile);
      epi(staging, staged, i & 1, et, u.m0, u.n0, u.M, u.N, u.tile, u.split, splits,
          u.problem);
      mbar_arrive(drained);
    }
  } else {
    // MMA warpgroup w multiplies rows 64 w .. 64 w + 63 of each tile
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    // the accumulator fragment: row 16 (warp in group) + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1), j = 0 .. 15
    float* frag = staging + (64 * w + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2)) *
                                kGemmStagePitch + 2 * (lane & 3);
    float d[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) d[r] = 0.f;
    int it = 0, i = 0;
    for (int tile = blockIdx.x; tile < num_units; tile += gridDim.x, ++i) {
      const Unit u = unit_of(tile);
      const int kb0 = u.kb0, kb1 = u.kb1;
      int prev = 0;
      for (int kb = kb0; kb < kb1; ++kb, ++it) {
        const int s = it % kGemmStages;
        mbar_wait(&full[s], (it / kGemmStages) & 1);
        // this warpgroup's 64 rows of A: rows 64 w .. of the K-major box,
        // or the second 64-column box of the MN-major pair; both 8 KB on
        const uint32_t a = smem_u32(smem + s * kGemmStageBytes) + w * kGemmBoxBytes;
        const uint32_t b = smem_u32(smem + s * kGemmStageBytes + kGemmABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGemmBK / 16; ++kk) {
          // K-major: 16 columns = 32 bytes along the swizzled rows, 8-row
          // groups 1 KB apart; MN-major: 16 K rows = 2 KB down, the 64-column
          // boxes 8 KB apart
          const uint64_t da = kTA ? smem_desc(a + 2048 * kk, kGemmBoxBytes, 1024)
                                  : smem_desc(a + 32 * kk, 16, 1024);
          const uint64_t db = kTB ? smem_desc(b + 32 * kk, 16, 1024)
                                  : smem_desc(b + 2048 * kk, kGemmBoxBytes, 1024);
          wgmma_m64n128k16<kTA ? 1 : 0, kTB ? 0 : 1>(d, da, db, (kb != kb0) | kk);
        }
        wgmma_commit();
        if (kb > kb0) {
          wgmma_wait<1>();  // the previous slab's products are done with it
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      fence_accumulators(d);
      mbar_wait(drained, (i & 1) ^ 1);  // the epilogue has read the last tile
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(frag + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(frag + 8 * kGemmStagePitch + 8 * j) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
      mbar_arrive(staged);
    }
  }
}

// The TMA map of a row-major (rows, cols) bf16 matrix with row pitch ld (0:
// cols), read in boxes of box_rows x 64 columns (128 bytes) with the
// 128-byte swizzle; out-of-range elements read as zeros.
inline cudaError_t bf16_tma_map(CUtensorMap* map, const bf16* base, int rows, int cols,
                                int box_rows, int ld = 0) {
  return swizzled_tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), base, rows, cols,
                          box_rows, ld);
}

// The kernel's dynamic shared memory opt-in, once per form.
template <bool kTA, bool kTB, typename Epi, int kProblems = 1>
inline cudaError_t gemm_kernel_attributes() {
  static const cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16_kernel<kTA, kTB, Epi, kProblems>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes);
  return err;
}

// Resident blocks an SM (the occupancy call), for reports.
inline int gemm_blocks_per_sm() {
  using Fwd = RowEpilogue<bf16, bf16>;
  if (gemm_kernel_attributes<false, false, Fwd>() != cudaSuccess) return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gemm_bf16_kernel<false, false, Fwd>,
                                                kGemmThreads, kGemmSmemBytes);
  return blocks;
}

// Problem p of a launch: the checks and the tensor maps of one product. lda
// / ldb are the stored row pitches of A and B in elements.
template <bool kTA, bool kTB, int kProblems>
inline cudaError_t gemm_problem(GemmProblems<kProblems>& pr, int p, const bf16* A, int lda,
                                const bf16* B, int ldb, int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || lda % 8 != 0 || ldb % 8 != 0 ||
      ((!kTA || kTB) && K % 8 != 0) || (kTA && M % 8 != 0))
    return cudaErrorInvalidValue;
  if (misaligned16(A) || misaligned16(B)) return cudaErrorMisalignedAddress;
  pr.m[p] = M;
  pr.n[p] = N;
  const cudaError_t err = kTA ? bf16_tma_map(&pr.a[p], A, K, M, 64, lda)
                              : bf16_tma_map(&pr.a[p], A, M, K, kGemmBM, lda);
  if (err != cudaSuccess) return err;
  return kTB ? bf16_tma_map(&pr.b[p], B, N, K, kGemmBN, ldb)
             : bf16_tma_map(&pr.b[p], B, K, N, kGemmBK, ldb);
}

// The launch of prepared problems over K: splits (a SplitSumEpilogue's row
// splits) at least 1; one block an SM at most, fewer for fewer units.
template <bool kTA, bool kTB, typename Epi, int kProblems>
inline cudaError_t launch_gemm_problems(const GemmProblems<kProblems>& pr, int K, int splits,
                                        const Epi& epi, cudaStream_t stream, bool pdl = false) {
  if (splits < 1) return cudaErrorInvalidValue;
  const cudaError_t err = gemm_kernel_attributes<kTA, kTB, Epi, kProblems>();
  if (err != cudaSuccess) return err;
  const int num_k = (K + kGemmBK - 1) / kGemmBK;
  const int k_per_split = (num_k + splits - 1) / splits;
  splits = (num_k + k_per_split - 1) / k_per_split;  // no split without a slab
  int tiles = 0;
  for (int p = 0; p < kProblems; ++p)
    tiles += ((pr.m[p] + kGemmBM - 1) / kGemmBM) * ((pr.n[p] + kGemmBN - 1) / kGemmBN);
  const int units = tiles * splits;
  const int grid = units < sm_count() ? units : sm_count();
  return launch_kernel(gemm_bf16_kernel<kTA, kTB, Epi, kProblems>, grid, kGemmThreads,
                       kGemmSmemBytes, stream, pdl, pr, K, splits, k_per_split, epi);
}

// Any form, one product.
template <bool kTA, bool kTB, typename Epi>
inline cudaError_t launch_gemm_form(const bf16* A, int lda, const bf16* B, int ldb, int M,
                                    int N, int K, int splits, const Epi& epi,
                                    cudaStream_t stream, bool pdl = false) {
  if (M == 0) return cudaSuccess;
  GemmProblems<1> pr;
  const cudaError_t err = gemm_problem<kTA, kTB>(pr, 0, A, lda, B, ldb, M, N, K);
  if (err != cudaSuccess) return err;
  return launch_gemm_problems<kTA, kTB>(pr, K, splits, epi, stream, pdl);
}

// The forward form: A (M, K), B (K, N), both packed. bias may be null (no
// bias), residual may be null (no residual add).
template <typename ResT, typename OutT>
inline cudaError_t launch_gemm_rows(const bf16* A, const bf16* B, OutT* C, const float* bias,
                                    const ResT* residual, int M, int N, int K, int gelu_mode,
                                    cudaStream_t stream) {
  if (misaligned16(C) || misaligned16(bias) || misaligned16(residual))
    return cudaErrorMisalignedAddress;
  return launch_gemm_form<false, false>(A, K, B, N, M, N, K, 1,
                                        RowEpilogue<ResT, OutT>{C, bias, residual, gelu_mode},
                                        stream);
}

// The bf16-row form every sublayer kernel takes.
inline cudaError_t launch_gemm(const bf16* A, const bf16* B, bf16* C, const float* bias,
                               const bf16* residual, int M, int N, int K, int gelu_mode,
                               cudaStream_t stream) {
  return launch_gemm_rows<bf16, bf16>(A, B, C, bias, residual, M, N, K, gelu_mode, stream);
}

}  // namespace
}  // namespace duodiff
