// The Hopper pieces the tensor-core kernels are built from (gemm.cuh, bf16,
// forward and backward forms; mlp_bwd_hidden.cuh; gemm_int8.cuh, int8):
// mbarriers with a wait that traps instead of hanging, 2-D TMA loads into
// shared memory, wgmma shared-memory descriptors with the 128-byte swizzle
// and the wgmma fences, the per-tile flags by which the row splits of a
// weight gradient hand their sums on in order, and on the host the TMA map
// encoder, looked up through the CUDA runtime so that nothing links -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace duodiff {
namespace {

// A wait on an mbarrier that does not complete within this traps, so a fault
// in a ring ends its kernel with an error instead of hanging the card.
constexpr unsigned long long kHangNs = 10000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete; trap after kHangNs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > kHangNs) {
      __trap();
    }
  }
}

// Wait until the flag, set by another block of the same launch, holds
// `value` (acquire: what that block wrote before setting it is visible);
// trap after kHangNs.
__device__ __forceinline__ void flag_wait(const int* flag, int value) {
  uint64_t start = 0;
  while (true) {
    int now_value;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(now_value) : "l"(flag) : "memory");
    if (now_value == value) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > kHangNs) {
      __trap();
    }
  }
}

// Set the flag (release: the block's writes before it are visible to the
// block that acquires it; the writing threads fence and meet at a barrier
// first).
__device__ __forceinline__ void flag_set(int* flag, int value) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(flag), "r"(value) : "memory");
}

// One 2-D TMA box (inner coordinate c0, outer c1) into shared memory,
// completing on the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_tma_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Hand registers back to the block's pool (a warpgroup that needs few), or
// take more from it (one that needs many); every warp of the warpgroup
// executes it. N is a multiple of 8 in [24, 256].
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// cuTensorMapEncodeTiled, looked up by name through the CUDA runtime, so the
// library links no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, cols) matrix of `elem_bytes`-byte
// elements whose rows lie `ld` elements apart (ld 0: cols, packed rows; a
// column slice of a wider matrix keeps the whole width as its pitch), read
// in boxes of box_rows rows x 128 bytes with the 128-byte swizzle;
// out-of-range elements, past rows or past cols, read as zeros.
inline cudaError_t swizzled_tma_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                                    const void* base, int rows, int cols, int box_rows,
                                    int ld = 0) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld > 0 ? ld : cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

}  // namespace
}  // namespace duodiff
