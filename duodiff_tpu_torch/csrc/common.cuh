// Shared device helpers of the kernels: bf16 vector access, warp
// reductions, GELU, cp.async with zero-fill for ragged tile edges, and the
// strided (sample, head, row) view the attention cores read and write.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace duodiff {
namespace {

using bf16 = __nv_bfloat16;

// 8 bf16 values = one 16-byte vector access.
constexpr int kVec = 8;

// Programmatic dependent launch: a kernel launched with launch_kernel(...,
// pdl = true) is set up on the SMs as the kernel before it on the stream
// drains, not after it has finished; it calls grid_dependency_wait() before
// it touches device memory, which holds it until that kernel has finished
// and its writes are visible. A no-op in a kernel launched the ordinary way.
// (No kernel here signals its dependents early: blocks that wait hold SMs
// that the kernel before them still needs, which measured slower.)
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename... Params, typename... Args>
inline cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t stream, bool pdl, Args... args) {
  if (!pdl) {
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// Offsets into a workspace start on 256-byte boundaries.
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// A launcher's check of an operand that its kernel reads or writes in 16-byte
// vectors or by TMA (null passes).
inline bool misaligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

__device__ __forceinline__ void unpack8(const uint4& raw, float out[kVec]) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = __bfloat162float(p[e]);
}

__device__ __forceinline__ uint4 pack8(const float in[kVec]) {
  uint4 raw;
  bf16* p = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) p[e] = __float2bfloat16(in[e]);
  return raw;
}

__device__ __forceinline__ uint4 scale8(const uint4& raw, float s) {
  float v[kVec];
  unpack8(raw, v);
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] *= s;
  return pack8(v);
}

// 8 consecutive values of a bf16 or an fp32 row, as fp32: the kernels whose
// rows come in either type (the whole-block kernel keeps its intermediate
// residual stream in fp32) are templates over the row type and read and
// write through these.
__device__ __forceinline__ void load_row8(const bf16* p, float out[kVec]) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

__device__ __forceinline__ void load_row8(const float* p, float out[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store_row8(bf16* p, const float in[kVec]) {
  *reinterpret_cast<uint4*>(p) = pack8(in);
}

__device__ __forceinline__ void store_row8(float* p, const float in[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

// The rows of every (sample, head) of a bf16 tensor, wherever they lie: row
// l of head h of sample b starts at p + b * sample + h * head + l * row
// (strides in elements; a row is the head's Dh contiguous values). The
// attention cores take their operands as such views, so one kernel serves
// the packed (B, L, 3A) qkv of the fused sublayers and the separate
// (B, H, L, Dh) tensors of the standalone attention.
template <typename T>
struct HeadRows {
  T* p;
  size_t sample, head, row;
  __host__ __device__ T* at(int b, int h) const { return p + b * sample + h * head; }
};

// Third `which` (0 q, 1 k, 2 v) of a packed (B, L, 3A) tensor, A = H * Dh.
template <typename T>
inline HeadRows<T> packed_third(T* qkv, int which, int L, int H, int Dh) {
  const size_t A = static_cast<size_t>(H) * Dh;
  return {qkv + which * A, L * 3 * A, static_cast<size_t>(Dh), 3 * A};
}

// Merged heads (B, L, A).
template <typename T>
inline HeadRows<T> merged_heads(T* t, int L, int H, int Dh) {
  const size_t A = static_cast<size_t>(H) * Dh;
  return {t, L * A, static_cast<size_t>(Dh), A};
}

// Split heads (B, H, L, Dh), contiguous.
template <typename T>
inline HeadRows<T> split_heads(T* t, int L, int H, int Dh) {
  const size_t LD = static_cast<size_t>(L) * Dh;
  return {t, H * LD, LD, static_cast<size_t>(Dh)};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// GELU of the MLP sublayers in fp32: exact (erff) or the tanh form.
enum GeluMode : int { kGeluNone = 0, kGeluErf = 1, kGeluTanh = 2 };

__device__ __forceinline__ float gelu(float v, int mode) {
  if (mode == kGeluErf) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  if (mode == kGeluTanh) {
    const float u = 0.79788456080286536f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(u));
  }
  return v;
}

// 16-byte global -> shared copy; with pred false it writes 16 zero bytes
// and reads nothing (the src-size operand is 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
}  // namespace duodiff
