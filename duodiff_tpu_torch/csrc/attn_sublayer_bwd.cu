// K6: the backward of the fused attention sublayer (K1) on Hopper,
//
//   y = x + proj(SDPA(qkv(LN(x)))) + b_proj,  x (B, L, D) bf16,
//   -> dx (bf16), dgamma, dbeta, dWqkv (D, 3A), dbqkv, dWp (A, D), dbp (fp32),
//
// for the unscaled qkv weight: the softmax scale is applied to q in the
// core, as in the Pallas kernel.
//
// Replaces: duodiff_tpu/ops/pallas_block.py _attn_sublayer_bwd_impl
// (kernel _attn_bwd_kernel). As there, nothing but x is saved from the
// forward: LayerNorm, the qkv GEMM and the softmax statistics are
// recomputed. The launches, in order:
//   1. LayerNorm rows -> xn (layernorm.cuh), the qkv GEMM with the fp32 bias
//      -> qkv (gemm.cuh): the forward's own kernels, bf16 where it rounds;
//   2. dm = dy Wp^T (gemm_t.cuh over gemm.cuh), rounded to bf16 as the
//      Pallas kernel does;
//   3. the attention core backward (attn_bwd_core.cuh): merged heads, dq,
//      dk, dv into dqkv (B*L, 3A) bf16;
//   4. the weight gradients dWp = merged^T dy and dWqkv = xn^T dqkv, split
//      over the B*L rows and summed in split order, and dxn = dqkv Wqkv^T in
//      fp32 (gemm_t.cuh over gemm.cuh: wgmma from a TMA ring);
//   5. the LayerNorm backward with + dy and the dgamma / dbeta sums, and
//      the column sums dbp and dbqkv (layernorm_bwd.cuh).
// Bound: ~172 GFLOP at batch 128 (the Pallas cost estimate, :736), of which
// the projection GEMMs are tensor-core bound and the attention core, which
// forms the (L, L) scores twice (row launch, key launch) and dp three times,
// all in registers, is bound by its instruction count as the forward core
// is. The Pallas kernel keeps xn, qkv, dm and dqkv in VMEM; here they go to
// device memory, at its bf16 rounding points, so the split changes no number.
// Deterministic reductions: the weight gradients sum their row splits in
// split order, each waiting on a per-tile flag (gemm_t.cuh), dgamma / dbeta / dbp / dbqkv sum per-block
// partials in block order (layernorm_bwd.cuh), and the core sums dk and dv
// over queries inside one warp; no floating-point atomics, so a repeat call
// gives the same bits.

#include "attn_bwd_core.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_t.cuh"
#include "layernorm.cuh"
#include "layernorm_bwd.cuh"

using duodiff::bf16;

namespace {

// The scratch of one call, carved from one workspace buffer in this order.
struct AttnBwdWorkspace {
  size_t xn, qkv, dm, merged, dqkv, stats, dxn, flags, colsum, ln, total;
};

AttnBwdWorkspace attn_bwd_workspace(int B, int L, int D, int H) {
  const size_t M = static_cast<size_t>(B) * L;
  const size_t A = static_cast<size_t>(H) * duodiff::kBwdDh;
  const size_t flags_wqkv = duodiff::weight_grad_flags(D, static_cast<int>(3 * A));
  const size_t flags_wp = duodiff::weight_grad_flags(static_cast<int>(A), D);
  const size_t max_cols = 3 * A > static_cast<size_t>(D) ? 3 * A : D;
  AttnBwdWorkspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += duodiff::align256(bytes);
    return at;
  };
  w.xn = take(M * D * sizeof(bf16));
  w.qkv = take(M * 3 * A * sizeof(bf16));
  w.dm = take(M * A * sizeof(bf16));
  w.merged = take(M * A * sizeof(bf16));
  w.dqkv = take(M * 3 * A * sizeof(bf16));
  w.stats = take(3 * M * H * sizeof(float));
  w.dxn = take(M * D * sizeof(float));
  w.flags = take(flags_wqkv > flags_wp ? flags_wqkv : flags_wp);
  w.colsum = take(duodiff::colsum_chunks(static_cast<int>(M)) * max_cols * sizeof(float));
  w.ln = take(2 * duodiff::layernorm_bwd_blocks(static_cast<int>(M)) * static_cast<size_t>(D) *
              sizeof(float));
  w.total = off;
  return w;
}

}  // namespace

// Bytes of the workspace duodiff_attn_sublayer_bwd takes.
extern "C" size_t duodiff_attn_sublayer_bwd_workspace(int B, int L, int D, int H) {
  return attn_bwd_workspace(B, L, D, H).total;
}

// The longest sequence the backward core takes: its row launch keeps 16
// whole rows of e in registers (attn_bwd_core.cuh).
extern "C" int duodiff_attn_bwd_core_max_len() { return duodiff::kMaxSeq; }

// x, dy, dx: (B, L, D) bf16; wqkv: (D, 3A) bf16, unscaled; bqkv: (3A,) fp32
// or null; wp: (A, D) bf16; ln_w, ln_b: fp32. Outputs fp32: dg, db (D,),
// dwqkv (D, 3A), dbqkv (3A,) (null iff bqkv is), dwp (A, D), dbp (D,).
// Head width 64, A = H * 64 = D. Returns the first CUDA error, or 0.
extern "C" int duodiff_attn_sublayer_bwd(const void* x, const void* dy, const void* ln_w,
                                         const void* ln_b, const void* wqkv, const void* bqkv,
                                         const void* wp, void* dx, void* dg, void* db,
                                         void* dwqkv, void* dbqkv, void* dwp, void* dbp,
                                         void* workspace, int B, int L, int D, int H, float eps,
                                         void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * L, A = H * kBwdDh;
  const float scale = 1.f / sqrtf(static_cast<float>(kBwdDh));
  const AttnBwdWorkspace w = attn_bwd_workspace(B, L, D, H);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  bf16* qkv = reinterpret_cast<bf16*>(ws + w.qkv);
  bf16* dm = reinterpret_cast<bf16*>(ws + w.dm);
  bf16* merged = reinterpret_cast<bf16*>(ws + w.merged);
  bf16* dqkv = reinterpret_cast<bf16*>(ws + w.dqkv);
  float* stats = reinterpret_cast<float*>(ws + w.stats);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  int* flags = reinterpret_cast<int*>(ws + w.flags);
  float* colsum = reinterpret_cast<float*>(ws + w.colsum);
  float* ln = reinterpret_cast<float*>(ws + w.ln);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const bf16* wq = static_cast<const bf16*>(wqkv);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), xn, M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm(xn, wq, qkv, static_cast<const float*>(bqkv), nullptr, M, 3 * A, D,
                    kGeluNone, s);
  if (err != cudaSuccess) return err;
  // dm = dy Wp^T: Wp (A, D) is the (N, K) layout
  err = launch_gemm_nt(dyb, D, static_cast<const bf16*>(wp), D, dm, M, A, D, s);
  if (err != cudaSuccess) return err;
  err = launch_attn_bwd_core(qkv, dm, merged, dqkv, stats, B, L, H, scale, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(merged, dyb, static_cast<float*>(dwp), flags, A, D, M, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(xn, dqkv, static_cast<float*>(dwqkv), flags, D, 3 * A, M, s);
  if (err != cudaSuccess) return err;
  // dxn = dqkv Wqkv^T: Wqkv (D, 3A) is the (N, K) layout
  err = launch_gemm_nt(dqkv, 3 * A, wq, 3 * A, dxn, M, D, 3 * A, s);
  if (err != cudaSuccess) return err;
  err = launch_layernorm_bwd(xb, dxn, static_cast<const float*>(ln_w), dyb,
                             static_cast<bf16*>(dx), static_cast<float*>(dg),
                             static_cast<float*>(db), ln, M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_colsum(dyb, static_cast<float*>(dbp), colsum, M, D, s);
  if (err != cudaSuccess || bqkv == nullptr) return err;
  return launch_colsum(dqkv, static_cast<float*>(dbqkv), colsum, M, 3 * A, s);
}
