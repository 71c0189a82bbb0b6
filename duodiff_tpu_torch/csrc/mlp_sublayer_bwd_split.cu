// K8: the backward of the fused MLP sublayer (K2) by slices of the hidden
// width, on Hopper,
//
//   y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2,  x (M, D) bf16, hidden Hd,
//   -> dx (bf16), dgamma, dbeta, dW1 as `splits` slices (D, Hd / splits),
//      db1, dW2 (Hd, D), db2 (fp32).
//
// Replaces: duodiff_tpu/ops/pallas_block.py _mlp_sublayer_bwd_split (kernel
// _mlp_bwd_partial_kernel, one pallas_call per slice, and the XLA
// recombination after it :1339-1357). The launches, in order:
//   1. LayerNorm rows -> xn (layernorm.cuh), once;
//   2. for each slice s of the hidden width, in order:
//      a. mlp_bwd_hidden_kernel (mlp_bwd_hidden.cuh) on w1[:, s], b1[s] and
//         w2[s, :]: hgb and dhp of the slice in bf16, db1[s] from its
//         per-tile partials;
//      b. dW2[s, :] = hgb^T dy and dW1[:, s] = xn^T dhp, split over the rows
//         and summed in split order (gemm_t.cuh over gemm.cuh);
//      c. the slice's dxn partial dhp W1[:, s]^T (the same GEMM, W1's slice
//         read by TMA with the whole width as row pitch): slice 0 writes the
//         fp32 dxn buffer, every later slice adds its fp32 product to it in
//         the epilogue, so the partials are summed in slice order and never
//         rounded below fp32 (the `dxn + dxn_s` of :1334);
//   3. once at the end, the LayerNorm backward with + dy and the dgamma /
//      dbeta sums, and db2 = the column sums of dy (layernorm_bwd.cuh).
// The rounding points are K7's and the Pallas kernel's: xn, hgb, dhp and dy
// in bf16 before the weight-gradient products, every accumulator fp32.
// The TPU kernel's row_target / hc tiling only orders fp32 sums inside its
// VMEM and has no counterpart here.
// Bound: the same 5 GEMMs of 2 * M * D * Hd flops as K7, tensor-core bound.
// What the split buys on this card is scratch, not fast memory: K7 keeps
// hgb and dhp of the whole hidden width in device memory (2 * M * Hd bf16),
// K8 one slice of them (1 / splits), beside the fp32 dxn buffer both have.
// What it costs: xn and dy are read once per slice by each product, and
// every slice after the first reads and rewrites the fp32 dxn (M * D * 8
// bytes).
// Deterministic as K7 is: per-tile partials summed in tile order, row
// splits in split order, slices in slice order; no floating-point atomics.

#include "common.cuh"
#include "gemm_t.cuh"
#include "layernorm.cuh"
#include "layernorm_bwd.cuh"
#include "mlp_bwd_hidden.cuh"

using duodiff::bf16;

namespace duodiff {
namespace {

struct MlpBwdSplitWorkspace {
  size_t xn, hgb, dhp, dxn, flags, db1, colsum, ln, total;
};

MlpBwdSplitWorkspace mlp_bwd_split_workspace(int M, int D, int Hd, int splits) {
  const size_t m = static_cast<size_t>(M);
  const int hs = Hd / splits;
  MlpBwdSplitWorkspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.xn = take(m * D * sizeof(bf16));
  w.hgb = take(m * hs * sizeof(bf16));
  w.dhp = take(m * hs * sizeof(bf16));
  w.dxn = take(m * D * sizeof(float));
  w.flags = take(weight_grad_flags(D, hs));
  w.db1 = take(static_cast<size_t>(row_tiles(M)) * hs * sizeof(float));
  w.colsum = take(static_cast<size_t>(colsum_chunks(M)) * D * sizeof(float));
  w.ln = take(2 * static_cast<size_t>(layernorm_bwd_blocks(M)) * D * sizeof(float));
  w.total = off;
  return w;
}

}  // namespace
}  // namespace duodiff

// Bytes of the workspace duodiff_mlp_sublayer_bwd_split takes.
extern "C" size_t duodiff_mlp_sublayer_bwd_split_workspace(int M, int D, int Hd, int splits) {
  return duodiff::mlp_bwd_split_workspace(M, D, Hd, splits).total;
}

// x, dy, dx: (M, D) bf16; w1: (D, Hd) bf16; w2: (Hd, D) bf16; ln_w, ln_b,
// b1: fp32. Outputs fp32: dg, db (D,), dw1 (splits, D, Hd / splits), slice s
// holding dW1[:, s], db1 (Hd,), dw2 (Hd, D), db2 (D,). splits divides Hd and
// Hd / splits is a multiple of 8. gelu_mode: 1 exact (erf), 2 tanh. Returns
// the first CUDA error, or 0.
extern "C" int duodiff_mlp_sublayer_bwd_split(const void* x, const void* dy, const void* ln_w,
                                              const void* ln_b, const void* w1, const void* b1,
                                              const void* w2, void* dx, void* dg, void* db,
                                              void* dw1, void* db1, void* dw2, void* db2,
                                              void* workspace, int M, int D, int Hd, int splits,
                                              int gelu_mode, float eps, void* stream) {
  using namespace duodiff;
  if (splits < 1 || Hd % splits != 0 || (Hd / splits) % kVec != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hs = Hd / splits;
  const MlpBwdSplitWorkspace w = mlp_bwd_split_workspace(M, D, Hd, splits);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  bf16* hgb = reinterpret_cast<bf16*>(ws + w.hgb);
  bf16* dhp = reinterpret_cast<bf16*>(ws + w.dhp);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  int* flags = reinterpret_cast<int*>(ws + w.flags);
  float* db1_part = reinterpret_cast<float*>(ws + w.db1);
  float* colsum = reinterpret_cast<float*>(ws + w.colsum);
  float* ln = reinterpret_cast<float*>(ws + w.ln);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b1f = static_cast<const float*>(b1);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), xn, M, D, eps, s);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < splits; ++i) {
    const size_t lo = static_cast<size_t>(i) * hs;
    const bf16* w1s = w1b + lo;             // columns [lo, lo + hs) of (D, Hd)
    const bf16* w2s = w2b + lo * D;         // rows [lo, lo + hs) of (Hd, D)
    err = launch_mlp_bwd_hidden(xn, w1s, Hd, b1f + lo, dyb, w2s, hgb, dhp, db1_part, M, D, hs,
                                gelu_mode, s);
    if (err != cudaSuccess) return err;
    err = launch_sum_partials(db1_part, static_cast<float*>(db1) + lo, row_tiles(M), hs, s);
    if (err != cudaSuccess) return err;
    err = launch_weight_grad(hgb, dyb, static_cast<float*>(dw2) + lo * D, flags, hs, D, M, s);
    if (err != cudaSuccess) return err;
    err = launch_weight_grad(xn, dhp, static_cast<float*>(dw1) + lo * D, flags, D, hs, M, s);
    if (err != cudaSuccess) return err;
    // dxn (+)= dhp W1[:, s]^T: the slice of W1 (D, Hd) is the (N, K) layout
    err = i == 0 ? launch_gemm_nt(dhp, hs, w1s, Hd, dxn, M, D, hs, s)
                 : launch_gemm_nt_accumulate(dhp, hs, w1s, Hd, dxn, M, D, hs, s);
    if (err != cudaSuccess) return err;
  }
  err = launch_layernorm_bwd(xb, dxn, static_cast<const float*>(ln_w), dyb,
                             static_cast<bf16*>(dx), static_cast<float*>(dg),
                             static_cast<float*>(db), ln, M, D, eps, s);
  if (err != cudaSuccess) return err;
  return launch_colsum(dyb, static_cast<float*>(db2), colsum, M, D, s);
}
