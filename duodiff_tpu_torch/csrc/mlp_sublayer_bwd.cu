// K7: the backward of the fused MLP sublayer (K2) on Hopper,
//
//   y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2,  x (M, D) bf16, hidden Hd,
//   -> dx (bf16), dgamma, dbeta, dW1 (D, Hd), db1, dW2 (Hd, D), db2 (fp32).
//
// Replaces: duodiff_tpu/ops/pallas_block.py _mlp_sublayer_bwd_impl (kernel
// _mlp_bwd_kernel). The launches, in order:
//   1. LayerNorm rows -> xn (layernorm.cuh, the forward's kernel);
//   2. mlp_bwd_hidden_kernel (mlp_bwd_hidden.cuh): for each (128 rows, 64
//      hidden columns) tile, h_pre = xn W1 + b1 and dh = dy W2^T in two fp32
//      accumulators, and in the epilogue warpgroups hgb = bf16(gelu(h_pre)),
//      dhp = dh * gelu'(h_pre) stored as bf16, and the tile's fp32 column
//      sums of dhp (db1 partials);
//   3. dW2 = hgb^T dy and dW1 = xn^T dhp, split over the rows and summed in
//      split order, and dxn = dhp W1^T in fp32 (gemm_t.cuh over gemm.cuh);
//   4. the LayerNorm backward with + dy and the dgamma / dbeta sums, db1
//      from its partials, and db2 = the column sums of dy (layernorm_bwd.cuh).
// GELU is exact (erff) or the tanh form, and its derivative is _gelu_grad's
// (:942) with the exact erff; the Pallas kernel's _erf_poly is a Mosaic
// workaround for the same function.
// Bound: 5 GEMMs of 2 * M * D * Hd flops each (~345 GFLOP at batch 128,
// the Pallas cost estimate :1151), tensor-core bound, all of them wgmma
// from a TMA-fed ring. The Pallas kernel keeps hgb and dhp in VMEM, chunk by
// chunk; this design writes both to device memory in bf16 (2 x 135 MB at batch 128, read back once each),
// exactly where the Pallas kernel rounds them, so the split changes no
// number and costs ~0.2 ms of bandwidth.
// Deterministic reductions: db1 sums per-tile partials in tile order, the
// weight gradients sum their row splits in split order (per-tile flags), dgamma / dbeta /
// db2 sum per-block partials in block order; inside a tile the column sums
// run in a fixed shuffle order. No floating-point atomics.

#include "common.cuh"
#include "gemm_t.cuh"
#include "layernorm.cuh"
#include "layernorm_bwd.cuh"
#include "mlp_bwd_hidden.cuh"

using duodiff::bf16;

namespace duodiff {
namespace {

struct MlpBwdWorkspace {
  size_t xn, hgb, dhp, dxn, flags, db1, colsum, ln, total;
};

MlpBwdWorkspace mlp_bwd_workspace(int M, int D, int Hd) {
  const size_t m = static_cast<size_t>(M);
  MlpBwdWorkspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.xn = take(m * D * sizeof(bf16));
  w.hgb = take(m * Hd * sizeof(bf16));
  w.dhp = take(m * Hd * sizeof(bf16));
  w.dxn = take(m * D * sizeof(float));
  w.flags = take(weight_grad_flags(D, Hd));  // dW2 (Hd, D) has as many tiles
  w.db1 = take(static_cast<size_t>(row_tiles(M)) * Hd * sizeof(float));
  w.colsum = take(static_cast<size_t>(colsum_chunks(M)) * D * sizeof(float));
  w.ln = take(2 * static_cast<size_t>(layernorm_bwd_blocks(M)) * D * sizeof(float));
  w.total = off;
  return w;
}

}  // namespace
}  // namespace duodiff

// Bytes of the workspace duodiff_mlp_sublayer_bwd takes.
extern "C" size_t duodiff_mlp_sublayer_bwd_workspace(int M, int D, int Hd) {
  return duodiff::mlp_bwd_workspace(M, D, Hd).total;
}

// x, dy, dx: (M, D) bf16; w1: (D, Hd) bf16; w2: (Hd, D) bf16; ln_w, ln_b,
// b1: fp32. Outputs fp32: dg, db (D,), dw1 (D, Hd), db1 (Hd,), dw2 (Hd, D),
// db2 (D,). gelu_mode: 1 exact (erf), 2 tanh. Returns the first CUDA error,
// or 0.
extern "C" int duodiff_mlp_sublayer_bwd(const void* x, const void* dy, const void* ln_w,
                                        const void* ln_b, const void* w1, const void* b1,
                                        const void* w2, void* dx, void* dg, void* db, void* dw1,
                                        void* db1, void* dw2, void* db2, void* workspace, int M,
                                        int D, int Hd, int gelu_mode, float eps, void* stream) {
  using namespace duodiff;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MlpBwdWorkspace w = mlp_bwd_workspace(M, D, Hd);
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

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), xn, M, D, eps, s);
  if (err != cudaSuccess) return err;
  err = launch_mlp_bwd_hidden(xn, w1b, Hd, static_cast<const float*>(b1), dyb,
                              static_cast<const bf16*>(w2), hgb, dhp, db1_part, M, D, Hd,
                              gelu_mode, s);
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(db1_part, static_cast<float*>(db1), row_tiles(M), Hd, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(hgb, dyb, static_cast<float*>(dw2), flags, Hd, D, M, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(xn, dhp, static_cast<float*>(dw1), flags, D, Hd, M, s);
  if (err != cudaSuccess) return err;
  // dxn = dhp W1^T: W1 (D, Hd) is the (N, K) layout
  err = launch_gemm_nt(dhp, Hd, w1b, Hd, dxn, M, D, Hd, s);
  if (err != cudaSuccess) return err;
  err = launch_layernorm_bwd(xb, dxn, static_cast<const float*>(ln_w), dyb,
                             static_cast<bf16*>(dx), static_cast<float*>(dg),
                             static_cast<float*>(db), ln, M, D, eps, s);
  if (err != cudaSuccess) return err;
  return launch_colsum(dyb, static_cast<float*>(db2), colsum, M, D, s);
}
