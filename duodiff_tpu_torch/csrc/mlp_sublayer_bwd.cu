// K7: the backward of the fused MLP sublayer (K2) on Hopper,
//
//   y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2,  x (M, D) bf16, hidden Hd,
//   -> dx (bf16), dgamma, dbeta, dW1 (D, Hd), db1, dW2 (Hd, D), db2 (fp32).
//
// Replaces: duodiff_tpu/ops/pallas_block.py _mlp_sublayer_bwd_impl (kernel
// _mlp_bwd_kernel). The launches, in order:
//   1. LayerNorm rows -> xn (layernorm.cuh, the forward's kernel);
//   2. mlp_bwd_hidden_kernel: for each (128 rows, 128 hidden columns) tile,
//      h_pre = xn W1 + b1 and dh = dy W2^T in two fp32 accumulators, and in
//      the epilogue hgb = bf16(gelu(h_pre)), dhp = dh * gelu'(h_pre) stored
//      as bf16, and the tile's fp32 column sums of dhp (db1 partials);
//   3. dW2 = hgb^T dy and dW1 = xn^T dhp, split over the rows, and
//      dxn = dhp W1^T in fp32 (gemm_t.cuh);
//   4. the LayerNorm backward with + dy and the dgamma / dbeta sums, db1
//      from its partials, and db2 = the column sums of dy (layernorm_bwd.cuh).
// GELU is exact (erff) or the tanh form, and its derivative is _gelu_grad's
// (:942) with the exact erff; the Pallas kernel's _erf_poly is a Mosaic
// workaround for the same function.
// Bound: 5 GEMMs of 2 * M * D * Hd flops each (~345 GFLOP at batch 128,
// the Pallas cost estimate :1151), tensor-core bound. The Pallas kernel
// keeps hgb and dhp in VMEM, chunk by chunk; this first design writes both
// to device memory in bf16 (2 x 135 MB at batch 128, read back once each),
// exactly where the Pallas kernel rounds them, so the split changes no
// number and costs ~0.2 ms of bandwidth.
// Deterministic reductions: db1 sums per-tile partials in tile order, the
// weight gradients sum split-K partials in split order, dgamma / dbeta /
// db2 sum per-block partials in block order; inside a tile the column sums
// run in a fixed shuffle order. No floating-point atomics.

#include "common.cuh"
#include "gemm_t.cuh"
#include "layernorm.cuh"
#include "layernorm_bwd.cuh"

using duodiff::bf16;

namespace duodiff {
namespace {

// d gelu(h) / dh in fp32 for both forms (pallas_block._gelu_grad).
__device__ __forceinline__ float gelu_grad(float h, int mode) {
  if (mode == kGeluTanh) {
    const float c = 0.79788456080286536f, a = 0.044715f;
    const float t = tanhf(c * (h + a * h * h * h));
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * c * (1.f + 3.f * a * h * h);
  }
  const float phi = expf(-0.5f * h * h) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  return cdf + h * phi;
}

__global__ void __launch_bounds__(kTThreads)
mlp_bwd_hidden_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ dy,
                      const bf16* __restrict__ w2, bf16* __restrict__ hgb,
                      bf16* __restrict__ dhp, float* __restrict__ db1_part, int M, int D, int Hd,
                      int gelu_mode) {
  __shared__ __align__(128) GemmSmem sm;
  __shared__ float col_s[2][kTBN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kTBM, n0 = blockIdx.x * kTBN;
  Acc acc_h[4][2], acc_d[4][2];
  gemm_mainloop<false, false>(sm, acc_h, xn, D, w1, Hd, M, Hd, m0, n0, 0, D);
  // W2 (Hd, D) is the (N, K) layout of W2^T
  gemm_mainloop<false, true>(sm, acc_d, dy, D, w2, D, M, Hd, m0, n0, 0, D);

  float* cs_h = reinterpret_cast<float*>(sm.a) + warp * 512;
  float* cs_d = cs_h + 256;
  const int r = lane >> 1, c0 = (lane & 1) * kVec;
  float colp[2][kVec];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) colp[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs_h, acc_h[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(cs_d, acc_d[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M && gc < Hd) {
        float hv[kVec], dv[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float h = cs_h[r * 16 + c0 + e] + b1[gc + e];
          hv[e] = gelu(h, gelu_mode);
          dv[e] = cs_d[r * 16 + c0 + e] * gelu_grad(h, gelu_mode);
          colp[j][e] += dv[e];
        }
        const size_t off = static_cast<size_t>(gr) * Hd + gc;
        *reinterpret_cast<uint4*>(hgb + off) = pack8(hv);
        *reinterpret_cast<uint4*>(dhp + off) = pack8(dv);
      }
      __syncwarp();
    }
  }
  // column sums over the warp's 64 rows: lanes of equal parity hold the
  // same 8 columns of 4 rows each
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float v = colp[j][e];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < 2) col_s[wm][wn * 32 + j * 16 + c0 + e] = v;
    }
  }
  __syncthreads();
  const int col = n0 + threadIdx.x;
  if (threadIdx.x < kTBN && col < Hd)
    db1_part[static_cast<size_t>(blockIdx.y) * Hd + col] = col_s[0][threadIdx.x] + col_s[1][threadIdx.x];
}

struct MlpBwdWorkspace {
  size_t xn, hgb, dhp, dxn, split, db1, colsum, ln, total;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

int row_tiles(int M) { return (M + kTBM - 1) / kTBM; }

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
  w.split = take(static_cast<size_t>(kMaxSplits) * D * Hd * sizeof(float));
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
  float* split = reinterpret_cast<float*>(ws + w.split);
  float* db1_part = reinterpret_cast<float*>(ws + w.db1);
  float* colsum = reinterpret_cast<float*>(ws + w.colsum);
  float* ln = reinterpret_cast<float*>(ws + w.ln);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const bf16* w1b = static_cast<const bf16*>(w1);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_w),
                                     static_cast<const float*>(ln_b), xn, M, D, eps, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hd + kTBN - 1) / kTBN, row_tiles(M));
  mlp_bwd_hidden_kernel<<<grid, kTThreads, 0, s>>>(xn, w1b, static_cast<const float*>(b1), dyb,
                                                    static_cast<const bf16*>(w2), hgb, dhp,
                                                    db1_part, M, D, Hd, gelu_mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(db1_part, static_cast<float*>(db1), row_tiles(M), Hd, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(hgb, dyb, static_cast<float*>(dw2), split, Hd, D, M, s);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad(xn, dhp, static_cast<float*>(dw1), split, D, Hd, M, s);
  if (err != cudaSuccess) return err;
  // dxn = dhp W1^T: W1 (D, Hd) is the (N, K) layout
  err = launch_gemm_t<false, true>(dhp, Hd, w1b, Hd, dxn, M, D, Hd, 1, false, s);
  if (err != cudaSuccess) return err;
  err = launch_layernorm_bwd(xb, dxn, static_cast<const float*>(ln_w), dyb,
                             static_cast<bf16*>(dx), static_cast<float*>(dg),
                             static_cast<float*>(db), ln, M, D, eps, s);
  if (err != cudaSuccess) return err;
  return launch_colsum(dyb, static_cast<float*>(db2), colsum, M, D, s);
}
