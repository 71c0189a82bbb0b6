// K8: the backward of the fused MLP sublayer (K2) in bounded scratch, by
// chunks of the rows, on Hopper,
//
//   y = x + fc2(gelu(fc1(LN(x)) + b1)) + b2,  x (M, D) bf16, hidden Hd,
//   -> dx (bf16), dgamma, dbeta, dW1 (D, Hd), db1, dW2 (Hd, D), db2 (fp32).
//
// Replaces: duodiff_tpu/ops/pallas_block.py _mlp_sublayer_bwd_split (kernel
// _mlp_bwd_partial_kernel, one pallas_call per slice of the hidden width,
// and the XLA recombination after it :1339-1357). What `splits` cuts differs
// between the two machines, and the function does not:
//   - on the TPU (and in the plain version, mlp_sublayer_bwd_split_plain) it
//     cuts the hidden width, because the slice's fp32 dW accumulators have
//     to fit VMEM (:1174-1182), and every slice adds an fp32 dxn partial;
//   - here it cuts the M rows into chunks and runs K7's sequence
//     (mlp_sublayer_bwd.cu) on each chunk over the whole hidden width. The
//     scratch that bounds is hgb and dhp, (M / splits) x Hd bf16 each, the
//     same bytes as one hidden slice of all rows, and dxn, a chunk's fp32
//     rows; xn is K7's, all rows in bf16, normalised once.
// Cutting the hidden width on this card cost every slice a read of xn and
// dy, a read and write of the fp32 dxn, and two under-filled weight-gradient
// launches of D x D / splits tiles; cutting the rows pays none of these.
// Chunks are row_tiles(M) / splits 128-row tiles, rounded up (chunk_rows),
// and the last chunk takes the rest, ragged or short; a small M makes fewer
// chunks than `splits`. Whole tiles keep the hidden stage's per-tile db1
// partials where one launch over all M rows puts them, so db1, db2, dxn and
// dx are K7's to the bit. The ragged last chunk is one more short chunk: TMA
// reads its missing rows as zeros, and the stores stop at its end.
// The launches: LayerNorm rows -> xn of all M rows (layernorm.cuh), then for
// each chunk c (rows r0 .. r0 + rows), in order:
//   1. mlp_bwd_hidden_kernel (mlp_bwd_hidden.cuh) on the whole hidden width:
//      hgb and dhp of the chunk in bf16, its db1 partials;
//   2. dW2 += hgb^T dy and dW1 += xn^T dhp as one launch of both products
//      (launch_weight_grad_pair over gemm.cuh): the chunk's rows split and
//      summed in split order, and every chunk after the first adds to the
//      sums of the chunks before;
//   3. dxn = dhp W1^T over the whole hidden width in one fp32 accumulator
//      (launch_gemm_nt, K = Hd): no partial over slices;
//   4. the LayerNorm backward of the chunk with + dy, and its dgamma / dbeta
//      partials by blocks of split_lnb_rows rows (layernorm_bwd.cuh): dx of
//      the chunk is final here.
// Then, once: db1, dgamma and dbeta from their partials in order, and db2 =
// the column sums of dy.
// The rounding points are K7's and the Pallas kernel's: xn, hgb, dhp and dy
// in bf16 before the weight-gradient products, every accumulator fp32. Only
// the order of fp32 sums differs from K7's (and from the plain version's
// slice order): dW1 and dW2 by row splits inside a chunk, then chunks in
// order; dgamma and dbeta by smaller blocks where a chunk is small.
// Bound: the same 5 GEMMs of 2 * M * D * Hd flops as K7, tensor-core bound.
// Beside K7 a chunk pays its launches, one read and write of both fp32
// weight gradients (~19 MB at D = 768, from L2 in part), and a LayerNorm
// backward over only its rows. Each launch of a persistent kernel ramps up
// and drains on its own (~5 us), so the chunks' launches go out as
// programmatic dependent launches (launch_kernel): each is launched and set
// up while the one before it drains, and waits for it to finish before it
// touches memory. A chunk too small to give every SM a LayerNorm-backward
// block of K7's 64 rows takes smaller blocks (split_lnb_rows), for more
// partials.
// Deterministic as K7 is: per-tile partials summed in tile order, row
// splits in split order, chunks in chunk order; no floating-point atomics.

#include "common.cuh"
#include "gemm_t.cuh"
#include "layernorm.cuh"
#include "layernorm_bwd.cuh"
#include "mlp_bwd_hidden.cuh"

using duodiff::bf16;

namespace duodiff {
namespace {

// Rows of a chunk: whole 128-row tiles, row_tiles(M) / splits rounded up.
inline int chunk_rows(int M, int splits) {
  return (row_tiles(M) + splits - 1) / splits * kHidBM;
}

// Rows a LayerNorm-backward block of a chunk takes: K7's kLnbRows, halved
// (down to one row a warp) while the chunk would give at most half the SMs a
// block, so that a small chunk still spreads over the card.
inline int split_lnb_rows(int chunk) {
  int rows = kLnbRows;
  while (rows > kLnbWarps && 2 * layernorm_bwd_blocks(chunk, rows) <= sm_count()) rows /= 2;
  return rows;
}

struct MlpBwdSplitWorkspace {
  size_t xn, hgb, dhp, dxn, flags, db1, colsum, ln, total;
};

MlpBwdSplitWorkspace mlp_bwd_split_workspace(int M, int D, int Hd, int splits) {
  const int chunk = chunk_rows(M, splits);
  const size_t rows = static_cast<size_t>(chunk < M ? chunk : M);
  MlpBwdSplitWorkspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.xn = take(static_cast<size_t>(M) * D * sizeof(bf16));
  w.hgb = take(rows * Hd * sizeof(bf16));
  w.dhp = take(rows * Hd * sizeof(bf16));
  w.dxn = take(rows * D * sizeof(float));
  w.flags = take(2 * weight_grad_flags(D, Hd));  // dW2 and dW1, as many tiles each
  w.db1 = take(static_cast<size_t>(row_tiles(M)) * Hd * sizeof(float));
  w.colsum = take(static_cast<size_t>(colsum_chunks(M)) * D * sizeof(float));
  w.ln = take(2 * static_cast<size_t>(layernorm_bwd_blocks(M, split_lnb_rows(rows))) * D *
              sizeof(float));
  w.total = off;
  return w;
}

}  // namespace
}  // namespace duodiff

// Rows of each chunk duodiff_mlp_sublayer_bwd_split cuts M rows into (the
// last chunk takes what is left).
extern "C" int duodiff_mlp_sublayer_bwd_split_chunk_rows(int M, int splits) {
  return duodiff::chunk_rows(M, splits);
}

// Bytes of the workspace duodiff_mlp_sublayer_bwd_split takes.
extern "C" size_t duodiff_mlp_sublayer_bwd_split_workspace(int M, int D, int Hd, int splits) {
  return duodiff::mlp_bwd_split_workspace(M, D, Hd, splits).total;
}

// x, dy, dx: (M, D) bf16; w1: (D, Hd) bf16; w2: (Hd, D) bf16; ln_w, ln_b,
// b1: fp32. Outputs fp32: dg, db (D,), dw1 (D, Hd), db1 (Hd,), dw2 (Hd, D),
// db2 (D,). splits (the row chunks, at most) divides Hd into slices of a
// multiple of 8 columns, the plain version's condition. gelu_mode: 1 exact
// (erf), 2 tanh. Returns the first CUDA error, or 0.
extern "C" int duodiff_mlp_sublayer_bwd_split(const void* x, const void* dy, const void* ln_w,
                                              const void* ln_b, const void* w1, const void* b1,
                                              const void* w2, void* dx, void* dg, void* db,
                                              void* dw1, void* db1, void* dw2, void* db2,
                                              void* workspace, int M, int D, int Hd, int splits,
                                              int gelu_mode, float eps, void* stream) {
  using namespace duodiff;
  if (splits < 1 || Hd % splits != 0 || (Hd / splits) % kVec != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  float* ln_dg = ln;
  const float* gamma = static_cast<const float*>(ln_w);
  const bf16* w1b = static_cast<const bf16*>(w1);

  const int chunk = chunk_rows(M, splits);
  const int ln_rows = split_lnb_rows(chunk < M ? chunk : M);
  const int ln_blocks = layernorm_bwd_blocks(M, ln_rows);
  float* ln_db = ln + static_cast<size_t>(ln_blocks) * D;
  // the pair launches leave their flags zero: one clearing for the chain
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * weight_grad_flags(D, Hd), s);
  if (err != cudaSuccess) return err;
  err = launch_layernorm(static_cast<const bf16*>(x), gamma, static_cast<const float*>(ln_b), xn,
                         M, D, eps, s);
  if (err != cudaSuccess) return err;
  // every launch of the chunks below may start while the one before it
  // drains, and waits for it before it touches memory (launch_kernel)
  const bool pdl = true;
  for (int r0 = 0; r0 < M; r0 += chunk) {
    const int rows = M - r0 < chunk ? M - r0 : chunk;
    const size_t at = static_cast<size_t>(r0) * D;
    const bf16* xc = static_cast<const bf16*>(x) + at;
    const bf16* dyc = static_cast<const bf16*>(dy) + at;
    const bf16* xnc = xn + at;
    err = launch_mlp_bwd_hidden(xnc, w1b, Hd, static_cast<const float*>(b1), dyc,
                                static_cast<const bf16*>(w2), hgb, dhp,
                                db1_part + static_cast<size_t>(r0 / kHidBM) * Hd, rows, D, Hd,
                                gelu_mode, s, pdl);
    if (err != cudaSuccess) return err;
    // dW2 (Hd, D) (+)= hgb^T dy and dW1 (D, Hd) (+)= xn^T dhp over the chunk
    err = launch_weight_grad_pair(hgb, dyc, static_cast<float*>(dw2), xnc, dhp,
                                  static_cast<float*>(dw1), flags, Hd, D, D, Hd, rows, r0 > 0, s,
                                  pdl);
    if (err != cudaSuccess) return err;
    // dxn = dhp W1^T: W1 (D, Hd) is the (N, K) layout
    err = launch_gemm_nt(dhp, Hd, w1b, Hd, dxn, rows, D, Hd, s, pdl);
    if (err != cudaSuccess) return err;
    const size_t part = static_cast<size_t>(r0 / ln_rows) * D;
    err = launch_layernorm_bwd_rows(xc, dxn, gamma, dyc, static_cast<bf16*>(dx) + at,
                                    ln_dg + part, ln_db + part, rows, D, eps, s, ln_rows, pdl);
    if (err != cudaSuccess) return err;
  }
  err = launch_sum_partials(db1_part, static_cast<float*>(db1), row_tiles(M), Hd, s);
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(ln_dg, static_cast<float*>(dg), ln_blocks, D, s);
  if (err != cudaSuccess) return err;
  err = launch_sum_partials(ln_db, static_cast<float*>(db), ln_blocks, D, s);
  if (err != cudaSuccess) return err;
  return launch_colsum(static_cast<const bf16*>(dy), static_cast<float*>(db2), colsum, M, D, s);
}
