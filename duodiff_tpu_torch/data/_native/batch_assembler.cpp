// Batch assembly for the data loader (the port's own copy of
// duodiff_tpu/data/_native/batch_assembler.cpp).
//
// One pass from the decoded items (uint8 HWC) to the contiguous NHWC float32
// batch, with the dataset's scale and offset applied, parallel across images
// on a few threads. The JAX package's copy writes `src * scale + offset`,
// which g++ contracts into one fused multiply-add on a host with FMA
// (-O3 -march=native); this one writes std::fma, so every entry is rounded
// once by construction, whatever the compiler flags: out = fl(src * scale +
// offset), the exact value rounded once to float32. On x86-64 the row loop
// is also compiled for CPUs with FMA instructions, where it vectorises, and
// the dynamic linker picks that clone when the library loads
// (target_clones); elsewhere std::fma calls the C library's fmaf, with the
// same bits, ~10x slower.
//
// C ABI (ctypes):
//   assemble_batch(srcs, n, hwc_elems, scale, offset, out, n_threads)
//     srcs:  n pointers to uint8 buffers of hwc_elems each
//     out:   float32 buffer of n * hwc_elems
//     out[i][j] = fma(float(srcs[i][j]), scale, offset)

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target_clones("fma", "default")))
#endif
void assemble_rows(const uint8_t* const* srcs, int64_t begin, int64_t end,
                   int64_t hwc_elems, float scale, float offset, float* out) {
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* src = srcs[i];
    float* dst = out + i * hwc_elems;
    for (int64_t j = 0; j < hwc_elems; ++j) {
      dst[j] = std::fma(static_cast<float>(src[j]), scale, offset);
    }
  }
}

}  // namespace

extern "C" {

void assemble_batch(const uint8_t** srcs, int64_t n, int64_t hwc_elems,
                    float scale, float offset, float* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    assemble_rows(srcs, begin, end, hwc_elems, scale, offset, out);
  };

  if (n_threads == 1 || n < 2) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * per;
    int64_t e = b + per < n ? b + per : n;
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
