// Threaded row gather for the port's host data path.
//
// The hot host-side operation of a training step fed from the host is
// assembling a batch from a dataset array with fancy indexing (one
// row-gather per modality per step). numpy's take is a single-threaded
// memcpy; this spreads the row copies over threads, so a large multimodal
// batch (PolyMNIST: 5 x (256, 3, 28, 28) float32) is assembled at memory
// bandwidth. Built with g++ by ``ops/cuda_build.py``, called through ctypes
// by ``data/native_gather.py``.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[i] = src[idx[i]] for i in [0, n_idx); a row is row_bytes long. The
// caller guarantees 0 <= idx[i] < the number of rows of src.
void gather_rows(const char* src, const int64_t* idx, char* dst,
                 int64_t n_idx, int64_t row_bytes, int n_threads) {
  auto copy = [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
  };
  if (n_threads <= 1 || n_idx < int64_t(n_threads) * 4) {
    copy(0, n_idx);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, n_idx);
    if (lo >= hi) break;
    workers.emplace_back(copy, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
