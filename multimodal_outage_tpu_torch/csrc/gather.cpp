// Threaded host gather of whole frames from the packed NTL store.
//
// The host input path (data/pipeline.py PrefetchIterator) assembles a
// batch by copying the frames of its windows out of the memory-mapped
// [D, N, H, W] float32 store into one contiguous buffer, which it then
// copies to the card. numpy fancy indexing runs that copy on one thread;
// this library splits the per-frame memcpys over a few threads, which
// keeps several page-cache reads in flight on a cold memmap and fills the
// host's memory bandwidth on a warm one. It is host code, not the
// counterpart of a TPU kernel: it is the port's own copy of the JAX
// package's native batch gather (the same C interface), and it is built
// by data/native.py with the host C++ compiler.
//
// The destination may be page-locked (pinned) memory: the prefetcher
// gathers straight into the buffer it copies to the card from, so the
// batch crosses host memory once.
//
// ABI (ctypes, see data/native.py):
//   gather_f32(src, indices, dst, n, frame_elems, n_threads)
//     src         : const float*   frame store base, [D * frame_elems]
//     indices     : const int64*   n frame positions, each in [0, D)
//     dst         : float*         n * frame_elems output
//     frame_elems : elements of one frame (N * H * W)
//     returns 0 on success, 1 if a worker thread could not be started
//     (the threads already started are joined first).
// The caller checks the positions' range; nothing here reads D.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int gather_f32(const float* src, const std::int64_t* indices, float* dst,
               std::int64_t n, std::int64_t frame_elems, int n_threads) {
  if (n <= 0 || frame_elems <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n);

  const std::size_t frame_bytes = sizeof(float) * static_cast<std::size_t>(frame_elems);
  auto worker = [&](std::int64_t begin, std::int64_t end) {
    for (std::int64_t i = begin; i < end; ++i) {
      std::memcpy(dst + i * frame_elems, src + indices[i] * frame_elems, frame_bytes);
    }
  };

  if (n_threads == 1) {
    worker(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const std::int64_t chunk = (n + n_threads - 1) / n_threads;
  int rc = 0;
  try {
    for (int t = 0; t < n_threads; ++t) {
      const std::int64_t begin = t * chunk;
      const std::int64_t end = begin + chunk < n ? begin + chunk : n;
      if (begin >= end) break;
      threads.emplace_back(worker, begin, end);
    }
  } catch (...) {  // std::system_error: no exception may cross the C ABI
    rc = 1;
  }
  for (auto& th : threads) th.join();
  return rc;
}

}  // extern "C"
