// owl_loader — native data plane of the port's host-side loaders (the
// port's own copy of native/owl_loader.cpp; data/native_loader.py builds
// it with g++ into build/kernels/ at first use).
//
// A C++ thread pool assembles windowed batches from per-row .npy blobs by
// positioned reads straight into the output batch buffer: no worker
// processes, no pickling, no Python in the per-item loop.
//
// API (ctypes-friendly, C ABI):
//   owl_gather_windows(paths, byte_offsets, n_items, bytes_per_item,
//                      out, n_threads)
//     For item i: read bytes_per_item bytes from paths[i] at
//     byte_offsets[i] into out + i*bytes_per_item. File descriptors are
//     cached per path. Returns 0 on success, -1-based index of the first
//     failing item otherwise.
//   owl_drop_fd_cache(): close all cached descriptors.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

std::mutex g_fd_mutex;
std::unordered_map<std::string, int> g_fd_cache;

int get_fd(const char* path) {
  std::lock_guard<std::mutex> lock(g_fd_mutex);
  auto it = g_fd_cache.find(path);
  if (it != g_fd_cache.end()) return it->second;
  int fd = ::open(path, O_RDONLY);
  if (fd >= 0) g_fd_cache.emplace(path, fd);
  return fd;
}

bool read_fully(int fd, char* dst, long long nbytes, long long offset) {
  long long done = 0;
  while (done < nbytes) {
    ssize_t r = ::pread(fd, dst + done, nbytes - done, offset + done);
    if (r <= 0) return false;
    done += r;
  }
  return true;
}

}  // namespace

extern "C" {

int owl_gather_windows(const char** paths, const long long* byte_offsets,
                       int n_items, long long bytes_per_item, char* out,
                       int n_threads) {
  if (n_items <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_items) n_threads = n_items;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else 1-based failing item index

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_items || failed.load()) return;
      int fd = get_fd(paths[i]);
      if (fd < 0 ||
          !read_fully(fd, out + (long long)i * bytes_per_item,
                      bytes_per_item, byte_offsets[i])) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return -failed.load();
}

void owl_drop_fd_cache() {
  std::lock_guard<std::mutex> lock(g_fd_mutex);
  for (auto& kv : g_fd_cache) ::close(kv.second);
  g_fd_cache.clear();
}

}  // extern "C"
