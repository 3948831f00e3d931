// Native token-stream data loader for the training path.
//
// The reference repo has no host runtime at all (every .cu file is a
// self-contained benchmark); this is part of the framework's native runtime
// layer (with scheduler.cpp and oracle.cpp): a memory-mapped packed-token
// reader (flat uint32 file, nanoGPT-style .bin) with a background prefetch
// pool that keeps a bounded queue of [batch, seq_len+1] crops ready while
// the TPU step runs — host input must never be the bubble in the train
// loop. ctypes-bound in runtime/data.py with a numpy fallback.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread dataloader.cpp -o
//        libdataloader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  const uint32_t* tokens = nullptr;  // mmap'd file
  int64_t n_tokens = 0;
  size_t map_bytes = 0;
  int fd = -1;

  int64_t batch = 0;
  int64_t seq = 0;      // tokens per row EXCLUDING the +1 label overlap
  bool shuffle = true;  // random crops vs sequential epoch walk
  uint64_t seed = 0;
  int64_t lo = 0, hi = 0;  // crop region [lo, hi) — data-parallel shard

  // prefetch machinery
  std::vector<std::thread> workers;
  std::deque<std::vector<uint32_t>> ready;  // each: batch*(seq+1)
  size_t max_ready = 4;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> cursor{0};  // sequential mode: next crop start

  void fill(std::vector<uint32_t>& out, std::mt19937_64& rng) {
    const int64_t row = seq + 1;
    const int64_t range = hi - row - lo + 1;  // valid crop starts in shard
    for (int64_t b = 0; b < batch; ++b) {
      int64_t start;
      if (shuffle) {
        start = lo + static_cast<int64_t>(rng() % static_cast<uint64_t>(range));
      } else {
        start = cursor.fetch_add(seq);  // rows overlap by 1 label token
        start = lo + (start % range);
      }
      std::memcpy(out.data() + b * row, tokens + start,
                  static_cast<size_t>(row) * sizeof(uint32_t));
    }
  }

  void worker(uint64_t wseed) {
    std::mt19937_64 rng(wseed);
    while (!stop.load(std::memory_order_relaxed)) {
      std::vector<uint32_t> buf(static_cast<size_t>(batch) * (seq + 1));
      fill(buf, rng);
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] { return stop.load() || ready.size() < max_ready; });
      if (stop.load()) return;
      ready.push_back(std::move(buf));
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Region variant: crops are drawn only from token offsets [lo, hi) — the
// per-host shard of a data-parallel input pipeline. hi == 0 means EOF.
void* dl_open_region(const char* path, int64_t batch, int64_t seq,
                     uint64_t seed, int32_t n_threads, int32_t shuffle,
                     int64_t lo, int64_t hi);

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* dl_open(const char* path, int64_t batch, int64_t seq, uint64_t seed,
              int32_t n_threads, int32_t shuffle) {
  return dl_open_region(path, batch, seq, seed, n_threads, shuffle, 0, 0);
}

void* dl_open_region(const char* path, int64_t batch, int64_t seq,
                     uint64_t seed, int32_t n_threads, int32_t shuffle,
                     int64_t lo, int64_t hi) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (int64_t)((seq + 1) * sizeof(uint32_t))) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ld = new Loader();
  ld->tokens = static_cast<const uint32_t*>(map);
  ld->n_tokens = st.st_size / sizeof(uint32_t);
  ld->map_bytes = st.st_size;
  ld->fd = fd;
  ld->batch = batch;
  ld->seq = seq;
  ld->seed = seed;
  ld->shuffle = shuffle != 0;
  ld->lo = lo;
  ld->hi = (hi <= 0 || hi > ld->n_tokens) ? ld->n_tokens : hi;
  if (ld->lo < 0 || ld->hi - ld->lo < seq + 1) {
    munmap(const_cast<uint32_t*>(ld->tokens), ld->map_bytes);
    ::close(fd);
    delete ld;
    return nullptr;
  }
  if (n_threads < 1) n_threads = 1;
  ld->max_ready = static_cast<size_t>(2 * n_threads);
  for (int32_t i = 0; i < n_threads; ++i) {
    ld->workers.emplace_back(&Loader::worker, ld, seed + 0x9e3779b97f4a7c15ull * (i + 1));
  }
  return ld;
}

// Blocks until a batch is ready; copies batch*(seq+1) uint32 into out.
// Returns 0 on success.
int32_t dl_next(void* handle, uint32_t* out) {
  auto* ld = static_cast<Loader*>(handle);
  std::vector<uint32_t> buf;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_consume.wait(lk, [&] { return ld->stop.load() || !ld->ready.empty(); });
    if (ld->ready.empty()) return 1;
    buf = std::move(ld->ready.front());
    ld->ready.pop_front();
    ld->cv_produce.notify_one();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(uint32_t));
  return 0;
}

int64_t dl_n_tokens(void* handle) {
  return static_cast<Loader*>(handle)->n_tokens;
}

void dl_close(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop.store(true);
  }
  ld->cv_produce.notify_all();
  ld->cv_consume.notify_all();
  for (auto& t : ld->workers) t.join();
  munmap(const_cast<uint32_t*>(ld->tokens), ld->map_bytes);
  ::close(ld->fd);
  delete ld;
}

}  // extern "C"
