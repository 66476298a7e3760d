// Native data-loader runtime for distributed_lion_tpu.
//
// The reference delegates its input pipeline to HF `datasets` (Arrow +
// Python workers, run_clm.py:316-381). This is the TPU-native equivalent,
// in C++ as a real runtime component: memory-mapped pre-tokenized shards
// (uint16/uint32 `.bin`, the standard offline-pretraining format), fixed
// `block_size` views (group_texts semantics, run_clm.py:509-522 — the
// per-shard tail remainder below one block is dropped), a deterministic
// per-epoch shuffled sampler, and a background prefetch thread that gathers
// batches into int32 host buffers while the TPU step runs, handing them to
// Python over a bounded queue (C ABI, consumed via ctypes — no pybind11).
//
// Build: see distributed_lion_tpu/native/__init__.py (g++ -O3 -shared).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

struct Shard {
  const uint8_t* base = nullptr;
  size_t bytes = 0;
  int fd = -1;
  int64_t n_blocks = 0;  // full blocks in this shard (tail dropped)
};

struct Loader {
  std::vector<Shard> shards;
  int dtype_bytes = 2;  // 2 = uint16, 4 = uint32
  int64_t block = 0;    // tokens per block
  int64_t n_blocks = 0;
  std::vector<int64_t> block_off;  // prefix sum of per-shard block counts

  // --- prefetch state ---
  int64_t batch = 0;
  uint64_t seed = 0;
  bool shuffle = true;
  int64_t epochs = 0;  // <=0: infinite
  int64_t lo = 0, hi = 0;  // half-open sample range [lo, hi)
  int64_t skip0 = 0;       // batches to fast-forward at start (resume seek:
                           // skipped epochs never even draw their shuffle,
                           // skipped batches never read data)
  size_t depth = 4;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_space, cv_item;
  std::deque<std::vector<int32_t>> queue;
  bool finished = false;  // producer exhausted all epochs
  std::atomic<bool> stop{false};
  bool started = false;

  ~Loader() {
    shutdown();
    for (auto& s : shards) {
      if (s.base) munmap(const_cast<uint8_t*>(s.base), s.bytes);
      if (s.fd >= 0) close(s.fd);
    }
  }

  void shutdown() {
    if (started) {
      stop.store(true);
      {
        std::lock_guard<std::mutex> lk(mu);
        cv_space.notify_all();
        cv_item.notify_all();
      }
      if (worker.joinable()) worker.join();
      started = false;
    }
  }

  // Decode global block index -> int32 out[block].
  void read_block(int64_t idx, int32_t* out) const {
    size_t s = std::upper_bound(block_off.begin(), block_off.end(), idx) -
               block_off.begin() - 1;
    int64_t local = idx - block_off[s];
    const uint8_t* p =
        shards[s].base + static_cast<size_t>(local) * block * dtype_bytes;
    if (dtype_bytes == 2) {
      const uint16_t* t = reinterpret_cast<const uint16_t*>(p);
      for (int64_t i = 0; i < block; ++i) out[i] = static_cast<int32_t>(t[i]);
    } else {
      const uint32_t* t = reinterpret_cast<const uint32_t*>(p);
      for (int64_t i = 0; i < block; ++i) out[i] = static_cast<int32_t>(t[i]);
    }
  }

  void producer() {
    const int64_t n = hi - lo;
    const int64_t bpe = n / batch;  // batches per epoch (drop-last)
    int64_t skip = skip0;
    std::vector<int64_t> order(static_cast<size_t>(n));
    for (int64_t e = 0; epochs <= 0 || e < epochs; ++e) {
      if (skip >= bpe && bpe > 0) {
        skip -= bpe;  // whole epoch skipped: no shuffle draw, no reads
        continue;
      }
      for (int64_t i = 0; i < n; ++i) order[i] = lo + i;
      if (shuffle) {
        std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(e + 1));
        std::shuffle(order.begin(), order.end(), rng);
      }
      const int64_t i0 = skip * batch;
      skip = 0;
      // drop-last batching, matching sources.batch_iterator
      for (int64_t i = i0; i + batch <= n; i += batch) {
        std::vector<int32_t> buf(static_cast<size_t>(batch * block));
        for (int64_t b = 0; b < batch; ++b)
          read_block(order[i + b], buf.data() + b * block);
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return queue.size() < depth || stop.load(); });
        if (stop.load()) return;
        queue.emplace_back(std::move(buf));
        cv_item.notify_one();
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    finished = true;
    cv_item.notify_all();
  }
};

}  // namespace

extern "C" {

const char* dl_last_error() { return g_last_error.c_str(); }

// Open n_paths mmap'd shards of `dtype_bytes`-wide tokens, cut into
// block_size views. Returns an opaque handle or nullptr (see dl_last_error).
void* dl_open(const char** paths, int n_paths, int dtype_bytes,
              long long block_size) {
  if (dtype_bytes != 2 && dtype_bytes != 4) {
    set_error("dtype_bytes must be 2 (uint16) or 4 (uint32)");
    return nullptr;
  }
  if (block_size <= 0 || n_paths <= 0) {
    set_error("need block_size > 0 and at least one shard");
    return nullptr;
  }
  auto* L = new Loader();
  L->dtype_bytes = dtype_bytes;
  L->block = block_size;
  L->block_off.push_back(0);
  for (int i = 0; i < n_paths; ++i) {
    Shard s;
    s.fd = open(paths[i], O_RDONLY);
    if (s.fd < 0) {
      set_error(std::string("cannot open ") + paths[i]);
      delete L;
      return nullptr;
    }
    struct stat st;
    fstat(s.fd, &st);
    s.bytes = static_cast<size_t>(st.st_size);
    s.n_blocks = static_cast<int64_t>(s.bytes) / (block_size * dtype_bytes);
    if (s.bytes > 0) {
      void* m = mmap(nullptr, s.bytes, PROT_READ, MAP_PRIVATE, s.fd, 0);
      if (m == MAP_FAILED) {
        set_error(std::string("mmap failed for ") + paths[i]);
        close(s.fd);
        delete L;
        return nullptr;
      }
      madvise(m, s.bytes, MADV_WILLNEED);
      s.base = static_cast<const uint8_t*>(m);
    }
    L->n_blocks += s.n_blocks;
    L->block_off.push_back(L->n_blocks);
    L->shards.push_back(s);
  }
  if (L->n_blocks == 0) {
    set_error("shards contain zero full blocks");
    delete L;
    return nullptr;
  }
  return L;
}

long long dl_num_blocks(void* h) {
  return static_cast<Loader*>(h)->n_blocks;
}

// Random access (eval sets, debugging). Returns 1 on success.
int dl_read_block(void* h, long long idx, int32_t* out) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || idx >= L->n_blocks) {
    set_error("block index out of range");
    return 0;
  }
  L->read_block(idx, out);
  return 1;
}

// Start the prefetch thread: [global_batch, block] int32 batches, shuffled
// per epoch with `seed`, drop-last; epochs<=0 cycles forever. Sampling is
// restricted to blocks [lo, hi) (hi<=0 → num_blocks), so callers can hold
// out a validation range from the same shards. skip_batches fast-forwards
// the deterministic stream by index arithmetic (checkpoint-resume seek).
int dl_start(void* h, long long global_batch, unsigned long long seed,
             int shuffle, int prefetch_depth, long long epochs,
             long long lo, long long hi, long long skip_batches) {
  auto* L = static_cast<Loader*>(h);
  if (L->started) {
    set_error("loader already started");
    return 0;
  }
  if (hi <= 0) hi = L->n_blocks;
  if (lo < 0 || lo >= hi || hi > L->n_blocks) {
    set_error("invalid sample range [lo, hi)");
    return 0;
  }
  if (global_batch <= 0 || global_batch > hi - lo) {
    set_error("global_batch must be in [1, range size]");
    return 0;
  }
  L->lo = lo;
  L->hi = hi;
  L->batch = global_batch;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->depth = prefetch_depth > 0 ? static_cast<size_t>(prefetch_depth) : 1;
  L->epochs = epochs;
  L->skip0 = skip_batches > 0 ? skip_batches : 0;
  L->stop.store(false);
  L->finished = false;
  L->started = true;
  L->worker = std::thread([L] { L->producer(); });
  return 1;
}

// Pop the next batch into out[global_batch * block]. Blocks until a batch
// is ready. Returns 1, or 0 once all epochs are exhausted.
int dl_next(void* h, int32_t* out) {
  auto* L = static_cast<Loader*>(h);
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_item.wait(lk, [&] {
      return !L->queue.empty() || L->finished || L->stop.load();
    });
    if (L->queue.empty()) return 0;
    buf = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_space.notify_one();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  return 1;
}

void dl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
