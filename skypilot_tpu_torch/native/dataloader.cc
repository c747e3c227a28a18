// xsky native token loader.
//
// Keeps the MXU fed: memory-maps binary token shards (little-endian
// uint32 token streams), builds a seeded-shuffled sample order each
// epoch, and fills batches [batch, seq+1] (inputs + next-token targets
// share the buffer) from background worker threads into a bounded ring
// so host-side input prep overlaps device steps.
//
// The reference framework leaves data loading to user recipes; this is
// the in-tree native equivalent (SURVEY: runtime/IO components are
// native where the reference's are). Exposed via a C ABI for ctypes —
// no pybind11 in the image.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread dataloader.cc \
//        -o libxsky_dataloader.so
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Shard {
  const uint32_t* tokens = nullptr;
  size_t n_tokens = 0;
  int fd = -1;
  size_t map_bytes = 0;
};

struct Loader {
  std::vector<Shard> shards;
  std::vector<size_t> shard_offset;  // global token offset per shard
  size_t total_tokens = 0;

  int batch = 0;
  int seq = 0;
  long long seed = 0;
  int host_rank = 0;
  int num_hosts = 1;

  // Sample i = tokens [i*seq, i*seq + seq + 1).
  size_t n_samples = 0;

  // Bounded queue of ready batches.
  std::deque<std::vector<uint32_t>> ready;
  size_t max_ready = 4;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_space;   // producer waits
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  // Producer-side epoch state (guarded by prod_mu).
  std::mutex prod_mu;
  std::vector<uint64_t> order;
  size_t next_in_epoch = 0;
  long long epoch = 0;

  ~Loader() {
    for (auto& s : shards) {
      if (s.tokens) munmap(const_cast<uint32_t*>(s.tokens), s.map_bytes);
      if (s.fd >= 0) close(s.fd);
    }
  }
};

uint32_t token_at(const Loader& L, size_t idx) {
  // Global index -> (shard, local) via linear scan from a cached hint;
  // shards are few, samples are read as contiguous ranges below, so
  // this path is only a fallback for range-crossing reads.
  for (size_t s = 0; s < L.shards.size(); ++s) {
    size_t off = L.shard_offset[s];
    if (idx < off + L.shards[s].n_tokens)
      return L.shards[s].tokens[idx - off];
  }
  return 0;
}

void copy_range(const Loader& L, size_t start, size_t count,
                uint32_t* out) {
  // Fast path: whole range inside one shard -> memcpy.
  for (size_t s = 0; s < L.shards.size(); ++s) {
    size_t off = L.shard_offset[s];
    if (start >= off && start + count <= off + L.shards[s].n_tokens) {
      std::memcpy(out, L.shards[s].tokens + (start - off),
                  count * sizeof(uint32_t));
      return;
    }
  }
  for (size_t i = 0; i < count; ++i) out[i] = token_at(L, start + i);
}

void reshuffle_locked(Loader& L) {
  // Host-sharded epoch order: every host shuffles the same permutation
  // (same seed+epoch) and takes its strided slice, so data-parallel
  // hosts see disjoint samples without communication.
  std::vector<uint64_t> all(L.n_samples);
  std::iota(all.begin(), all.end(), 0);
  std::mt19937_64 rng(static_cast<uint64_t>(L.seed) * 1000003ull +
                      static_cast<uint64_t>(L.epoch));
  std::shuffle(all.begin(), all.end(), rng);
  L.order.clear();
  for (size_t i = L.host_rank; i < all.size();
       i += static_cast<size_t>(L.num_hosts))
    L.order.push_back(all[i]);
  L.next_in_epoch = 0;
}

bool fill_batch(Loader& L, std::vector<uint32_t>& out) {
  const size_t row = static_cast<size_t>(L.seq) + 1;
  out.resize(static_cast<size_t>(L.batch) * row);
  std::vector<uint64_t> picks(L.batch);
  {
    std::lock_guard<std::mutex> lk(L.prod_mu);
    for (int b = 0; b < L.batch; ++b) {
      if (L.next_in_epoch >= L.order.size()) {
        ++L.epoch;
        reshuffle_locked(L);
        if (L.order.empty()) return false;
      }
      picks[b] = L.order[L.next_in_epoch++];
    }
  }
  for (int b = 0; b < L.batch; ++b) {
    size_t start = picks[b] * static_cast<size_t>(L.seq);
    copy_range(L, start, row, out.data() + static_cast<size_t>(b) * row);
  }
  return true;
}

void worker_main(Loader* L) {
  while (!L->stop.load()) {
    std::vector<uint32_t> batch;
    if (!fill_batch(*L, batch)) {
      // Exhausted (empty host slice): wake consumers so xsky_dl_next
      // returns -1 instead of waiting forever.
      L->stop.store(true);
      std::lock_guard<std::mutex> lk(L->mu);
      L->cv_ready.notify_all();
      L->cv_space.notify_all();
      return;
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_space.wait(lk, [L] {
      return L->stop.load() || L->ready.size() < L->max_ready;
    });
    if (L->stop.load()) return;
    L->ready.push_back(std::move(batch));
    L->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle (>0) or 0 on failure.
void* xsky_dl_open(const char** paths, int n_paths, int batch, int seq,
                   long long seed, int n_workers, int host_rank,
                   int num_hosts) {
  if (n_paths <= 0 || batch <= 0 || seq <= 0 || num_hosts <= 0 ||
      host_rank < 0 || host_rank >= num_hosts)
    return nullptr;
  auto* L = new Loader();
  L->batch = batch;
  L->seq = seq;
  L->seed = seed;
  L->host_rank = host_rank;
  L->num_hosts = num_hosts;
  for (int i = 0; i < n_paths; ++i) {
    Shard s;
    s.fd = open(paths[i], O_RDONLY);
    if (s.fd < 0) { delete L; return nullptr; }
    struct stat st;
    if (fstat(s.fd, &st) != 0 || st.st_size < 4) {
      close(s.fd); delete L; return nullptr;
    }
    s.map_bytes = static_cast<size_t>(st.st_size);
    void* m = mmap(nullptr, s.map_bytes, PROT_READ, MAP_PRIVATE,
                   s.fd, 0);
    if (m == MAP_FAILED) { close(s.fd); delete L; return nullptr; }
    // Samples are read at shuffled offsets: random advice avoids
    // readahead churn on multi-GB shards.
    madvise(m, s.map_bytes, MADV_RANDOM);
    s.tokens = static_cast<const uint32_t*>(m);
    s.n_tokens = s.map_bytes / sizeof(uint32_t);
    L->shard_offset.push_back(L->total_tokens);
    L->total_tokens += s.n_tokens;
    L->shards.push_back(s);
  }
  if (L->total_tokens < static_cast<size_t>(seq) + 1) {
    delete L;
    return nullptr;
  }
  L->n_samples = (L->total_tokens - 1) / static_cast<size_t>(seq);
  {
    std::lock_guard<std::mutex> lk(L->prod_mu);
    reshuffle_locked(*L);
    if (L->order.empty()) {
      // This host's strided slice is empty (fewer samples than
      // hosts): fail fast rather than hang the gang.
      delete L;
      return nullptr;
    }
  }
  if (n_workers < 1) n_workers = 1;
  for (int i = 0; i < n_workers; ++i)
    L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocking: copies one [batch, seq+1] uint32 batch into out.
// Returns 0 on success, -1 if the loader is stopped/exhausted.
int xsky_dl_next(void* handle, uint32_t* out) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<uint32_t> batch;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [L] {
      return L->stop.load() || !L->ready.empty();
    });
    if (L->ready.empty()) return -1;
    batch = std::move(L->ready.front());
    L->ready.pop_front();
    L->cv_space.notify_one();
  }
  std::memcpy(out, batch.data(), batch.size() * sizeof(uint32_t));
  return 0;
}

long long xsky_dl_num_samples(void* handle) {
  return static_cast<long long>(
      static_cast<Loader*>(handle)->n_samples);
}

void xsky_dl_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    // Under mu: a worker between its predicate check and blocking
    // would otherwise miss the notify and deadlock the join.
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
    L->cv_ready.notify_all();
    L->cv_space.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
