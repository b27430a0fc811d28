// Pooled host-memory storage manager.
//
// Reference contract: src/storage/{storage.cc, pooled_storage_manager.h}
// [U] (SURVEY.md §2.1) — device allocators with size-bucketed free
// lists so steady-state training never hits the system allocator
// (`GPUPooledStorageManager::Alloc`, `MXNET_GPU_MEM_POOL_RESERVE`).
//
// In the port (a copy of the JAX package's native/storage.cc): device
// memory belongs to PyTorch's caching allocator.  What the framework
// pools by hand is HOST memory on the input path: RecordIO chunk
// buffers, decode scratch, batch staging ahead of the copy to the
// card.  This manager pools those with power-of-two buckets + an
// exact-size big list, 64-byte alignment (cache line / DMA friendly),
// and stats for the profiler's memory view.
//
// Build: compiled into the port's host library by _native.py.
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kAlign = 64;
constexpr int kNumBuckets = 40;  // pow2 buckets up to 2^39

inline int BucketOf(size_t size) {
  int b = 0;
  size_t s = 1;
  while (s < size && b < kNumBuckets - 1) { s <<= 1; ++b; }
  return b;
}

inline size_t BucketSize(int b) { return static_cast<size_t>(1) << b; }

// One memory-profile event (profiler.py `profile_memory=True`; the
// reference wires storage-manager alloc/free into its profiler the
// same way — profiler_msg in storage.cc [U]).  kind: 0 = alloc served
// from pool, 1 = fresh alloc from the OS, 2 = free back to pool.
struct MemEvent {
  int64_t t_us;        // steady_clock micros (python rebases at drain)
  uint64_t size;       // rounded block size
  int32_t kind;
  int32_t reserved;
  uint64_t allocated;  // pool totals AFTER this event
  uint64_t pooled;
};

constexpr size_t kMaxEvents = 1 << 16;

inline int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Pool {
  std::mutex mu;
  std::vector<void*> free_list[kNumBuckets];
  std::unordered_map<void*, size_t> live;  // ptr -> rounded size
  std::atomic<uint64_t> bytes_allocated{0};  // handed out, not returned
  std::atomic<uint64_t> bytes_pooled{0};     // cached in free lists
  std::atomic<uint64_t> alloc_calls{0};
  std::atomic<uint64_t> pool_hits{0};
  std::atomic<bool> profiling{false};
  std::mutex ev_mu;
  std::vector<MemEvent> events;
  std::atomic<uint64_t> events_dropped{0};
};

void RecordEvent(Pool* p, uint64_t size, int kind) {
  if (!p->profiling.load(std::memory_order_relaxed)) return;
  MemEvent e{NowUs(), size, kind, 0, p->bytes_allocated.load(),
             p->bytes_pooled.load()};
  std::lock_guard<std::mutex> lk(p->ev_mu);
  if (p->events.size() >= kMaxEvents) {
    p->events_dropped.fetch_add(1);
    return;
  }
  p->events.push_back(e);
}

}  // namespace

extern "C" {

void* sto_create() { return new Pool(); }

void* sto_alloc(void* h, uint64_t size) {
  auto* p = static_cast<Pool*>(h);
  p->alloc_calls.fetch_add(1);
  if (size > BucketSize(kNumBuckets - 1)) return nullptr;  // no silent cap
  int b = BucketOf(size);
  size_t rounded = BucketSize(b);
  void* ptr = nullptr;
  bool pool_hit = false;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto& fl = p->free_list[b];
    if (!fl.empty()) {
      ptr = fl.back();
      fl.pop_back();
      p->bytes_pooled.fetch_sub(rounded);
      p->pool_hits.fetch_add(1);
      pool_hit = true;
    }
  }
  if (!ptr) {
    if (posix_memalign(&ptr, kAlign, rounded) != 0) return nullptr;
  }
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->live[ptr] = rounded;
  }
  p->bytes_allocated.fetch_add(rounded);
  RecordEvent(p, rounded, pool_hit ? 0 : 1);
  return ptr;
}

// Returns the block to the pool (0) — the system allocator is never hit
// on the free path; call sto_release_all to actually give memory back.
int sto_free(void* h, void* ptr) {
  auto* p = static_cast<Pool*>(h);
  size_t rounded;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->live.find(ptr);
    if (it == p->live.end()) return -1;
    rounded = it->second;
    p->live.erase(it);
    p->free_list[BucketOf(rounded)].push_back(ptr);
  }
  p->bytes_allocated.fetch_sub(rounded);
  p->bytes_pooled.fetch_add(rounded);
  RecordEvent(p, rounded, 2);
  return 0;
}

void sto_release_all(void* h) {
  auto* p = static_cast<Pool*>(h);
  std::lock_guard<std::mutex> lk(p->mu);
  for (int b = 0; b < kNumBuckets; ++b) {
    for (void* ptr : p->free_list[b]) {
      std::free(ptr);
      p->bytes_pooled.fetch_sub(BucketSize(b));
    }
    p->free_list[b].clear();
  }
}

void sto_destroy(void* h) {
  auto* p = static_cast<Pool*>(h);
  sto_release_all(h);
  for (auto& kv : p->live) std::free(kv.first);
  delete p;
}

void sto_stats(void* h, uint64_t* allocated, uint64_t* pooled,
               uint64_t* alloc_calls, uint64_t* pool_hits) {
  auto* p = static_cast<Pool*>(h);
  if (allocated) *allocated = p->bytes_allocated.load();
  if (pooled) *pooled = p->bytes_pooled.load();
  if (alloc_calls) *alloc_calls = p->alloc_calls.load();
  if (pool_hits) *pool_hits = p->pool_hits.load();
}

// ---- memory profiling (profiler.py profile_memory=True) ----

void sto_profile(void* h, int enable) {
  auto* p = static_cast<Pool*>(h);
  p->profiling.store(enable != 0);
  if (!enable) {
    std::lock_guard<std::mutex> lk(p->ev_mu);
    p->events.clear();
  }
}

// Copies up to `cap` pending events into `out`, clears the buffer and
// writes the current steady-clock micros into `now_us` so the caller
// can rebase timestamps onto its own clock.  Returns the event count.
int sto_profile_drain(void* h, MemEvent* out, int cap, int64_t* now_us,
                      uint64_t* dropped) {
  auto* p = static_cast<Pool*>(h);
  if (now_us) *now_us = NowUs();
  if (dropped) *dropped = p->events_dropped.exchange(0);
  std::lock_guard<std::mutex> lk(p->ev_mu);
  int n = static_cast<int>(p->events.size());
  if (n > cap) n = cap;
  if (out && n > 0)
    std::memcpy(out, p->events.data(), n * sizeof(MemEvent));
  p->events.clear();
  return n;
}

}  // extern "C"
