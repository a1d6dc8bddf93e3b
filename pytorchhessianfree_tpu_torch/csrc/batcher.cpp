// Host-side prefetching mini-batch loader.
//
// Native runtime component of pytorchhessianfree_tpu_torch, the port's own
// copy of the JAX package's runtime/src/batcher.cpp (same C API, same
// batches for the same seed).  Host code, no device code: built by g++
// (_build.py) into the package's build/ directory at first use.  The
// reference drives its workloads with torch.utils.data.DataLoader
// (multi-process Python batch assembly, reference
// examples/example_utils.py:41-56, :96-105); this C++ threaded batcher's
// background threads gather shuffled mini-batches into a fixed ring of
// preallocated buffers so the training loop's next_batch() is a memcpy,
// never a Python-side gather.  Exposed through a plain C API consumed via
// ctypes (runtime/loader.py).
//
// Design:
//  - the dataset lives in caller-owned memory; rows are opaque byte spans
//    (inputs: N x in_row_bytes, targets: N x tgt_row_bytes), so any dtype
//    passes through natively -- int labels need no float round-trip;
//  - each epoch has its own deterministic Fisher-Yates permutation, seeded
//    from (seed, epoch) via splitmix64, shared among producers through a
//    shared_ptr so gathers run OUTSIDE the global mutex (n_threads scale);
//  - `depth` ring slots are claimed under the lock (FREE -> FILLING),
//    filled lock-free, then published (FILLING -> READY); the consumer pops
//    slots in order (hfb_next) and frees them;
//  - hfb_destroy wakes everything; a consumer blocked in hfb_next observes
//    `stop` and returns the -1 sentinel instead of hanging.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using Perm = std::vector<int64_t>;

enum class SlotState : uint8_t { kFree, kFilling, kReady };

struct Slot {
  std::vector<uint8_t> x;
  std::vector<uint8_t> y;
  uint64_t seq = 0;  // which batch index this slot holds (valid when kReady)
  SlotState state = SlotState::kFree;
};

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Batcher {
  const uint8_t* inputs;
  const uint8_t* targets;
  int64_t n, in_row_bytes, tgt_row_bytes, batch;
  uint64_t seed;
  bool drop_last;
  int64_t batches_per_epoch = 0;

  // Per-epoch permutations, generated deterministically from (seed, epoch)
  // and shared by reference so fills read them without the lock.  Entries
  // older than the oldest epoch still in flight are pruned.
  std::map<uint64_t, std::shared_ptr<const Perm>> perms;

  std::vector<Slot> slots;
  uint64_t next_to_produce = 0;  // global batch sequence number
  uint64_t next_to_consume = 0;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};
  // consumers currently inside hfb_next; hfb_destroy must not free the
  // Batcher (mutex/condvars included) until this drains to zero
  int active_consumers = 0;
  std::condition_variable cv_drained;

  std::shared_ptr<const Perm> perm_for_epoch_locked(uint64_t epoch) {
    auto it = perms.find(epoch);
    if (it != perms.end()) return it->second;
    auto perm = std::make_shared<Perm>(n);
    for (int64_t i = 0; i < n; ++i) (*perm)[i] = i;
    uint64_t state = splitmix64(seed ^ splitmix64(epoch + 1));
    if (state == 0) state = 1;
    auto rng = [&state]() {
      // xorshift64*
      uint64_t x = state;
      x ^= x >> 12;
      x ^= x << 25;
      x ^= x >> 27;
      state = x;
      return x * 0x2545F4914F6CDD1DULL;
    };
    for (int64_t i = n - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
      std::swap((*perm)[i], (*perm)[j]);
    }
    perms.emplace(epoch, perm);
    // prune epochs no batch in flight can still reference
    const uint64_t oldest =
        next_to_consume / static_cast<uint64_t>(batches_per_epoch);
    perms.erase(perms.begin(), perms.lower_bound(oldest));
    return perm;
  }

  // Gather batch `seq` into slot s using an epoch-permutation snapshot.
  // Runs WITHOUT the lock: everything touched is either immutable (dataset,
  // perm contents) or owned by this producer while the slot is kFilling.
  void fill(Slot& s, uint64_t seq, const Perm& perm) {
    const uint64_t bpe = static_cast<uint64_t>(batches_per_epoch);
    const uint64_t within = seq % bpe;
    const int64_t start = static_cast<int64_t>(within) * batch;
    const int64_t count =
        drop_last ? batch : std::min<int64_t>(batch, n - start);
    s.x.resize(static_cast<size_t>(batch) * in_row_bytes);
    s.y.resize(static_cast<size_t>(batch) * tgt_row_bytes);
    for (int64_t k = 0; k < count; ++k) {
      const int64_t src = perm[start + k];
      std::memcpy(&s.x[static_cast<size_t>(k) * in_row_bytes],
                  inputs + src * in_row_bytes,
                  static_cast<size_t>(in_row_bytes));
      std::memcpy(&s.y[static_cast<size_t>(k) * tgt_row_bytes],
                  targets + src * tgt_row_bytes,
                  static_cast<size_t>(tgt_row_bytes));
    }
    // pad a short final batch by repeating the last sample (caller sees
    // full `batch` rows; count < batch only when drop_last == false)
    for (int64_t k = count; k < batch; ++k) {
      std::memcpy(&s.x[static_cast<size_t>(k) * in_row_bytes],
                  &s.x[static_cast<size_t>(count - 1) * in_row_bytes],
                  static_cast<size_t>(in_row_bytes));
      std::memcpy(&s.y[static_cast<size_t>(k) * tgt_row_bytes],
                  &s.y[static_cast<size_t>(count - 1) * tgt_row_bytes],
                  static_cast<size_t>(tgt_row_bytes));
    }
  }

  void producer_loop() {
    const uint64_t bpe = static_cast<uint64_t>(batches_per_epoch);
    for (;;) {
      uint64_t seq;
      Slot* slot = nullptr;
      std::shared_ptr<const Perm> perm;
      {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          if (stop.load(std::memory_order_relaxed)) return;
          seq = next_to_produce;
          Slot& cand = slots[seq % slots.size()];
          // A slot is claimable once the consumer has moved past what it
          // held and no other producer is filling it.
          if (cand.state == SlotState::kFree &&
              seq < next_to_consume + slots.size()) {
            slot = &cand;
            cand.state = SlotState::kFilling;
            next_to_produce = seq + 1;
            perm = perm_for_epoch_locked(seq / bpe);
            break;
          }
          cv_produce.wait(lk);
        }
      }
      fill(*slot, seq, *perm);  // the memcpy gather runs unserialized
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->seq = seq;
        slot->state = SlotState::kReady;
      }
      cv_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* hfb_create(const void* inputs, const void* targets, int64_t n,
                 int64_t in_row_bytes, int64_t tgt_row_bytes, int64_t batch,
                 uint64_t seed, int32_t depth, int32_t n_threads,
                 int32_t drop_last) {
  if (n <= 0 || batch <= 0 || batch > n || depth < 1 || n_threads < 1 ||
      in_row_bytes <= 0 || tgt_row_bytes <= 0)
    return nullptr;
  auto* b = new Batcher();
  b->inputs = static_cast<const uint8_t*>(inputs);
  b->targets = static_cast<const uint8_t*>(targets);
  b->n = n;
  b->in_row_bytes = in_row_bytes;
  b->tgt_row_bytes = tgt_row_bytes;
  b->batch = batch;
  b->seed = seed;
  b->drop_last = drop_last != 0;
  b->batches_per_epoch = b->drop_last ? n / batch : (n + batch - 1) / batch;
  b->slots.resize(static_cast<size_t>(depth));
  for (int32_t i = 0; i < n_threads; ++i)
    b->threads.emplace_back([b] { b->producer_loop(); });
  return b;
}

int64_t hfb_batches_per_epoch(void* handle) {
  return static_cast<Batcher*>(handle)->batches_per_epoch;
}

// Blocking: copy the next batch into caller buffers.  Returns the global
// batch sequence number (>= 0), or -1 if the batcher is shutting down.
int64_t hfb_next(void* handle, void* out_x, void* out_y) {
  auto* b = static_cast<Batcher*>(handle);
  std::unique_lock<std::mutex> lk(b->mu);
  if (b->stop.load(std::memory_order_relaxed)) return -1;
  ++b->active_consumers;
  const uint64_t seq = b->next_to_consume;
  Slot& s = b->slots[seq % b->slots.size()];
  b->cv_consume.wait(lk, [&] {
    return (s.state == SlotState::kReady && s.seq == seq) ||
           b->stop.load(std::memory_order_relaxed);
  });
  int64_t result;
  if (b->stop.load(std::memory_order_relaxed)) {
    result = -1;
  } else {
    std::memcpy(out_x, s.x.data(), s.x.size());
    std::memcpy(out_y, s.y.data(), s.y.size());
    s.state = SlotState::kFree;
    b->next_to_consume = seq + 1;
    result = static_cast<int64_t>(seq);
  }
  // Notify while still holding the lock: after unlock, a racing
  // hfb_destroy may free the Batcher, so no member may be touched.
  if (--b->active_consumers == 0) b->cv_drained.notify_all();
  b->cv_produce.notify_all();
  lk.unlock();
  return result;
}

// Stop WITHOUT freeing: sets the stop flag and wakes every blocked
// producer/consumer (a consumer inside hfb_next returns the -1 sentinel).
// Safe to call from any thread at any time, including while another thread
// is blocked in hfb_next; the handle stays valid until hfb_destroy.  Lets
// an owner unblock its reader thread, join it, and only then destroy --
// removing the reader-about-to-call-hfb_next vs free race entirely.
void hfb_stop(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  std::lock_guard<std::mutex> lk(b->mu);
  b->stop.store(true);
  b->cv_consume.notify_all();
  b->cv_produce.notify_all();
}

void hfb_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  {
    // Wake everything, then wait for any consumer still inside hfb_next
    // to leave before freeing the Batcher -- deleting a mutex/condvar a
    // blocked thread is waiting on is UB (use-after-free at shutdown).
    std::unique_lock<std::mutex> lk(b->mu);
    b->stop.store(true);
    b->cv_consume.notify_all();
    b->cv_produce.notify_all();
    b->cv_drained.wait(lk, [&] { return b->active_consumers == 0; });
  }
  for (auto& t : b->threads) t.join();
  delete b;
}

}  // extern "C"
