// Host frame pool: fixed-slot pinned staging buffers for camera frames.
//
// C++ rebuild of the reference's use of Copper's CuHostMemoryPool (default 4
// slots, one copy per frame: crates/chalkydri/src/cameras/
// gst_to_cu.rs:66-72,124-135). The pool provides stable, page-aligned host
// buffers the capture thread writes into and the device-transfer thread reads
// from, with drop-oldest backpressure (SURVEY.md sections 2.4 item 4, 5.3).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Pool {
  std::vector<uint8_t*> slots;
  std::vector<uint64_t> stamps;   // time-of-validity per slot (us)
  std::vector<int> state;         // 0 free, 1 filled, 2 borrowed
  size_t slot_size = 0;
  std::mutex mu;
  uint64_t dropped = 0;
};

constexpr int kMaxPools = 32;
Pool* g_pools[kMaxPools] = {nullptr};
std::mutex g_pools_mu;

}  // namespace

extern "C" {

int framepool_create(size_t slot_size, int n_slots) {
  auto* p = new Pool();
  p->slot_size = slot_size;
  for (int i = 0; i < n_slots; ++i) {
    void* mem = nullptr;
    // Page-aligned so the buffer is DMA/pinning friendly.
    if (posix_memalign(&mem, 4096, slot_size) != 0) {
      for (auto* s : p->slots) free(s);
      delete p;
      return -1;
    }
    p->slots.push_back(static_cast<uint8_t*>(mem));
    p->stamps.push_back(0);
    p->state.push_back(0);
  }
  std::lock_guard<std::mutex> lk(g_pools_mu);
  for (int i = 0; i < kMaxPools; ++i) {
    if (g_pools[i] == nullptr) {
      g_pools[i] = p;
      return i;
    }
  }
  for (auto* s : p->slots) free(s);
  delete p;
  return -1;
}

// Producer: copy a frame in. Returns the slot index, or -1. Overwrites the
// oldest filled slot when all are filled (drop-oldest).
int framepool_push(int handle, const uint8_t* data, size_t len,
                   uint64_t stamp_us) {
  if (handle < 0 || handle >= kMaxPools) return -1;
  Pool* p = g_pools[handle];
  if (p == nullptr || len > p->slot_size) return -1;
  int slot = -1;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    // Prefer a free slot; else the oldest filled one (never a borrowed one).
    uint64_t oldest = UINT64_MAX;
    int oldest_idx = -1;
    for (size_t i = 0; i < p->slots.size(); ++i) {
      if (p->state[i] == 0) {
        slot = static_cast<int>(i);
        break;
      }
      if (p->state[i] == 1 && p->stamps[i] < oldest) {
        oldest = p->stamps[i];
        oldest_idx = static_cast<int>(i);
      }
    }
    if (slot < 0) {
      slot = oldest_idx;
      if (slot >= 0) p->dropped++;
    }
    if (slot < 0) return -1;  // every slot borrowed
    p->state[slot] = 2;  // reserve while copying
  }
  std::memcpy(p->slots[slot], data, len);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stamps[slot] = stamp_us;
    p->state[slot] = 1;
  }
  return slot;
}

// Consumer: borrow the newest filled slot. Returns slot index or -1; the
// buffer pointer and stamp are written through the out-params.
int framepool_acquire_latest(int handle, uint8_t** out_ptr,
                             uint64_t* out_stamp) {
  if (handle < 0 || handle >= kMaxPools) return -1;
  Pool* p = g_pools[handle];
  if (p == nullptr) return -1;
  std::lock_guard<std::mutex> lk(p->mu);
  uint64_t newest = 0;
  int idx = -1;
  for (size_t i = 0; i < p->slots.size(); ++i) {
    if (p->state[i] == 1 && p->stamps[i] >= newest) {
      newest = p->stamps[i];
      idx = static_cast<int>(i);
    }
  }
  if (idx < 0) return -1;
  p->state[idx] = 2;
  *out_ptr = p->slots[idx];
  *out_stamp = p->stamps[idx];
  return idx;
}

void framepool_release(int handle, int slot) {
  if (handle < 0 || handle >= kMaxPools) return;
  Pool* p = g_pools[handle];
  if (p == nullptr || slot < 0 || slot >= static_cast<int>(p->slots.size()))
    return;
  std::lock_guard<std::mutex> lk(p->mu);
  p->state[slot] = 0;
}

uint64_t framepool_dropped(int handle) {
  if (handle < 0 || handle >= kMaxPools) return 0;
  Pool* p = g_pools[handle];
  return p ? p->dropped : 0;
}

void framepool_destroy(int handle) {
  if (handle < 0 || handle >= kMaxPools) return;
  Pool* p;
  {
    std::lock_guard<std::mutex> lk(g_pools_mu);
    p = g_pools[handle];
    g_pools[handle] = nullptr;
  }
  if (p == nullptr) return;
  for (auto* s : p->slots) free(s);
  delete p;
}

}  // extern "C"
