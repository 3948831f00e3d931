// Native continuous-batching scheduler core.
//
// The decode-loop bookkeeping (request admission, slot allocation, per-slot
// budget/EOS tracking, prompt-length bucketing) runs on the host alongside
// every decode step; keeping it native keeps it off the Python critical
// path of the serving loop. This is the serving-runtime analog of the
// reference's C++ host harness layer (SURVEY.md section 1, L3): the device
// does the math, the native host code drives the schedule.
//
// Pure C ABI (ctypes-bound in runtime/native.py); thread-safe via one mutex
// so a submit thread can feed a decode thread.

#include <cstdint>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Request {
  int64_t uid;
  int32_t prompt_len;
  int32_t max_new;
};

struct Slot {
  int64_t uid = -1;  // -1 => free
  int32_t generated = 0;
  int32_t max_new = 0;
};

struct Core {
  std::mutex mu;
  std::vector<Slot> slots;
  std::deque<Request> pending;
  int32_t max_len;
  int32_t granule;
  int64_t next_uid = 0;
};

int32_t bucket_of(const Core& c, int32_t n) {
  int32_t g = c.granule;
  int32_t b = (n + g - 1) / g * g;
  if (b < g) b = g;
  // never bucket past the cache capacity: a 1024-bucket splice into a
  // max_len=1000 cache is an out-of-bounds update on the device
  if (b > c.max_len) b = c.max_len;
  return b;
}

}  // namespace

extern "C" {

void* cbs_create(int32_t n_slots, int32_t max_len, int32_t granule) {
  auto* c = new Core();
  c->slots.resize(static_cast<size_t>(n_slots));
  c->max_len = max_len;
  c->granule = granule > 0 ? granule : 64;
  return c;
}

void cbs_destroy(void* h) { delete static_cast<Core*>(h); }

int32_t cbs_bucket(void* h, int32_t n) {
  auto* c = static_cast<Core*>(h);
  return bucket_of(*c, n);
}

// Queue a request; returns its uid, or -1 if the prompt cannot fit.
int64_t cbs_submit(void* h, int32_t prompt_len, int32_t max_new) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  if (prompt_len + max_new > c->max_len) return -1;
  int64_t uid = c->next_uid++;
  c->pending.push_back(Request{uid, prompt_len, max_new});
  return uid;
}

// Admit pending requests into free slots (FIFO). Writes up to `cap` rows of
// (uid, slot, prompt_bucket); returns the number admitted.
int32_t cbs_fill(void* h, int64_t* uids, int32_t* slots_out,
                 int32_t* buckets, int32_t cap) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  int32_t n = 0;
  for (size_t i = 0; i < c->slots.size() && n < cap && !c->pending.empty();
       ++i) {
    if (c->slots[i].uid >= 0) continue;
    Request r = c->pending.front();
    c->pending.pop_front();
    c->slots[i] = Slot{r.uid, 0, r.max_new};
    uids[n] = r.uid;
    slots_out[n] = static_cast<int32_t>(i);
    buckets[n] = bucket_of(*c, r.prompt_len);
    ++n;
  }
  return n;
}

// Record one generated token for `slot`. eos < 0 means "no eos token".
// Returns 1 and frees the slot when the request just finished, else 0.
int32_t cbs_on_token(void* h, int32_t slot, int32_t token, int32_t eos) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  Slot& s = c->slots[static_cast<size_t>(slot)];
  if (s.uid < 0) return 0;
  s.generated += 1;
  bool done = s.generated >= s.max_new || (eos >= 0 && token == eos);
  if (done) s = Slot{};
  return done ? 1 : 0;
}

int32_t cbs_active(void* h) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  int32_t n = 0;
  for (const Slot& s : c->slots) n += (s.uid >= 0);
  return n;
}

int32_t cbs_pending(void* h) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int32_t>(c->pending.size());
}

int64_t cbs_slot_uid(void* h, int32_t slot) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return c->slots[static_cast<size_t>(slot)].uid;
}

// Cancel a request. Returns: 1 = removed from the pending queue,
// 2 = evicted from its slot (the caller must free device-side state),
// 0 = unknown uid (already finished or never existed). The freed slot is
// immediately reusable by the next fill.
int32_t cbs_cancel(void* h, int64_t uid) {
  auto* c = static_cast<Core*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  for (auto it = c->pending.begin(); it != c->pending.end(); ++it) {
    if (it->uid == uid) {
      c->pending.erase(it);
      return 1;
    }
  }
  for (Slot& s : c->slots) {
    if (s.uid == uid) {
      s = Slot{};
      return 2;
    }
  }
  return 0;
}

}  // extern "C"
