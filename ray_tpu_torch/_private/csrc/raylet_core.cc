// Native raylet local-resource core.
//
// TPU-native re-design of the reference raylet's local resource
// accounting (reference: src/ray/raylet/local_task_manager.cc lease
// resource acquisition, scheduling/local_resource_manager.h,
// placement_group_resource_manager.h bundle pools, and the
// blocked-worker CPU release in node_manager.cc).
//
// Owns, natively, everything the per-node raylet must account:
//   - the node resource pool (fixed-point ticks, exact under churn)
//   - placement-group bundle pools (prepare/commit 2PC, per-bundle
//     available pools, wildcard bundle_index=-1 lookup)
//   - lease records (lease_id -> held resources + owning pool) with the
//     blocked/unblocked transitions of workers parked in ray.get
//     (unblock may drive a pool briefly negative — dispatch only
//     proceeds on fit, the same oversubscription the reference
//     tolerates on unblock).
//   - the GPU card free list: the node's cards by id, each with its free
//     share. A lease with a GPU demand draws distinct cards from it:
//     whole free cards for a demand of 1 or more (a whole number), a
//     best-fit share of one card below 1 (the card left with the least
//     room that still fits, lowest index on a tie), so the worker it
//     runs on can pin CUDA_VISIBLE_DEVICES to them. A blocked worker
//     gives back its other resources but keeps its cards and their GPU
//     share: its process still holds them.
//
// The Python raylet (ray_tpu_torch/_private/raylet.py) is the IO shell: RPC,
// process spawning, spilling. Every accounting decision lands here.
// Exposed as a C ABI for ctypes (ray_tpu_torch/_private/native_raylet_core.py).
//
// Wire format matches scheduler.cc: RS-separated (0x1e) "key=value"
// resource strings, doubles stored as int64 ticks (1e-4 granularity,
// like the reference's FixedPoint). The parse/format helpers are
// intentionally small duplicates of scheduler.cc's so each library
// stays a single self-contained translation unit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr double kTicks = 10000.0;
constexpr int64_t kCardTicks = 10000;
constexpr char kSep = '\x1e';
constexpr const char* kGpu = "GPU";

using ResourceMap = std::map<std::string, int64_t>;

int64_t ToTicks(double v) {
  return static_cast<int64_t>(std::llround(v * kTicks));
}

ResourceMap ParseResources(const char* s) {
  ResourceMap out;
  if (s == nullptr) return out;
  const char* p = s;
  while (*p) {
    const char* sep = std::strchr(p, kSep);
    const char* end = sep ? sep : p + std::strlen(p);
    const char* eq = static_cast<const char*>(std::memchr(p, '=', end - p));
    if (eq != nullptr) {
      std::string key(p, eq - p);
      int64_t ticks = ToTicks(std::strtod(eq + 1, nullptr));
      if (ticks > 0) out[key] = ticks;
    }
    if (sep == nullptr) break;
    p = sep + 1;
  }
  return out;
}

bool Fits(const ResourceMap& avail, const ResourceMap& demand) {
  for (const auto& [k, v] : demand) {
    auto it = avail.find(k);
    if (it == avail.end() || it->second < v) return false;
  }
  return true;
}

void Subtract(ResourceMap& avail, const ResourceMap& demand) {
  for (const auto& [k, v] : demand) avail[k] -= v;
}

void Add(ResourceMap& avail, const ResourceMap& demand) {
  for (const auto& [k, v] : demand) avail[k] += v;
}

// Format back to the RS wire form. Negative values are preserved (a
// briefly-negative pool after unblock must round-trip faithfully).
int FormatResources(const ResourceMap& m, char* out, int out_len) {
  int pos = 0;
  bool first = true;
  for (const auto& [k, v] : m) {
    char buf[64];
    int n = std::snprintf(buf, sizeof(buf), "%.10g", v / kTicks);
    int need = static_cast<int>(k.size()) + 1 + n + (first ? 0 : 1);
    if (pos + need + 1 > out_len) return -1;
    if (!first) out[pos++] = kSep;
    std::memcpy(out + pos, k.data(), k.size());
    pos += static_cast<int>(k.size());
    out[pos++] = '=';
    std::memcpy(out + pos, buf, n);
    pos += n;
    first = false;
  }
  out[pos] = '\0';
  return pos;
}

struct BundleKey {
  std::string pg_id;
  int index;
  bool operator<(const BundleKey& o) const {
    if (pg_id != o.pg_id) return pg_id < o.pg_id;
    return index < o.index;
  }
};

struct BundlePool {
  ResourceMap resources;   // reserved from the node pool at prepare
  ResourceMap avail;       // what leases against this bundle draw from
  bool committed = false;
};

struct Lease {
  ResourceMap resources;
  bool has_pg = false;
  BundleKey pg;            // valid when has_pg
  bool blocked = false;    // worker parked in ray.get: resources credited
  std::vector<std::pair<int, int64_t>> cards;  // (card index, ticks)
};

// What block/unblock move: everything but the GPU share.
ResourceMap Blockable(const ResourceMap& r) {
  ResourceMap out = r;
  out.erase(kGpu);
  return out;
}

// The GPU share alone (what a blocked lease still holds).
ResourceMap GpuOnly(const ResourceMap& r) {
  ResourceMap out;
  auto it = r.find(kGpu);
  if (it != r.end()) out[kGpu] = it->second;
  return out;
}

struct RayletCore {
  std::mutex mu;
  ResourceMap total;
  ResourceMap avail;
  std::map<BundleKey, BundlePool> bundles;
  std::map<std::string, Lease> leases;
  std::vector<std::string> card_ids;
  std::vector<int64_t> card_free;  // free ticks per card

  // Draw cards for `ticks` of GPU. False (nothing taken) if the free
  // list cannot give them now.
  bool TakeCards(int64_t ticks, std::vector<std::pair<int, int64_t>>* got) {
    got->clear();
    if (ticks <= 0) return true;
    const int n = static_cast<int>(card_free.size());
    if (ticks >= kCardTicks) {
      if (ticks % kCardTicks) return false;
      int64_t want = ticks / kCardTicks;
      for (int i = 0; i < n && (int64_t)got->size() < want; i++)
        if (card_free[i] == kCardTicks) got->emplace_back(i, kCardTicks);
      if ((int64_t)got->size() < want) {
        got->clear();
        return false;
      }
    } else {
      int best = -1;
      for (int i = 0; i < n; i++)
        if (card_free[i] >= ticks &&
            (best < 0 || card_free[i] < card_free[best]))
          best = i;
      if (best < 0) return false;
      got->emplace_back(best, ticks);
    }
    for (const auto& [i, t] : *got) card_free[i] -= t;
    return true;
  }

  void GiveCards(const Lease& l) {
    for (const auto& [i, t] : l.cards) card_free[i] += t;
  }

  // Credit a lease's resources back to its owning pool. A missing
  // bundle pool (already returned) drops the credit — the bundle's
  // whole reservation went back to the node pool at return time.
  void CreditBack(const Lease& l, const ResourceMap& r) {
    if (l.has_pg) {
      auto it = bundles.find(l.pg);
      if (it != bundles.end()) Add(it->second.avail, r);
    } else {
      Add(avail, r);
    }
  }

  void DebitFrom(const Lease& l, const ResourceMap& r) {
    if (l.has_pg) {
      auto it = bundles.find(l.pg);
      if (it != bundles.end()) Subtract(it->second.avail, r);
    } else {
      Subtract(avail, r);
    }
  }
};

}  // namespace

extern "C" {

// `gpu_ids` (RS-separated, may be null) names the node's cards in
// order; there are as many cards as whole GPUs in the total, and cards
// without a given id are named by their index.
void* rcore_create_with_cards(const char* total_resources,
                              const char* gpu_ids) {
  auto* c = new RayletCore();
  c->total = ParseResources(total_resources);
  c->avail = c->total;
  auto git = c->total.find(kGpu);
  int64_t n_cards = git == c->total.end() ? 0 : git->second / kCardTicks;
  if (gpu_ids != nullptr) {
    const char* p = gpu_ids;
    while (*p && (int64_t)c->card_ids.size() < n_cards) {
      const char* sep = std::strchr(p, kSep);
      const char* end = sep ? sep : p + std::strlen(p);
      c->card_ids.emplace_back(p, end - p);
      if (sep == nullptr) break;
      p = sep + 1;
    }
  }
  while ((int64_t)c->card_ids.size() < n_cards)
    c->card_ids.push_back(std::to_string(c->card_ids.size()));
  c->card_free.assign(n_cards, kCardTicks);
  return c;
}

void* rcore_create(const char* total_resources) {
  return rcore_create_with_cards(total_resources, nullptr);
}

void rcore_destroy(void* h) { delete static_cast<RayletCore*>(h); }

// Acquire `resources` for lease_id. pg_id empty => node pool; else the
// (pg_id, bundle_index) pool, with bundle_index -1 meaning "any bundle
// of this pg on this node" (lowest prepared index). Returns:
//   1  acquired (lease recorded)
//   0  does not fit right now (caller queues the lease request)
//  -1  pg bundle absent or not committed (caller fails/requeues)
//  -2  lease_id already held (caller bug)
// A GPU demand also needs its cards from the free list (0 if it cannot
// have them now).
int rcore_try_acquire(void* h, const char* lease_id, const char* resources,
                      const char* pg_id, int bundle_index) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  if (c->leases.count(lease_id)) return -2;
  ResourceMap demand = ParseResources(resources);
  Lease l;
  l.resources = demand;
  if (pg_id != nullptr && pg_id[0] != '\0') {
    BundleKey key{pg_id, bundle_index};
    auto it = c->bundles.end();
    if (bundle_index >= 0) {
      it = c->bundles.find(key);
      if (it == c->bundles.end() || !it->second.committed) return -1;
      if (!Fits(it->second.avail, demand)) return 0;
    } else {
      // Wildcard: any committed bundle of this PG on this node that
      // FITS — like the reference's _group_ wildcard resources, which
      // aggregate across all of the PG's bundles, a full lowest-index
      // bundle must not mask capacity in a later one.
      bool any_committed = false;
      bool any_fits = false;
      for (auto bit = c->bundles.lower_bound(BundleKey{pg_id, -1});
           bit != c->bundles.end() && bit->first.pg_id == key.pg_id;
           ++bit) {
        if (!bit->second.committed) continue;
        any_committed = true;
        if (Fits(bit->second.avail, demand)) {
          it = bit;
          any_fits = true;
          break;
        }
      }
      if (!any_committed) return -1;
      if (!any_fits) return 0;
    }
    auto gpu = demand.find(kGpu);
    if (!c->TakeCards(gpu == demand.end() ? 0 : gpu->second, &l.cards))
      return 0;
    Subtract(it->second.avail, demand);
    l.has_pg = true;
    l.pg = it->first;
  } else {
    if (!Fits(c->avail, demand)) return 0;
    auto gpu = demand.find(kGpu);
    if (!c->TakeCards(gpu == demand.end() ? 0 : gpu->second, &l.cards))
      return 0;
    Subtract(c->avail, demand);
  }
  c->leases.emplace(lease_id, std::move(l));
  return 1;
}

// Release a lease: credit back what block did not already credit,
// return its cards and forget it. Returns 0, or -1 if the lease is
// unknown (idempotent).
int rcore_release(void* h, const char* lease_id) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->leases.find(lease_id);
  if (it == c->leases.end()) return -1;
  const Lease& l = it->second;
  c->CreditBack(l, l.blocked ? GpuOnly(l.resources) : l.resources);
  c->GiveCards(l);
  c->leases.erase(it);
  return 0;
}

// Worker parked in ray.get: credit its resources so nested tasks can
// run (reference: node_manager blocked-worker release). Returns 1 on
// state change, 0 if already blocked, -1 unknown lease.
int rcore_block(void* h, const char* lease_id) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->leases.find(lease_id);
  if (it == c->leases.end()) return -1;
  if (it->second.blocked) return 0;
  it->second.blocked = true;
  c->CreditBack(it->second, Blockable(it->second.resources));
  return 1;
}

// Worker resumed: re-debit immediately; the pool may go briefly
// negative (self-corrects as other leases finish). Returns 1 on state
// change, 0 if not blocked, -1 unknown lease.
int rcore_unblock(void* h, const char* lease_id) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->leases.find(lease_id);
  if (it == c->leases.end()) return -1;
  if (!it->second.blocked) return 0;
  it->second.blocked = false;
  c->DebitFrom(it->second, Blockable(it->second.resources));
  return 1;
}

// Two-phase bundle reservation, phase 1: carve `resources` out of the
// node pool into a new bundle pool. Returns 1 ok (idempotent if the
// bundle already exists), 0 if it does not fit.
int rcore_pg_prepare(void* h, const char* pg_id, int bundle_index,
                     const char* resources) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  BundleKey key{pg_id, bundle_index};
  if (c->bundles.count(key)) return 1;
  ResourceMap res = ParseResources(resources);
  if (!Fits(c->avail, res)) return 0;
  Subtract(c->avail, res);
  BundlePool pool;
  pool.resources = res;
  pool.avail = res;
  c->bundles.emplace(key, std::move(pool));
  return 1;
}

// Phase 2: open the bundle for leases. Returns 0, -1 if unknown.
int rcore_pg_commit(void* h, const char* pg_id, int bundle_index) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->bundles.find(BundleKey{pg_id, bundle_index});
  if (it == c->bundles.end()) return -1;
  it->second.committed = true;
  return 0;
}

// Return a bundle: its full reservation goes back to the node pool and
// the lease_ids still held against it are written RS-separated to
// `out` (the caller kills those workers; their later release becomes a
// no-op credit since the pool is gone). Returns the count of such
// leases, or -1 if the bundle is unknown (idempotent), or -2 if `out`
// is too small.
int rcore_pg_return(void* h, const char* pg_id, int bundle_index,
                    char* out, int out_len) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->bundles.find(BundleKey{pg_id, bundle_index});
  if (it == c->bundles.end()) return -1;
  int count = 0, pos = 0;
  for (const auto& [id, l] : c->leases) {
    if (!l.has_pg || !(l.pg.pg_id == pg_id && l.pg.index == bundle_index))
      continue;
    int need = static_cast<int>(id.size()) + (count ? 1 : 0);
    if (pos + need + 1 > out_len) return -2;
    if (count) out[pos++] = kSep;
    std::memcpy(out + pos, id.data(), id.size());
    pos += static_cast<int>(id.size());
    count++;
  }
  if (out_len > 0) out[pos] = '\0';
  Add(c->avail, it->second.resources);
  c->bundles.erase(it);
  return count;
}

// Snapshot the NODE pool's available resources (what heartbeats report
// and spillback decisions read). Returns length or -1 if out too small.
int rcore_available(void* h, char* out, int out_len) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return FormatResources(c->avail, out, out_len);
}

// The card ids a lease holds, in card order, RS-separated into `out`.
// Returns the number of cards (0 for an unknown lease), or -2 if `out`
// is too small.
int rcore_gpu_ids(void* h, const char* lease_id, char* out, int out_len) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  if (out_len > 0) out[0] = '\0';
  auto it = c->leases.find(lease_id);
  if (it == c->leases.end()) return 0;
  std::vector<std::pair<int, int64_t>> cards = it->second.cards;
  std::sort(cards.begin(), cards.end());
  int pos = 0, count = 0;
  for (const auto& [i, t] : cards) {
    const std::string& id = c->card_ids[i];
    int need = static_cast<int>(id.size()) + (count ? 1 : 0);
    if (pos + need + 1 > out_len) return -2;
    if (count) out[pos++] = kSep;
    std::memcpy(out + pos, id.data(), id.size());
    pos += static_cast<int>(id.size());
    count++;
  }
  if (out_len > 0) out[pos] = '\0';
  return count;
}

// Free ticks per card, in card order, as "id=free" RS-separated (the
// free list's view). Returns length or -1 if out too small.
int rcore_cards(void* h, char* out, int out_len) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  std::string s;
  for (size_t i = 0; i < c->card_ids.size(); i++) {
    char buf[64];
    int n = std::snprintf(buf, sizeof(buf), "%.10g",
                          c->card_free[i] / kTicks);
    if (i) s.push_back(kSep);
    s += c->card_ids[i];
    s.push_back('=');
    s.append(buf, n);
  }
  if ((int)s.size() + 1 > out_len) return -1;
  std::memcpy(out, s.data(), s.size());
  out[s.size()] = '\0';
  return static_cast<int>(s.size());
}

int rcore_num_leases(void* h) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int>(c->leases.size());
}

int rcore_num_bundles(void* h) {
  auto* c = static_cast<RayletCore*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int>(c->bundles.size());
}

}  // extern "C"
