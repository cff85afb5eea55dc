// Native cluster-resource scheduler core.
//
// TPU-native re-design of the reference's C++ scheduling stack
// (reference: src/ray/raylet/scheduling/cluster_resource_scheduler.h:44,
// cluster_resource_data.h fixed-point resource sets,
// policy/hybrid_scheduling_policy.h:107-124 top-k hybrid policy,
// policy/bundle_scheduling_policy.h pack/spread bundle placement).
//
// Holds the cluster node table (total/available fixed-point resources +
// string labels) and answers placement queries:
//   - pick_node: single-demand placement (hybrid | pack | spread | affinity)
//   - schedule_bundles: placement-group gang placement with
//     PACK / SPREAD / STRICT_PACK / STRICT_SPREAD and the TPU-first
//     STRICT_ICI strategy (all bundles on one ICI-connected slice, keyed by
//     a node label — the gang-lease unit for multi-host TPU pods).
//
// Exposed as a C ABI for the Python runtime (ctypes, see
// ray_tpu_torch/_private/native_scheduler.py). Resource wire format is compact
// "name=value,name=value" strings; values are parsed as doubles and stored
// as int64 fixed-point ticks (1e-4 granularity, like the reference's
// FixedPoint) so accounting is exact under repeated add/subtract.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kTicks = 10000.0;
constexpr double kHybridThreshold = 0.5;   // utilization knee (reference default)
constexpr double kTopKFraction = 0.2;      // top-k pool size fraction

using ResourceMap = std::map<std::string, int64_t>;

int64_t ToTicks(double v) { return static_cast<int64_t>(std::llround(v * kTicks)); }

// Entries are separated by ASCII RS (0x1e) so values may contain commas;
// the key is everything before the FIRST '=' so values may contain '='.
constexpr char kSep = '\x1e';

// Parse "CPU=4<RS>TPU=8<RS>memory=1e9" into fixed-point ticks. Zero entries
// are dropped (parity: normalize_resources in ray_tpu_torch/_private/common.py).
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

std::unordered_map<std::string, std::string> ParseLabels(const char* s) {
  std::unordered_map<std::string, std::string> out;
  if (s == nullptr) return out;
  const char* p = s;
  while (*p) {
    const char* sep = std::strchr(p, kSep);
    const char* end = sep ? sep : p + std::strlen(p);
    const char* eq = static_cast<const char*>(std::memchr(p, '=', end - p));
    if (eq != nullptr)
      out[std::string(p, eq - p)] = std::string(eq + 1, end - eq - 1);
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

struct Node {
  std::string id;
  ResourceMap total;
  ResourceMap avail;
  std::unordered_map<std::string, std::string> labels;
  bool alive = true;
  uint64_t insert_seq = 0;  // stable traversal order
};

// Accelerator-weighted utilization: sum of used CPU/TPU/GPU ticks (parity:
// the Python GCS pack/spread key). Used for pack/spread ordering.
int64_t UsedCoreTicks(const Node& n) {
  int64_t used = 0;
  for (const char* k : {"CPU", "TPU", "GPU"}) {
    auto t = n.total.find(k);
    if (t == n.total.end()) continue;
    auto a = n.avail.find(k);
    used += t->second - (a == n.avail.end() ? 0 : a->second);
  }
  return used;
}

// Critical-resource utilization after hypothetically placing `demand`
// (reference: hybrid policy node score). Range [0,1]; 1.0 if any demanded
// resource is absent from the node's total.
double ScoreAfterPlacement(const Node& n, const ResourceMap& demand) {
  double worst = 0.0;
  for (const auto& [k, v] : demand) {
    auto t = n.total.find(k);
    if (t == n.total.end() || t->second == 0) return 1.0;
    auto a = n.avail.find(k);
    int64_t avail = a == n.avail.end() ? 0 : a->second;
    double used = static_cast<double>(t->second - avail + v);
    worst = std::max(worst, used / static_cast<double>(t->second));
  }
  return worst;
}

struct Scheduler {
  std::mutex mu;
  std::unordered_map<std::string, Node> nodes;
  uint64_t seq = 0;

  std::vector<const Node*> AliveNodes() const {
    std::vector<const Node*> out;
    out.reserve(nodes.size());
    for (const auto& [_, n] : nodes)
      if (n.alive) out.push_back(&n);
    std::sort(out.begin(), out.end(), [](const Node* a, const Node* b) {
      return a->insert_seq < b->insert_seq;
    });
    return out;
  }
};

int WriteOut(const std::string& s, char* out, int out_len) {
  if (out_len <= static_cast<int>(s.size())) return -2;
  std::memcpy(out, s.data(), s.size());
  out[s.size()] = '\0';
  return 0;
}

// ---- single-demand policies ----

const Node* PickHybrid(const std::vector<const Node*>& feasible,
                       const ResourceMap& demand, unsigned seed) {
  // Reference top-k hybrid (hybrid_scheduling_policy.h:107-124): score each
  // node by critical-resource utilization after placement; nodes under the
  // threshold beat nodes over it; pick uniformly among the best k so
  // concurrent schedulers don't herd onto one node.
  std::vector<std::pair<double, const Node*>> scored;
  scored.reserve(feasible.size());
  for (const Node* n : feasible)
    scored.emplace_back(ScoreAfterPlacement(*n, demand), n);
  std::stable_sort(scored.begin(), scored.end(),
                   [](const auto& a, const auto& b) {
                     bool a_low = a.first <= kHybridThreshold;
                     bool b_low = b.first <= kHybridThreshold;
                     if (a_low != b_low) return a_low;
                     return a.first < b.first;
                   });
  size_t k = std::max<size_t>(
      1, static_cast<size_t>(std::ceil(scored.size() * kTopKFraction)));
  k = std::min(k, scored.size());
  return scored[seed % k].second;
}

const Node* PickPack(const std::vector<const Node*>& feasible) {
  // Most-utilized feasible node (bin-packs; leaves big nodes free for gangs).
  const Node* best = nullptr;
  int64_t best_used = -1;
  for (const Node* n : feasible) {
    int64_t used = UsedCoreTicks(*n);
    if (used > best_used) { best_used = used; best = n; }
  }
  return best;
}

const Node* PickSpread(const std::vector<const Node*>& feasible) {
  const Node* best = nullptr;
  int64_t best_used = INT64_MAX;
  for (const Node* n : feasible) {
    int64_t used = UsedCoreTicks(*n);
    if (used < best_used) { best_used = used; best = n; }
  }
  return best;
}

// ---- bundle (placement group) policies ----

// Greedy fit of bundles onto `candidates` with local debiting; spread mode
// orders nodes by how many bundles they already took (round-robin), strict
// mode forbids node reuse. Parity: the Python GCS _fit_bundles.
bool FitBundles(const std::vector<ResourceMap>& bundles,
                const std::vector<const Node*>& candidates, bool spread,
                bool strict, std::vector<std::string>* out) {
  std::unordered_map<std::string, ResourceMap> avail;
  std::unordered_map<std::string, int> taken;
  for (const Node* n : candidates) avail[n->id] = n->avail;
  std::vector<const Node*> order = candidates;
  std::vector<std::string> placement;
  for (const auto& demand : bundles) {
    if (spread) {
      std::stable_sort(order.begin(), order.end(),
                       [&](const Node* a, const Node* b) {
                         return taken[a->id] < taken[b->id];
                       });
    }
    const Node* placed = nullptr;
    for (const Node* n : order) {
      if (strict && taken[n->id] > 0) continue;
      if (Fits(avail[n->id], demand)) { placed = n; break; }
    }
    if (placed == nullptr) return false;
    Subtract(avail[placed->id], demand);
    taken[placed->id] += 1;
    placement.push_back(placed->id);
  }
  *out = std::move(placement);
  return true;
}

}  // namespace

extern "C" {

void* sched_create() { return new Scheduler(); }

void sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

int sched_update_node(void* h, const char* node_id, const char* total,
                      const char* avail, const char* labels, int alive) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->nodes.find(node_id);
  if (it == s->nodes.end()) {
    Node n;
    n.id = node_id;
    n.insert_seq = s->seq++;
    it = s->nodes.emplace(n.id, std::move(n)).first;
  }
  Node& n = it->second;
  if (total != nullptr) n.total = ParseResources(total);
  if (avail != nullptr) n.avail = ParseResources(avail);
  if (labels != nullptr) n.labels = ParseLabels(labels);
  n.alive = alive != 0;
  return 0;
}

int sched_remove_node(void* h, const char* node_id) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->nodes.erase(node_id) ? 0 : -1;
}

int sched_num_nodes(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int>(s->nodes.size());
}

// Debit (delta<0 via avail going down) — apply a demand against a node's
// available pool, e.g. after deciding a spillback locally.
int sched_debit_node(void* h, const char* node_id, const char* demand) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->nodes.find(node_id);
  if (it == s->nodes.end()) return -1;
  Subtract(it->second.avail, ParseResources(demand));
  return 0;
}

// strategy: "hybrid" | "pack" | "spread" | "affinity:<node_id>:<0|1 soft>"
// flags bit0: if nothing fits available resources, fall back to nodes whose
//   TOTAL capacity fits (the lease will queue there; parity with the Python
//   GCS _pick_node_for fallback).
// Returns 0 and writes the chosen node id, -1 if no feasible node.
int sched_pick_node(void* h, const char* demand_s, const char* strategy,
                    const char* exclude, int flags, unsigned seed, char* out,
                    int out_len) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  ResourceMap demand = ParseResources(demand_s);
  std::string strat = strategy ? strategy : "hybrid";

  if (strat.rfind("affinity:", 0) == 0) {
    std::string rest = strat.substr(9);
    size_t colon = rest.rfind(':');
    std::string target = rest.substr(0, colon);
    bool soft = colon != std::string::npos && rest.substr(colon + 1) == "1";
    auto it = s->nodes.find(target);
    if (it != s->nodes.end() && it->second.alive)
      return WriteOut(target, out, out_len);
    if (!soft) return -1;
    strat = "hybrid";  // soft affinity: fall through to default policy
  }

  std::vector<const Node*> alive = s->AliveNodes();
  std::vector<const Node*> feasible;
  for (const Node* n : alive)
    if ((exclude == nullptr || n->id != exclude) && Fits(n->avail, demand))
      feasible.push_back(n);
  if (feasible.empty() && (flags & 1)) {
    for (const Node* n : alive)
      if ((exclude == nullptr || n->id != exclude) && Fits(n->total, demand))
        feasible.push_back(n);
  }
  if (feasible.empty()) return -1;

  const Node* chosen;
  if (strat == "spread") chosen = PickSpread(feasible);
  else if (strat == "pack") chosen = PickPack(feasible);
  else chosen = PickHybrid(feasible, demand, seed);
  return chosen ? WriteOut(chosen->id, out, out_len) : -1;
}

// bundles: demand strings joined by '|' (e.g. "CPU=1|CPU=2,TPU=4").
// strategy: PACK | SPREAD | STRICT_PACK | STRICT_SPREAD | STRICT_ICI.
// ici_label_key: node label that names the ICI slice (STRICT_ICI only).
// On success writes comma-separated node ids in bundle order.
int sched_schedule_bundles(void* h, const char* bundles_s, const char* strategy,
                           const char* ici_label_key, char* out, int out_len) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::vector<ResourceMap> bundles;
  {
    std::string all = bundles_s ? bundles_s : "";
    size_t start = 0;
    while (start <= all.size()) {
      size_t bar = all.find('|', start);
      std::string part = all.substr(
          start, bar == std::string::npos ? std::string::npos : bar - start);
      bundles.push_back(ParseResources(part.c_str()));
      if (bar == std::string::npos) break;
      start = bar + 1;
    }
  }
  if (bundles.empty()) return -1;
  std::string strat = strategy ? strategy : "PACK";
  std::vector<const Node*> alive = s->AliveNodes();
  std::vector<std::string> placement;
  bool ok = false;

  if (strat == "STRICT_ICI") {
    // Group alive nodes by slice label; a slice hosts all bundles or none
    // (gang semantics for ICI-connected multi-host TPU pods).
    const char* key = ici_label_key ? ici_label_key : "tpu-slice";
    std::map<std::string, std::vector<const Node*>> slices;
    for (const Node* n : alive) {
      auto it = n->labels.find(key);
      if (it != n->labels.end() && !it->second.empty())
        slices[it->second].push_back(n);
    }
    for (const auto& [_, nodes] : slices)
      if (FitBundles(bundles, nodes, false, false, &placement)) { ok = true; break; }
  } else if (strat == "SPREAD" || strat == "STRICT_SPREAD") {
    ok = FitBundles(bundles, alive, true, strat == "STRICT_SPREAD", &placement);
  } else if (strat == "STRICT_PACK") {
    // Try single nodes in order of most available capacity.
    std::vector<const Node*> order = alive;
    std::stable_sort(order.begin(), order.end(),
                     [](const Node* a, const Node* b) {
                       int64_t sa = 0, sb = 0;
                       for (const auto& [_, v] : a->avail) sa += v;
                       for (const auto& [_, v] : b->avail) sb += v;
                       return sa > sb;
                     });
    for (const Node* n : order) {
      std::vector<const Node*> one{n};
      if (FitBundles(bundles, one, false, false, &placement)) { ok = true; break; }
    }
  } else {  // PACK
    ok = FitBundles(bundles, alive, false, false, &placement);
  }
  if (!ok) return -1;
  std::string joined;
  for (size_t i = 0; i < placement.size(); ++i) {
    if (i) joined += ',';
    joined += placement[i];
  }
  return WriteOut(joined, out, out_len);
}

}  // extern "C"
