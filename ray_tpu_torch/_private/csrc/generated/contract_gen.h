// graftgen: generated from docs/wire_contract.json — DO NOT EDIT
// graftgen: regenerate with `make gen` (python -m ray_tpu._private.lint.gen)
// graftgen: contract generator: python -m ray_tpu._private.lint --emit-contract
// graftgen: content-sha256=42eedc0c09fdbe2e379913da1f36aa9a1aae37c3379de1ad9ffddb9b15a5a0a4
// graftgen: generated (begin)
#pragma once

// Native control-plane contract tables generated from
// docs/wire_contract.json: per-method required-field validators,
// the replay-class/mutating dispatch table, and the (sid, rseq)
// reply cache mirroring rpc.SessionManager exactly.

#include <stdint.h>
#include <string.h>

#include <chrono>
#include <functional>
#include <list>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include "../msgpack_lite.h"

namespace contractgen {

enum ReplayClass : uint8_t {
  kReplayCached = 0,        // dedup via the (sid, rseq) reply cache
  kReplayExempt = 1,        // audited idempotent: blind replay safe
};

struct MethodInfo {
  const char* name;
  ReplayClass replay;
  bool mutating;            // GCS persistence write-through required
  const char* const* required;
  uint32_t n_required;
};

namespace detail {
inline const char* const kReq_ActorCall[] = {"caller_id", "spec"};
inline const char* const kReq_ActorReady[] = {"actor_id", "address"};
inline const char* const kReq_ActorSeqSkip[] = {"caller_id", "seq"};
inline const char* const kReq_AddObjectLocation[] = {"node_id", "object_id"};
inline const char* const kReq_AddTaskEvents[] = {"events"};
inline const char* const kReq_AssignActor[] = {"spec"};
inline const char* const kReq_BorrowRef[] = {"borrower", "object_id"};
inline const char* const kReq_CommitPGBundle[] = {"bundle_index", "pg_id"};
inline const char* const kReq_CreatePlacementGroup[] = {"bundles", "pg_id"};
inline const char* const kReq_DrainComplete[] = {"node_id"};
inline const char* const kReq_DrainNode[] = {"node_id"};
inline const char* const kReq_EnsureRuntimeEnv[] = {"env"};
inline const char* const kReq_FetchChunk[] = {"object_id", "offset", "size"};
inline const char* const kReq_FinishJob[] = {"job_id"};
inline const char* const kReq_FreeObjects[] = {"object_ids"};
inline const char* const kReq_GetActorInfo[] = {"actor_id"};
inline const char* const kReq_GetNamedActor[] = {"name"};
inline const char* const kReq_GetObjectStatus[] = {"object_id"};
inline const char* const kReq_GetPlacementGroup[] = {"pg_id"};
inline const char* const kReq_Heartbeat[] = {"node_id"};
inline const char* const kReq_KVDel[] = {"key"};
inline const char* const kReq_KVExists[] = {"key"};
inline const char* const kReq_KVGet[] = {"key"};
inline const char* const kReq_KVPut[] = {"key", "value"};
inline const char* const kReq_KillActor[] = {"actor_id"};
inline const char* const kReq_KillActorWorker[] = {"actor_id"};
inline const char* const kReq_NodeStoreInfo[] = {"node_id"};
inline const char* const kReq_NotifyNodeDead[] = {"node_id"};
inline const char* const kReq_PreparePGBundle[] = {"bundle_index", "pg_id", "resources"};
inline const char* const kReq_PullObject[] = {"object_id"};
inline const char* const kReq_PushTaskBatch[] = {"specs"};
inline const char* const kReq_RegisterActor[] = {"actor_id", "spec"};
inline const char* const kReq_RegisterJob[] = {"job_id"};
inline const char* const kReq_RegisterNode[] = {"host", "node_id", "raylet_port", "total_resources"};
inline const char* const kReq_RegisterWorker[] = {"host", "port", "worker_id"};
inline const char* const kReq_RemovePlacementGroup[] = {"pg_id"};
inline const char* const kReq_ReportActorDeath[] = {"actor_id"};
inline const char* const kReq_ReturnPGBundle[] = {"bundle_index", "pg_id"};
inline const char* const kReq_ReturnWorker[] = {"lease_id"};
inline const char* const kReq_Subscribe[] = {"channels"};
inline const char* const kReq_TaskDone[] = {"results"};
inline const char* const kReq_TaskYield[] = {"index", "result", "task_id"};
inline const char* const kReq_TasksReturned[] = {"task_ids"};
inline const char* const kReq_WaitForRefRemoved[] = {"object_id"};
inline const char* const kReq_WorkerBlocked[] = {"worker_id"};
inline const char* const kReq_WorkerUnblocked[] = {"worker_id"};
}  // namespace detail

// Sorted by strcmp(name) for binary search (FindMethod).
inline const MethodInfo kMethods[] = {
    {"ActorCall", kReplayCached, false, detail::kReq_ActorCall, 2},
    {"ActorReady", kReplayCached, true, detail::kReq_ActorReady, 2},
    {"ActorSeqSkip", kReplayCached, false, detail::kReq_ActorSeqSkip, 2},
    {"AddObjectLocation", kReplayCached, false, detail::kReq_AddObjectLocation, 2},
    {"AddTaskEvents", kReplayCached, false, detail::kReq_AddTaskEvents, 1},
    {"AssignActor", kReplayCached, false, detail::kReq_AssignActor, 1},
    {"BorrowRef", kReplayCached, false, detail::kReq_BorrowRef, 2},
    {"ClientActorCall", kReplayCached, false, nullptr, 0},
    {"ClientActorCreate", kReplayCached, false, nullptr, 0},
    {"ClientCancel", kReplayCached, false, nullptr, 0},
    {"ClientClusterInfo", kReplayCached, false, nullptr, 0},
    {"ClientGcsCall", kReplayCached, false, nullptr, 0},
    {"ClientGet", kReplayCached, false, nullptr, 0},
    {"ClientGetActor", kReplayCached, false, nullptr, 0},
    {"ClientKill", kReplayCached, false, nullptr, 0},
    {"ClientPing", kReplayCached, false, nullptr, 0},
    {"ClientPut", kReplayCached, false, nullptr, 0},
    {"ClientRegisterFunction", kReplayCached, false, nullptr, 0},
    {"ClientRelease", kReplayCached, false, nullptr, 0},
    {"ClientStreamClose", kReplayCached, false, nullptr, 0},
    {"ClientStreamEnd", kReplayCached, false, nullptr, 0},
    {"ClientStreamError", kReplayCached, false, nullptr, 0},
    {"ClientStreamItem", kReplayCached, false, nullptr, 0},
    {"ClientTask", kReplayCached, false, nullptr, 0},
    {"ClientWait", kReplayCached, false, nullptr, 0},
    {"CollectiveDeliver", kReplayCached, false, nullptr, 0},
    {"CommitPGBundle", kReplayCached, false, detail::kReq_CommitPGBundle, 2},
    {"CreateActor", kReplayCached, false, nullptr, 0},
    {"CreatePlacementGroup", kReplayCached, true, detail::kReq_CreatePlacementGroup, 2},
    {"DebugTasks", kReplayCached, false, nullptr, 0},
    {"DeviceObjectEvacuate", kReplayCached, false, nullptr, 0},
    {"DeviceObjectPull", kReplayCached, false, nullptr, 0},
    {"DeviceObjectRelease", kReplayCached, false, nullptr, 0},
    {"DeviceObjectRepin", kReplayCached, false, nullptr, 0},
    {"DeviceObjectStats", kReplayCached, false, nullptr, 0},
    {"Drain", kReplayCached, false, nullptr, 0},
    {"DrainComplete", kReplayCached, true, detail::kReq_DrainComplete, 1},
    {"DrainNode", kReplayCached, true, detail::kReq_DrainNode, 1},
    {"DrainNotice", kReplayCached, false, nullptr, 0},
    {"DumpStack", kReplayCached, false, nullptr, 0},
    {"EnsureRuntimeEnv", kReplayCached, false, detail::kReq_EnsureRuntimeEnv, 1},
    {"FetchChunk", kReplayCached, false, detail::kReq_FetchChunk, 3},
    {"FinishJob", kReplayCached, true, detail::kReq_FinishJob, 1},
    {"FreeObjects", kReplayCached, false, detail::kReq_FreeObjects, 1},
    {"GetActorInfo", kReplayCached, false, detail::kReq_GetActorInfo, 1},
    {"GetAllNodes", kReplayCached, false, nullptr, 0},
    {"GetClusterStatus", kReplayCached, false, nullptr, 0},
    {"GetConfig", kReplayCached, false, nullptr, 0},
    {"GetEventLoopStats", kReplayCached, false, nullptr, 0},
    {"GetNamedActor", kReplayCached, false, detail::kReq_GetNamedActor, 1},
    {"GetObjectRelocations", kReplayCached, false, nullptr, 0},
    {"GetObjectStatus", kReplayCached, false, detail::kReq_GetObjectStatus, 1},
    {"GetPlacementGroup", kReplayCached, false, detail::kReq_GetPlacementGroup, 1},
    {"GetState", kReplayCached, false, nullptr, 0},
    {"Heartbeat", kReplayCached, false, detail::kReq_Heartbeat, 1},
    {"KVDel", kReplayExempt, true, detail::kReq_KVDel, 1},
    {"KVExists", kReplayExempt, false, detail::kReq_KVExists, 1},
    {"KVGet", kReplayExempt, false, detail::kReq_KVGet, 1},
    {"KVKeys", kReplayExempt, false, nullptr, 0},
    {"KVPut", kReplayExempt, true, detail::kReq_KVPut, 2},
    {"KillActor", kReplayCached, true, detail::kReq_KillActor, 1},
    {"KillActorWorker", kReplayCached, false, detail::kReq_KillActorWorker, 1},
    {"ListActors", kReplayCached, false, nullptr, 0},
    {"ListJobs", kReplayCached, false, nullptr, 0},
    {"ListLogs", kReplayCached, false, nullptr, 0},
    {"ListPlacementGroups", kReplayCached, false, nullptr, 0},
    {"ListTaskEvents", kReplayCached, false, nullptr, 0},
    {"MakeRoom", kReplayCached, false, nullptr, 0},
    {"NodeDebugTasks", kReplayCached, false, nullptr, 0},
    {"NodeDeviceObjects", kReplayCached, false, nullptr, 0},
    {"NodeProfile", kReplayCached, false, nullptr, 0},
    {"NodeStacks", kReplayCached, false, nullptr, 0},
    {"NodeStoreInfo", kReplayCached, false, detail::kReq_NodeStoreInfo, 1},
    {"NotifyNodeDead", kReplayCached, true, detail::kReq_NotifyNodeDead, 1},
    {"Ping", kReplayCached, false, nullptr, 0},
    {"PreparePGBundle", kReplayCached, false, detail::kReq_PreparePGBundle, 3},
    {"Profile", kReplayCached, false, nullptr, 0},
    {"Publish", kReplayExempt, false, nullptr, 0},
    {"PullObject", kReplayCached, false, detail::kReq_PullObject, 1},
    {"PushTaskBatch", kReplayCached, false, detail::kReq_PushTaskBatch, 1},
    {"RegisterActor", kReplayCached, true, detail::kReq_RegisterActor, 2},
    {"RegisterJob", kReplayCached, true, detail::kReq_RegisterJob, 1},
    {"RegisterNode", kReplayCached, true, detail::kReq_RegisterNode, 4},
    {"RegisterWorker", kReplayCached, false, detail::kReq_RegisterWorker, 3},
    {"RemovePlacementGroup", kReplayCached, true, detail::kReq_RemovePlacementGroup, 1},
    {"ReportActorDeath", kReplayCached, true, detail::kReq_ReportActorDeath, 1},
    {"RequestWorkerLease", kReplayCached, false, nullptr, 0},
    {"ReturnPGBundle", kReplayCached, false, detail::kReq_ReturnPGBundle, 2},
    {"ReturnWorker", kReplayCached, false, detail::kReq_ReturnWorker, 1},
    {"ServeCall", kReplayCached, false, nullptr, 0},
    {"ServeStreamChunk", kReplayCached, false, nullptr, 0},
    {"ServeStreamClose", kReplayCached, false, nullptr, 0},
    {"ServeStreamEnd", kReplayCached, false, nullptr, 0},
    {"ServeStreamError", kReplayCached, false, nullptr, 0},
    {"Subscribe", kReplayExempt, false, detail::kReq_Subscribe, 1},
    {"TailLog", kReplayCached, false, nullptr, 0},
    {"TaskDone", kReplayCached, false, detail::kReq_TaskDone, 1},
    {"TaskYield", kReplayCached, false, detail::kReq_TaskYield, 3},
    {"TasksReturned", kReplayCached, false, detail::kReq_TasksReturned, 1},
    {"WaitForRefRemoved", kReplayCached, false, detail::kReq_WaitForRefRemoved, 1},
    {"WorkerBlocked", kReplayCached, false, detail::kReq_WorkerBlocked, 1},
    {"WorkerStats", kReplayCached, false, nullptr, 0},
    {"WorkerUnblocked", kReplayCached, false, detail::kReq_WorkerUnblocked, 1},
};
inline constexpr uint32_t kNumMethods = 103;

inline const MethodInfo* FindMethod(std::string_view name) {
  uint32_t lo = 0, hi = kNumMethods;
  while (lo < hi) {
    uint32_t mid = (lo + hi) / 2;
    const MethodInfo& m = kMethods[mid];
    int c = name.compare(m.name);
    if (c == 0) return &m;
    if (c < 0) hi = mid; else lo = mid + 1;
  }
  return nullptr;
}

// Mirror of common.require_fields over a raw msgpack payload:
// payload must be a map carrying every required field. Session
// stamp keys (_session/_rseq/_acked/_epoch) are wire metadata,
// not application fields. Truncated/garbage payloads fail closed.
// On failure *missing names the first absent field (or the map
// complaint), for the Malformed error text.
inline bool ValidateRequired(const MethodInfo& m, mplite::View v,
                             const char** missing) {
  *missing = nullptr;
  uint32_t n_pairs;
  if (!mplite::read_map(v, &n_pairs)) {
    *missing = "payload must be a map";
    return false;
  }
  uint64_t seen = 0;  // bit i => m.required[i] present
  for (uint32_t i = 0; i < n_pairs; i++) {
    std::string_view key;
    if (!mplite::read_str(v, &key)) {
      *missing = "unreadable map key";
      return false;
    }
    for (uint32_t r = 0; r < m.n_required && r < 64; r++) {
      if (key == m.required[r]) seen |= (1ull << r);
    }
    if (!mplite::skip(v)) {
      *missing = "truncated value";
      return false;
    }
  }
  for (uint32_t r = 0; r < m.n_required && r < 64; r++) {
    if (!(seen & (1ull << r))) {
      *missing = m.required[r];
      return false;
    }
  }
  return true;
}

inline bool IsStampKey(std::string_view key) {
  return key == "_session" || key == "_rseq" || key == "_acked" || key == "_epoch";
}

// ---------------------------------------------------------------
// SessionManager: server-side (session_id, rseq) -> reply cache.
// Exact C++ mirror of rpc.SessionManager (its semantics):
//   - begin() inserts a pending entry; duplicates either answer
//     from cache or attach a waiter to the in-flight execution;
//   - eviction pops the oldest DONE entry past max_replies and
//     STOPS at a pending head (never break at-most-once);
//   - ack(upto) prunes done entries <= upto;
//   - sessions idle past ttl are swept at most every 60s.
// Plus two native-plane extensions with the same lifetime rules:
//   - python-routed marks, so a method instance that fell through
//     to Python keeps falling through on replay (split-brain guard);
//   - an incarnation epoch (restart semantics): servers
//     advertise `epoch` in stamped replies, clients echo it on
//     REPLAYED frames only, and Probe answers kProbeStaleEpoch for
//     a replay stamped with a different incarnation's epoch whose
//     (sid, rseq) is absent — the cache it would have deduped
//     against died with the previous incarnation, so the frame is
//     rejected deterministically, never silently re-executed.
// NOT thread-safe: callers serialize (the planes run it on the
// pump loop thread only).
// ---------------------------------------------------------------
class SessionManager {
 public:
  using ReplyFn = std::function<void(int kind, const std::string&)>;

  enum ProbeResult {
    kProbeMiss = 0,        // no entry: caller may execute natively
    kProbeAnswered = 1,    // duplicate: answered (or waiter attached)
    kProbeRouted = 2,      // python-routed: caller must fall through
    kProbeStaleEpoch = 3,  // replay from a dead incarnation: reject
  };

  explicit SessionManager(uint32_t max_replies = 512,
                          double ttl_s = 900.0)
      : max_replies_(max_replies), ttl_s_(ttl_s) {}

  // Consult the cache WITHOUT creating an entry. Touches the
  // session clock and runs the sweep, exactly like begin().
  // frame_epoch is the request's _epoch stamp (0 = unstamped: a
  // fresh send, or a legacy client). A nonzero stamp that differs
  // from this server's epoch marks a replay whose original send
  // targeted a previous incarnation; with no cached entry left to
  // dedup against, the ONLY deterministic answer is rejection
  // (exempt-class methods are never stamped, so they blind-replay
  // through the other arm of the contract, as audited).
  ProbeResult Probe(const std::string& sid, int64_t rseq,
                    uint64_t frame_epoch, const ReplyFn& reply_fn) {
    double now = Now();
    MaybeSweep(now);
    Session& sess = sessions_[sid];
    sess.last_seen = now;
    if (sess.routed.count(rseq)) return kProbeRouted;
    auto it = sess.replies.find(rseq);
    if (it == sess.replies.end()) {
      if (epoch != 0 && frame_epoch != 0 && frame_epoch != epoch) {
        stale_epoch_total++;
        return kProbeStaleEpoch;
      }
      return kProbeMiss;
    }
    deduped_requests_total++;
    Entry& e = it->second;
    if (e.done) {
      reply_fn(e.kind, e.value);
    } else {
      e.waiters.push_back(reply_fn);
    }
    return kProbeAnswered;
  }

  // Insert the pending entry for an execution this caller has
  // committed to (Probe returned kProbeMiss). Mirrors the
  // insert + eviction half of rpc.SessionManager.begin().
  void Begin(const std::string& sid, int64_t rseq) {
    double now = Now();
    Session& sess = sessions_[sid];
    sess.last_seen = now;
    sess.order.push_back(rseq);
    sess.replies.emplace(rseq, Entry{});
    while (sess.replies.size() > max_replies_) {
      int64_t oldest = sess.order.front();
      auto oit = sess.replies.find(oldest);
      if (oit == sess.replies.end()) {  // already ack-pruned
        sess.order.pop_front();
        continue;
      }
      if (!oit->second.done) break;  // pending head: stop
      sess.replies.erase(oit);
      sess.order.pop_front();
    }
  }

  void Finish(const std::string& sid, int64_t rseq, int kind,
              std::string value) {
    auto sit = sessions_.find(sid);
    if (sit == sessions_.end()) return;
    auto it = sit->second.replies.find(rseq);
    if (it == sit->second.replies.end()) return;
    Entry& e = it->second;
    std::vector<ReplyFn> waiters;
    waiters.swap(e.waiters);
    e.done = true;
    e.kind = kind;
    e.value = std::move(value);
    for (auto& fn : waiters) fn(e.kind, e.value);
  }

  void Ack(const std::string& sid, int64_t upto) {
    auto sit = sessions_.find(sid);
    if (sit == sessions_.end()) return;
    Session& sess = sit->second;
    for (auto it = sess.replies.begin(); it != sess.replies.end();) {
      if (it->first <= upto && it->second.done) {
        it = sess.replies.erase(it);
      } else {
        ++it;
      }
    }
    for (auto it = sess.routed.begin(); it != sess.routed.end();) {
      if (*it <= upto) it = sess.routed.erase(it); else ++it;
    }
  }

  // Native-plane extension: remember that this (sid, rseq) was
  // handed to Python, so replays keep routing there.
  void MarkRouted(const std::string& sid, int64_t rseq) {
    Session& sess = sessions_[sid];
    sess.last_seen = Now();
    sess.routed.insert(rseq);
  }

  uint64_t deduped_requests_total = 0;
  uint64_t stale_epoch_total = 0;
  // Incarnation epoch: 0 = unset (epoch checking disabled). Set by
  // the owning plane at install time to the SAME value the Python
  // dispatcher advertises (rpc._server_sessions.epoch), so the two
  // reply caches behind one listener agree about incarnations.
  uint64_t epoch = 0;
  void SetEpoch(uint64_t e) { epoch = e; }
  size_t session_count() const { return sessions_.size(); }

  // Test hook: advance the virtual clock (sweep/TTL behavior).
  void AdvanceClockForTest(double dt_s) { skew_s_ += dt_s; }

 private:
  struct Entry {
    bool done = false;
    int kind = 0;
    std::string value;
    std::vector<ReplyFn> waiters;
  };
  struct Session {
    double last_seen = 0.0;
    std::list<int64_t> order;                 // insertion order
    std::unordered_map<int64_t, Entry> replies;
    std::unordered_set<int64_t> routed;
  };

  double Now() const {
    using clock = std::chrono::steady_clock;
    return std::chrono::duration<double>(
               clock::now().time_since_epoch())
               .count() +
           skew_s_;
  }

  void MaybeSweep(double now) {
    if (now - last_sweep_ < 60.0) return;
    last_sweep_ = now;
    for (auto it = sessions_.begin(); it != sessions_.end();) {
      if (now - it->second.last_seen > ttl_s_) {
        it = sessions_.erase(it);
      } else {
        ++it;
      }
    }
  }

  uint32_t max_replies_;
  double ttl_s_;
  double last_sweep_ = 0.0;
  double skew_s_ = 0.0;
  std::unordered_map<std::string, Session> sessions_;
};

}  // namespace contractgen
// graftgen: generated (end)
