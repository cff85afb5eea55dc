// gcs_actor.cc — native GCS actor-creation plane (graftgen-backed).
//
// The second slice of GCS protocol logic to go native, and the first
// STATEFUL one: the actor creation ladder (RegisterActor → pick node →
// CreateActor to the raylet → ActorReady → ALIVE) runs entirely on the
// pump's epoll thread for "simple-shape" actors (unnamed, no placement
// group, no strategy, no explicit resources — the overwhelmingly common
// case in fan-out workloads).  Python stays the policy shell: named
// actors, PG/affinity placement and resource-shaped creations fall
// through untouched, per-method and per-frame, counted in
// `fallthrough` so partial migration is observable
// (reference: gcs_actor_manager.cc + gcs_actor_scheduler.cc run this
// ladder on the gcs_server C++ loop).
//
// Contract-generated core (generated/contract_gen.h, a checked-in copy):
// required-field validation mirrors common.require_fields, and the
// (sid, rseq) reply cache mirrors rpc.SessionManager — including the
// python-routed mark that keeps a (sid, rseq) which fell through to
// Python falling through on replay, so the two caches never split-brain
// on one request.
//
// Outbound CreateActor calls stamp a native per-node session (exactly
// like gcs.py _call_node) and use seq numbers >= 1<<40 so they can
// never collide with Python-side FastConn sequence numbers on the same
// raylet connection; responses in that range are claimed by this plane.
// A raylet connection flap re-sends pending creations with the SAME
// (sid, rseq) after re-registration — the raylet's reply cache makes
// the create at-most-once across rebinds.
//
// Python <-> plane handoff rides fpump_inject events (EV_INJECT):
// msgpack [event, payload] bodies Python mirrors into its actor table
// (persistence + pubsub stay Python; see gcs.py _on_native_actor_event).
//
// Chaining: one pump has one service hook; this plane sits in front of
// the KV/pubsub service (gcs_service.cc) and forwards every frame it
// does not own via the chained next-service pointers.
//
// Threading: gact_on_frame/gact_on_close run on the pump loop thread;
// gact_node_up/node_down/actor_forget/counters run on Python threads —
// one mutex guards all state (fpump_send/fpump_inject are thread-safe).

#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include "generated/contract_gen.h"
#include "msgpack_lite.h"

namespace {

using mplite::View;

constexpr int kMsgRequest = 0;
constexpr int kMsgResponse = 1;
constexpr int kMsgError = 2;
constexpr int kMsgNotify = 3;

// Native outbound seq range: above any Python FastConn counter.
constexpr int64_t kNativeSeqBase = int64_t(1) << 40;

typedef int (*SendFn)(void* pump, int64_t conn, const void* buf,
                      uint32_t len);
typedef void (*InjectFn)(void* pump, int64_t token, const void* buf,
                         uint32_t len);
typedef int (*ChainFrameFn)(void* ctx, int64_t conn, const char* data,
                            uint32_t len);
typedef void (*ChainCloseFn)(void* ctx, int64_t conn);

// Actor states mirrored from common.py (wire strings).
constexpr const char* kStatePending = "PENDING";
constexpr const char* kStateAlive = "ALIVE";

// Node states mirrored from native_policy.py (death/drain ladder view).
constexpr int kNodeAlive = 0;
constexpr int kNodeSuspect = 1;
constexpr int kNodeDraining = 2;
constexpr int kNodeDead = 3;

// Deterministic cross-incarnation replay rejection. MUST byte-match
// rpc.STALE_EPOCH_ERROR — the differential replay test pins them equal.
constexpr const char* kStaleEpochError =
    "stale session epoch: request may have executed before a server "
    "restart and its reply was lost; re-issue";

struct Actor {
  std::string state = kStatePending;
  int64_t restarts = 0;
  int64_t max_restarts = 0;  // -1 = unlimited
  std::string node_id;       // current placement target
  std::string spec_raw;      // raw msgpack, replayed into CreateActor
  std::string resources_raw; // raw msgpack map (may be empty = absent)
};

struct PendingCreate {
  std::string actor_id;
};

struct NodeSess {
  std::string sid;
  int64_t rseq = 0;
  // rseq -> pending creation; ordered so ack = min(outstanding)-1.
  std::map<int64_t, PendingCreate> outstanding;
};

struct Node {
  int64_t conn_id = -1;
  bool up = false;
  bool in_ring = false;  // already a member of node_order
  // Death/drain-ladder state mirrored from gcs.py: SUSPECT
  // and DRAINING nodes are out of new placement; a SUSPECT node's
  // pending creations stay PARKED (resent on re-register, failed over
  // only on the explicit node_down promotion) — never forked.
  int state = kNodeAlive;
};

struct MethodStats {
  uint64_t handled = 0;
  uint64_t routed = 0;    // per-request fallthrough (complex shape etc.)
  uint64_t degraded = 0;  // breaker-forced fallthrough
};

struct ActorPlane {
  std::mutex mu;
  SendFn send = nullptr;
  InjectFn inject = nullptr;
  void* pump = nullptr;
  int64_t inject_token = 0;

  ChainFrameFn chain_frame = nullptr;
  ChainCloseFn chain_close = nullptr;
  void* chain_ctx = nullptr;

  contractgen::SessionManager sm;  // inbound (client->GCS) reply cache

  std::unordered_map<std::string, Actor> actors;
  std::unordered_map<std::string, Node> nodes;
  std::unordered_map<int64_t, std::string> conn_node;  // reverse index
  std::vector<std::string> node_order;                 // round-robin ring
  size_t rr = 0;

  std::string sess_prefix;  // unique per plane instance (GCS restart)
  std::unordered_map<std::string, NodeSess> node_sess;
  int64_t out_seq = kNativeSeqBase;
  // outbound seq -> (node_id, rseq) for response claiming.
  std::unordered_map<int64_t, std::pair<std::string, int64_t>> out_calls;

  uint64_t handled = 0;
  uint64_t fallthrough = 0;  // owned-method frames handed to Python
  uint64_t degraded = 0;     // breaker-forced fallthroughs
  std::atomic<uint64_t> proto_errors{0};

  // Divergence breaker: methods forced back to Python.
  std::unordered_map<std::string, bool> degraded_methods;
  std::unordered_map<std::string, MethodStats> method_stats;
};

double NowS() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

void SendFrame(ActorPlane* s, int64_t conn_id, int msg_type, int64_t seq,
               std::string_view method, const std::string& payload_raw) {
  std::string out;
  out.reserve(payload_raw.size() + method.size() + 16);
  mplite::w_array(out, 4);
  mplite::w_int(out, msg_type);
  mplite::w_int(out, seq);
  mplite::w_str(out, method);
  mplite::w_raw(out, payload_raw);
  s->send(s->pump, conn_id, out.data(), (uint32_t)out.size());
}

int Malformed(ActorPlane* s, int64_t conn_id, int64_t msg_type, int64_t seq,
              std::string_view method, const char* detail) {
  s->proto_errors.fetch_add(1, std::memory_order_relaxed);
  if (msg_type == kMsgRequest) {
    std::string msg = "native actor plane: malformed payload for ";
    msg.append(method);
    if (detail != nullptr) {
      msg.append(": ");
      msg.append(detail);
    }
    std::string packed;
    mplite::w_str(packed, msg);
    SendFrame(s, conn_id, kMsgError, seq, method, packed);
  }
  return 1;
}

void Inject2(ActorPlane* s, const char* event,
             const std::string& payload_raw) {
  std::string body;
  body.reserve(payload_raw.size() + 24);
  mplite::w_array(body, 2);
  mplite::w_str(body, event);
  mplite::w_raw(body, payload_raw);
  s->inject(s->pump, s->inject_token, body.data(), (uint32_t)body.size());
}

// {"ok": true} plus the _epoch advertisement when an incarnation epoch
// is configured — byte-matching rpc._stamp_reply's key order ("ok"
// first, "_epoch" appended) so python/native replies stay identical.
std::string MapOkTrue(const ActorPlane* s) {
  std::string r;
  mplite::w_map(r, s->sm.epoch != 0 ? 2 : 1);
  mplite::w_str(r, "ok");
  mplite::w_bool(r, true);
  if (s->sm.epoch != 0) {
    mplite::w_str(r, "_epoch");
    mplite::w_int(r, (int64_t)s->sm.epoch);
  }
  return r;
}

// ---- RegisterActor / ActorReady payload cursor ----

struct RegFields {
  std::string_view actor_id;
  bool have_actor_id = false;
  std::string_view spec_raw;
  std::string_view resources_raw;
  bool resources_simple = true;  // absent / nil / empty map
  bool complex_shape = false;    // name / pg / strategy / get_if_exists
  int64_t max_restarts = 0;
  // ActorReady
  std::string_view address_raw;
  bool have_address = false;
  // session stamps
  std::string_view sid;
  bool stamped = false;
  int64_t rseq = 0;
  int64_t acked = 0;
  bool have_acked = false;
  int64_t epoch = 0;  // _epoch replay stamp (0 = fresh send / legacy)
};

bool ParseFields(View& v, RegFields* f) {
  uint32_t n;
  if (!mplite::read_map(v, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view k;
    if (!mplite::read_str(v, &k)) return false;
    if (k == "actor_id") {
      if (!mplite::read_str(v, &f->actor_id)) return false;
      f->have_actor_id = true;
    } else if (k == "spec") {
      if (!mplite::read_raw(v, &f->spec_raw)) return false;
    } else if (k == "resources") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      uint32_t rn;
      View peek = v;
      if (mplite::read_map(peek, &rn)) {
        if (rn != 0) f->resources_simple = false;
      } else {
        f->resources_simple = false;  // non-map resources: Python's problem
      }
      v.off = at;
      if (!mplite::read_raw(v, &f->resources_raw)) return false;
    } else if (k == "name") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      std::string_view name;
      if (!mplite::read_str(v, &name)) return false;
      if (!name.empty()) f->complex_shape = true;
    } else if (k == "placement_group") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      std::string_view pg;
      if (!mplite::read_str(v, &pg)) return false;
      if (!pg.empty()) f->complex_shape = true;
    } else if (k == "strategy") {
      if (!mplite::try_read_nil(v)) {
        f->complex_shape = true;
        if (!mplite::skip(v)) return false;
      }
    } else if (k == "get_if_exists") {
      bool b = false;
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      if (!mplite::read_bool(v, &b)) return false;
      if (b) f->complex_shape = true;
    } else if (k == "max_restarts") {
      if (!mplite::read_int(v, &f->max_restarts)) return false;
    } else if (k == "address") {
      if (!mplite::read_raw(v, &f->address_raw)) return false;
      f->have_address = true;
    } else if (k == "_session") {
      if (!mplite::read_str(v, &f->sid)) return false;
      f->stamped = true;
    } else if (k == "_rseq") {
      if (!mplite::read_int(v, &f->rseq)) return false;
    } else if (k == "_acked") {
      if (!mplite::read_int(v, &f->acked)) return false;
      f->have_acked = true;
    } else if (k == "_epoch") {
      if (!mplite::read_int(v, &f->epoch)) return false;
    } else {
      if (!mplite::skip(v)) return false;
    }
  }
  return true;
}

// ---- scheduling: round-robin over up nodes ----

// Pick the next up, ALIVE-state node, skipping `not_node` when an
// alternative exists (draining bounce repick). SUSPECT and DRAINING
// nodes are out of new placement — the fault-aware mirror of gcs.py's
// death/drain ladders. Caller holds mu. Empty string = none.
std::string PickNode(ActorPlane* s, const std::string& not_node) {
  if (s->node_order.empty()) return "";
  for (size_t i = 0; i < s->node_order.size(); i++) {
    const std::string& nid = s->node_order[s->rr % s->node_order.size()];
    s->rr++;
    auto it = s->nodes.find(nid);
    if (it == s->nodes.end() || !it->second.up) continue;
    if (it->second.state != kNodeAlive) continue;
    if (nid == not_node) continue;
    return nid;
  }
  // Only the excluded node is usable (single-node cluster): reuse it.
  auto it = s->nodes.find(not_node);
  if (it != s->nodes.end() && it->second.up &&
      it->second.state == kNodeAlive)
    return not_node;
  return "";
}

// Send (or re-send) the CreateActor for `rseq` on `node_id`'s conn.
// Caller holds mu; the pending entry must already be in outstanding.
void SendCreate(ActorPlane* s, const std::string& node_id, int64_t rseq) {
  NodeSess& ns = s->node_sess[node_id];
  auto pit = ns.outstanding.find(rseq);
  auto nit = s->nodes.find(node_id);
  if (pit == ns.outstanding.end() || nit == s->nodes.end() ||
      !nit->second.up)
    return;
  auto ait = s->actors.find(pit->second.actor_id);
  if (ait == s->actors.end()) return;
  const Actor& a = ait->second;
  int64_t acked = ns.outstanding.empty()
                      ? ns.rseq
                      : ns.outstanding.begin()->first - 1;
  std::string payload;
  uint32_t nkeys = 5 + (a.resources_raw.empty() ? 0 : 1) + 3;
  (void)nkeys;
  payload.reserve(a.spec_raw.size() + 160);
  mplite::w_map(payload, a.resources_raw.empty() ? 7 : 8);
  mplite::w_str(payload, "actor_id");
  mplite::w_str(payload, pit->second.actor_id);
  mplite::w_str(payload, "spec");
  mplite::w_raw(payload, a.spec_raw);
  if (!a.resources_raw.empty()) {
    mplite::w_str(payload, "resources");
    mplite::w_raw(payload, a.resources_raw);
  }
  mplite::w_str(payload, "placement_group");
  mplite::w_str(payload, "");
  mplite::w_str(payload, "pg_bundle_index");
  mplite::w_int(payload, -1);
  mplite::w_str(payload, "_session");
  mplite::w_str(payload, ns.sid);
  mplite::w_str(payload, "_rseq");
  mplite::w_int(payload, rseq);
  mplite::w_str(payload, "_acked");
  mplite::w_int(payload, acked);
  int64_t seq = ++s->out_seq;
  s->out_calls[seq] = {node_id, rseq};
  SendFrame(s, nit->second.conn_id, kMsgRequest, seq, "CreateActor",
            payload);
}

// True when some known node could become placeable again without any
// new registration (conn flap, SUSPECT recovery, drain cancel). DEAD
// nodes never count — with only dead nodes left, parking would strand
// the actor where orphaning hands it to Python's scheduler.
bool AnyNodeParkable(ActorPlane* s) {
  for (const auto& [nid, n] : s->nodes) {
    (void)nid;
    if (n.in_ring && n.state != kNodeDead) return true;
  }
  return false;
}

// Begin (or retry) the creation of `actor_id` on a fresh rseq.  Caller
// holds mu.  With no usable node but SOME known node (suspect/draining/
// flapped — states that recover), the actor stays PENDING and PARKED:
// RedrivePending re-drives it when a node comes back, instead of
// forking or failing over early.  With no node at all the
// actor is ORPHANED to Python: the plane forgets it and Python's
// scheduler takes over the mirror record (which already carries the
// restart count), so nothing is double-counted.
void Schedule(ActorPlane* s, const std::string& actor_id,
              const std::string& not_node) {
  auto ait = s->actors.find(actor_id);
  if (ait == s->actors.end()) return;
  std::string node_id = PickNode(s, not_node);
  if (node_id.empty()) {
    if (AnyNodeParkable(s)) {
      ait->second.node_id.clear();  // parked: redriven on node recovery
      return;
    }
    std::string ev;
    mplite::w_map(ev, 1);
    mplite::w_str(ev, "actor_id");
    mplite::w_str(ev, actor_id);
    s->actors.erase(ait);
    Inject2(s, "orphaned", ev);
    return;
  }
  ait->second.node_id = node_id;
  NodeSess& ns = s->node_sess[node_id];
  if (ns.sid.empty()) {
    char buf[32];
    snprintf(buf, sizeof buf, "-%zu", s->node_sess.size());
    ns.sid = s->sess_prefix + node_id.substr(0, 8) + buf;
  }
  int64_t rseq = ++ns.rseq;
  ns.outstanding[rseq] = PendingCreate{actor_id};
  {
    std::string ev;
    mplite::w_map(ev, 2);
    mplite::w_str(ev, "actor_id");
    mplite::w_str(ev, actor_id);
    mplite::w_str(ev, "node_id");
    mplite::w_str(ev, node_id);
    Inject2(s, "scheduled", ev);
  }
  SendCreate(s, node_id, rseq);
}

// Creation attempt failed (raylet error / not-ok / node death).
// Restart bookkeeping mirrors gcs.py _on_actor_worker_death: consume a
// restart and reschedule while budget remains, else DEAD.  Caller
// holds mu.
void CreateFailed(ActorPlane* s, const std::string& actor_id,
                  const std::string& reason) {
  auto ait = s->actors.find(actor_id);
  if (ait == s->actors.end()) return;
  Actor& a = ait->second;
  bool can_restart =
      a.max_restarts == -1 || a.restarts < a.max_restarts;
  if (can_restart) {
    a.restarts++;
    std::string ev;
    mplite::w_map(ev, 3);
    mplite::w_str(ev, "actor_id");
    mplite::w_str(ev, actor_id);
    mplite::w_str(ev, "restarts");
    mplite::w_int(ev, a.restarts);
    mplite::w_str(ev, "reason");
    mplite::w_str(ev, reason);
    Inject2(s, "restarting", ev);
    Schedule(s, actor_id, /*not_node=*/a.node_id);
  } else {
    std::string ev;
    mplite::w_map(ev, 2);
    mplite::w_str(ev, "actor_id");
    mplite::w_str(ev, actor_id);
    mplite::w_str(ev, "reason");
    mplite::w_str(ev, reason);
    s->actors.erase(ait);
    Inject2(s, "dead", ev);
  }
}

// Re-drive every parked PENDING actor (no creation in flight anywhere):
// rehydrated actors waiting for their first node, and actors parked by
// an all-nodes-unusable window. Caller holds mu.
void RedrivePending(ActorPlane* s) {
  std::unordered_map<std::string, bool> inflight;
  for (const auto& [nid, ns] : s->node_sess) {
    (void)nid;
    for (const auto& [rseq, pc] : ns.outstanding) {
      (void)rseq;
      inflight[pc.actor_id] = true;
    }
  }
  std::vector<std::string> parked;
  for (const auto& [aid, a] : s->actors) {
    if (a.state == kStatePending && !inflight.count(aid))
      parked.push_back(aid);
  }
  for (const std::string& aid : parked) Schedule(s, aid, "");
}

// One claimed CreateActor response (or error).  Caller holds mu.
void OnCreateResponse(ActorPlane* s, int64_t msg_type, int64_t seq,
                      View& v) {
  auto cit = s->out_calls.find(seq);
  if (cit == s->out_calls.end()) return;
  std::string node_id = cit->second.first;
  int64_t rseq = cit->second.second;
  s->out_calls.erase(cit);
  NodeSess& ns = s->node_sess[node_id];
  auto pit = ns.outstanding.find(rseq);
  if (pit == ns.outstanding.end()) return;
  std::string actor_id = pit->second.actor_id;
  ns.outstanding.erase(pit);

  if (msg_type == kMsgError) {
    CreateFailed(s, actor_id, "creation rpc failed");
    return;
  }
  // Response payload: {"ok": bool, "reason": str?}
  bool ok = false;
  std::string_view reason;
  uint32_t n;
  if (mplite::read_map(v, &n)) {
    for (uint32_t i = 0; i < n; i++) {
      std::string_view k;
      if (!mplite::read_str(v, &k)) break;
      if (k == "ok") {
        if (!mplite::read_bool(v, &ok)) break;
      } else if (k == "reason") {
        size_t at = v.off;
        if (!mplite::read_str(v, &reason)) {
          v.off = at;
          if (!mplite::skip(v)) break;
        }
      } else {
        if (!mplite::skip(v)) break;
      }
    }
  }
  if (ok) return;  // ladder continues at ActorReady
  if (reason.find("draining") != std::string_view::npos) {
    // Bounced off a drain race: repick WITHOUT consuming a restart
    // (mirrors gcs.py _schedule_actor's draining branch).
    Schedule(s, actor_id, /*not_node=*/node_id);
    return;
  }
  std::string why(reason.empty() ? "creation failed" : reason);
  CreateFailed(s, actor_id, why);
}

}  // namespace

extern "C" {

void* gact_create(void* send_fn, void* inject_fn, void* pump,
                  int64_t inject_token) {
  auto* s = new ActorPlane();
  s->send = (SendFn)send_fn;
  s->inject = (InjectFn)inject_fn;
  s->pump = pump;
  s->inject_token = inject_token;
  char buf[64];
  snprintf(buf, sizeof buf, "ngcs-%llx-",
           (unsigned long long)((uint64_t)(NowS() * 1e6) ^
                                (uint64_t)getpid() << 32));
  s->sess_prefix = buf;
  return s;
}

void gact_destroy(void* h) { delete static_cast<ActorPlane*>(h); }

// Chain the NEXT in-pump service (the KV/pubsub plane): frames this
// plane does not own are forwarded there before falling back to Python.
void gact_chain(void* h, void* next_frame, void* next_close,
                void* next_ctx) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->chain_frame = (ChainFrameFn)next_frame;
  s->chain_close = (ChainCloseFn)next_close;
  s->chain_ctx = next_ctx;
}

// Node registration / rebind: remember the raylet's inbound conn (GCS->
// raylet RPCs ride it) and RE-SEND any pending creations with their
// ORIGINAL (sid, rseq) — the raylet's reply cache dedups, making each
// creation at-most-once across connection rebinds.
void gact_node_up(void* h, const char* node_id, int64_t conn_id) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string nid(node_id);
  Node& n = s->nodes[nid];
  if (n.conn_id >= 0) s->conn_node.erase(n.conn_id);
  n.conn_id = conn_id;
  n.up = true;
  // A (re-)registering node is alive; if the GCS restored a richer
  // ladder state (e.g. still DRAINING), gact_node_state follows.
  n.state = kNodeAlive;
  s->conn_node[conn_id] = nid;
  if (!n.in_ring) {
    n.in_ring = true;
    s->node_order.push_back(nid);
  }
  auto sit = s->node_sess.find(nid);
  if (sit != s->node_sess.end()) {
    std::vector<int64_t> rseqs;
    for (const auto& [rseq, _] : sit->second.outstanding)
      rseqs.push_back(rseq);
    for (int64_t rseq : rseqs) SendCreate(s, nid, rseq);
  }
  // Rehydrated / parked PENDING actors get their (re)drive now that a
  // node is placeable — the crash-rehydration re-kick.
  RedrivePending(s);
}

// Mirror one rung of the death/drain ladder into the native node view.
// SUSPECT parks (new placement skips the node; outstanding creations
// wait for re-register or node_down), DRAINING stops new placement,
// ALIVE (suspect recovery / drain cancel) re-drives parked actors.
void gact_node_state(void* h, const char* node_id, int state) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->nodes.find(node_id);
  if (it == s->nodes.end()) return;
  it->second.state = state;
  if (state == kNodeAlive) RedrivePending(s);
}

// Node declared dead: fail its pending creations through the restart
// ladder (rescheduled on surviving nodes or handed to Python).
void gact_node_down(void* h, const char* node_id) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string nid(node_id);
  auto it = s->nodes.find(nid);
  if (it != s->nodes.end()) {
    if (it->second.conn_id >= 0) s->conn_node.erase(it->second.conn_id);
    it->second.up = false;
    it->second.conn_id = -1;
    it->second.state = kNodeDead;
  }
  auto sit = s->node_sess.find(nid);
  if (sit == s->node_sess.end()) return;
  std::vector<std::string> failed;
  for (const auto& [rseq, pc] : sit->second.outstanding)
    failed.push_back(pc.actor_id);
  sit->second.outstanding.clear();
  for (const std::string& aid : failed)
    CreateFailed(s, aid, "node died during actor creation");
}

// Python takes over an actor's lifecycle (kill / post-ALIVE death):
// drop the native record so later frames for it fall through.
void gact_actor_forget(void* h, const char* actor_id) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string aid(actor_id);
  s->actors.erase(aid);
  for (auto& [nid, ns] : s->node_sess) {
    for (auto it = ns.outstanding.begin(); it != ns.outstanding.end();) {
      if (it->second.actor_id == aid) it = ns.outstanding.erase(it);
      else ++it;
    }
  }
}

void gact_counters(void* h, uint64_t* handled, uint64_t* fallthrough,
                   uint64_t* deduped) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *handled = s->handled;
  *fallthrough = s->fallthrough;
  *deduped = s->sm.deduped_requests_total;
}

uint64_t gact_proto_errors(void* h) {
  return static_cast<ActorPlane*>(h)->proto_errors.load(
      std::memory_order_relaxed);
}

int64_t gact_actor_count(void* h) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->actors.size();
}

int64_t gact_session_count(void* h) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->sm.session_count();
}

// Install the server incarnation epoch (rpc._server_sessions.epoch) so
// native replies advertise the same value Python stamps and replays
// from dead incarnations are rejected identically on both paths.
void gact_set_epoch(void* h, uint64_t epoch) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->sm.SetEpoch(epoch);
}

uint64_t gact_stale_epoch_total(void* h) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->sm.stale_epoch_total;
}

// Divergence breaker control: on!=0 degrades `method` (every new
// request routes to Python); on==0 re-arms the native handler.
void gact_set_degraded(void* h, const char* method, int on) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->degraded_methods[std::string(method)] = (on != 0);
}

uint64_t gact_degraded_total(void* h) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->degraded;
}

void gact_method_stats(void* h, const char* method, uint64_t* handled,
                       uint64_t* routed, uint64_t* degraded) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  const MethodStats& ms = s->method_stats[std::string(method)];
  *handled = ms.handled;
  *routed = ms.routed;
  *degraded = ms.degraded;
}

// Crash rehydration: replay one persisted actor-table row
// into the plane BEFORE install/chaining. No scheduling happens here —
// restored PENDING actors are parked and re-driven by RedrivePending
// when their first node (re-)registers, so a restore against an empty
// cluster cannot orphan everything back to Python in a thundering herd.
void gact_restore_actor(void* h, const char* actor_id, const char* state,
                        int64_t restarts, int64_t max_restarts,
                        const char* node_id, const char* spec,
                        uint32_t spec_len, const char* resources,
                        uint32_t res_len) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  Actor& a = s->actors[std::string(actor_id)];
  a.state = state;
  a.restarts = restarts;
  a.max_restarts = max_restarts;
  a.node_id = node_id;
  a.spec_raw.assign(spec, spec_len);
  a.resources_raw.assign(resources, res_len);
}

// Rehydrate one persisted node-table row (down, ladder state as saved);
// the node joins the ring now so AnyNodeParkable sees it, and becomes
// placeable when it re-registers (gact_node_up) within the grace window.
void gact_restore_node(void* h, const char* node_id, int state) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string nid(node_id);
  Node& n = s->nodes[nid];
  n.up = false;
  n.conn_id = -1;
  n.state = state;
  if (!n.in_ring && state != kNodeDead) {
    n.in_ring = true;
    s->node_order.push_back(nid);
  }
}

// Audit probe: copy the native-side state string for `actor_id` into
// buf (NUL-terminated). Returns 1 if known, 0 if not in the mirror.
int gact_actor_state(void* h, const char* actor_id, char* buf,
                     uint32_t cap) {
  auto* s = static_cast<ActorPlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->actors.find(std::string(actor_id));
  if (it == s->actors.end()) return 0;
  snprintf(buf, cap, "%s", it->second.state.c_str());
  return 1;
}

void gact_on_close(void* h, int64_t conn_id) {
  auto* s = static_cast<ActorPlane*>(h);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    // A node conn drop is NOT node death: pending creations stay queued
    // for the re-registration resend (gact_node_up); only the explicit
    // gact_node_down (GCS suspect->dead promotion) fails them.
    auto it = s->conn_node.find(conn_id);
    if (it != s->conn_node.end()) {
      auto nit = s->nodes.find(it->second);
      if (nit != s->nodes.end()) {
        nit->second.up = false;
        nit->second.conn_id = -1;
      }
      s->conn_node.erase(it);
    }
  }
  if (s->chain_close != nullptr) s->chain_close(s->chain_ctx, conn_id);
}

int gact_on_frame(void* h, int64_t conn_id, const char* data,
                  uint32_t len) {
  auto* s = static_cast<ActorPlane*>(h);
  View v{(const uint8_t*)data, len, 0};
  uint32_t alen;
  int64_t msg_type, seq;
  std::string_view method;
  if (!mplite::read_array(v, &alen) || alen != 4 ||
      !mplite::read_int(v, &msg_type) || !mplite::read_int(v, &seq) ||
      !mplite::read_str(v, &method)) {
    return s->chain_frame != nullptr
               ? s->chain_frame(s->chain_ctx, conn_id, data, len)
               : 0;
  }

  if ((msg_type == kMsgResponse || msg_type == kMsgError) &&
      seq >= kNativeSeqBase) {
    // Reply to one of OUR outbound calls (native seq range).
    std::lock_guard<std::mutex> lock(s->mu);
    OnCreateResponse(s, msg_type, seq, v);
    return 1;
  }

  bool owned = (msg_type == kMsgRequest || msg_type == kMsgNotify) &&
               (method == "RegisterActor" || method == "ActorReady");
  if (!owned) {
    return s->chain_frame != nullptr
               ? s->chain_frame(s->chain_ctx, conn_id, data, len)
               : 0;
  }

  // Generated validator first: a malformed frame for an owned method is
  // answered here, never handed to Python (mirrors common.require_fields
  // semantics over the raw bytes — fail closed on truncation/garbage).
  const contractgen::MethodInfo* mi = contractgen::FindMethod(method);
  View vv = v;
  const char* missing = nullptr;
  if (mi != nullptr && !contractgen::ValidateRequired(*mi, vv, &missing))
    return Malformed(s, conn_id, msg_type, seq, method, missing);

  View fv = v;
  RegFields f;
  if (!ParseFields(fv, &f))
    return Malformed(s, conn_id, msg_type, seq, method, nullptr);

  std::lock_guard<std::mutex> lock(s->mu);
  std::string reply_method(method);
  auto reply_fn = [s, conn_id, seq, reply_method](
                      int kind, const std::string& value) {
    SendFrame(s, conn_id, kind, seq, reply_method, value);
  };
  std::string sid(f.sid);
  if (f.stamped) {
    if (f.have_acked) s->sm.Ack(sid, f.acked);
    auto pr = s->sm.Probe(sid, f.rseq, (uint64_t)f.epoch, reply_fn);
    if (pr == contractgen::SessionManager::kProbeAnswered) return 1;
    if (pr == contractgen::SessionManager::kProbeRouted) {
      s->fallthrough++;
      return 0;  // stamps intact: Python's cache owns this (sid, rseq)
    }
    if (pr == contractgen::SessionManager::kProbeStaleEpoch) {
      // Replay from a pre-restart incarnation whose cached reply died
      // with the old process: deterministic rejection (never blind
      // re-execution, never a wrong dedupe) — byte-matching Python's
      // STALE_EPOCH_ERROR so the differential replay test pins both.
      std::string err;
      mplite::w_str(err, kStaleEpochError);
      if (msg_type == kMsgRequest)
        SendFrame(s, conn_id, kMsgError, seq, method, err);
      return 1;
    }
  }

  // Divergence breaker: a degraded method routes every NEW (sid, rseq)
  // to Python until the audit clears it. Replays of natively-answered
  // requests were already served from the cache by Probe above.
  {
    auto dit = s->degraded_methods.find(reply_method);
    if (dit != s->degraded_methods.end() && dit->second) {
      if (f.stamped) s->sm.MarkRouted(sid, f.rseq);
      s->fallthrough++;
      s->degraded++;
      s->method_stats[reply_method].degraded++;
      return 0;
    }
  }

  // graftgen: native-handler RegisterActor
  if (method == "RegisterActor") {
    if (f.complex_shape || !f.resources_simple) {
      // Named / PG / strategy / resource-shaped: Python policy shell.
      if (f.stamped) s->sm.MarkRouted(sid, f.rseq);
      s->fallthrough++;
      s->method_stats[reply_method].routed++;
      return 0;
    }
    if (s->node_order.empty()) {
      // No registered node yet: transient state — route to Python and
      // PIN the routing so a replay after a node joins does not execute
      // a second time natively (split-brain guard).
      if (f.stamped) s->sm.MarkRouted(sid, f.rseq);
      s->fallthrough++;
      s->method_stats[reply_method].routed++;
      return 0;
    }
    std::string actor_id(f.actor_id);
    Actor& a = s->actors[actor_id];
    a.state = kStatePending;
    a.restarts = 0;
    a.max_restarts = f.max_restarts;
    a.spec_raw.assign(f.spec_raw.data(), f.spec_raw.size());
    a.resources_raw.assign(f.resources_raw.data(), f.resources_raw.size());
    std::string result = MapOkTrue(s);
    if (f.stamped) s->sm.Begin(sid, f.rseq);
    s->handled++;
    s->method_stats[reply_method].handled++;
    // Mirror event BEFORE the reply: Python persistence must see the
    // record in-order with any follow-up events for the same actor.
    std::string payload_raw((const char*)v.p + v.off, v.n - v.off);
    Inject2(s, "registered", payload_raw);
    if (msg_type == kMsgRequest)
      SendFrame(s, conn_id, kMsgResponse, seq, method, result);
    if (f.stamped) s->sm.Finish(sid, f.rseq, kMsgResponse, result);
    Schedule(s, actor_id, "");
    return 1;
  }

  // graftgen: native-handler ActorReady
  // ActorReady: the raylet reports the actor's worker is serving.
  auto ait = s->actors.find(std::string(f.actor_id));
  if (ait == s->actors.end()) {
    // Not ours (Python-scheduled actor, or already forgotten): Python
    // owns it. Actor-existence is sticky per (sid, rseq) via the
    // routed mark so replays stay on the Python side.
    if (f.stamped) s->sm.MarkRouted(sid, f.rseq);
    s->fallthrough++;
    s->method_stats[reply_method].routed++;
    return 0;
  }
  ait->second.state = kStateAlive;
  std::string result = MapOkTrue(s);
  if (f.stamped) s->sm.Begin(sid, f.rseq);
  s->handled++;
  s->method_stats[reply_method].handled++;
  {
    std::string ev;
    mplite::w_map(ev, 3);
    mplite::w_str(ev, "actor_id");
    mplite::w_str(ev, f.actor_id);
    mplite::w_str(ev, "address");
    if (f.have_address) mplite::w_raw(ev, f.address_raw);
    else mplite::w_nil(ev);
    mplite::w_str(ev, "restarts");
    mplite::w_int(ev, ait->second.restarts);
    Inject2(s, "ready", ev);
  }
  if (msg_type == kMsgRequest)
    SendFrame(s, conn_id, kMsgResponse, seq, method, result);
  if (f.stamped) s->sm.Finish(sid, f.rseq, kMsgResponse, result);
  return 1;
}

}  // extern "C"
