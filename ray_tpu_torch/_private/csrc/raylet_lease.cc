// raylet_lease.cc — native raylet lease grant/return plane (graftgen).
//
// The raylet's hottest control RPC — RequestWorkerLease — grants
// entirely on the pump's epoll thread when the request is SIMPLE and
// the node can grant RIGHT NOW: no strategy, no placement group, not
// draining, no queued leases ahead (FIFO fairness gate), no GPU demand,
// resources fit, and an idle worker is pooled.  Everything else falls
// through to the Python policy shell untouched (spillback, queueing,
// worker spawn), counted in `fallthrough` (reference: local_task_manager.cc grants on
// the node_manager C++ loop; the policy residue lives above it).
//
// Resource accounting goes through the SAME native core the Python
// raylet uses (raylet_core.cc, via function pointers — rcore is
// thread-safe), so the two grant paths can never double-book a CPU.
// Worker identity is arbitrated by this plane's idle-worker mirror:
// Python pushes idle workers in (rlease_push) and must CLAIM through
// it before assigning one itself (rlease_claim) — a worker granted
// natively can never also be granted by Python.
//
// Native grants/returns are mirrored to Python bookkeeping via
// fpump_inject events ([event, payload] msgpack bodies).
//
// Sim mode (rlease_set_sim) turns the plane into a native CreateActor
// responder with full (sid, rseq) reply-cache semantics: it answers
// {"ok": true} and fires the ActorReady ladder step back at the caller.
// This is the mock raylet for bench.py --actor-churn AND the native
// side of the Python<->native differential replay test.
//
// Threading: rlease_on_frame/on_close run on the pump loop thread; all
// other entry points run on Python threads — one mutex guards state.

#include <time.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "generated/contract_gen.h"
#include "msgpack_lite.h"

namespace {

using mplite::View;

constexpr int kMsgRequest = 0;
constexpr int kMsgResponse = 1;
constexpr int kMsgError = 2;
constexpr int kMsgNotify = 3;
constexpr int64_t kNativeSeqBase = int64_t(1) << 40;

typedef int (*SendFn)(void* pump, int64_t conn, const void* buf,
                      uint32_t len);
typedef void (*InjectFn)(void* pump, int64_t token, const void* buf,
                         uint32_t len);
typedef int (*ChainFrameFn)(void* ctx, int64_t conn, const char* data,
                            uint32_t len);
typedef void (*ChainCloseFn)(void* ctx, int64_t conn);
// raylet_core.cc entry points (thread-safe; handed over as addresses).
typedef int (*AcquireFn)(void* rcore, const char* lease_id,
                         const char* resources, const char* pg_id,
                         int bundle_index);
typedef int (*ReleaseFn)(void* rcore, const char* lease_id);

// Node states mirrored from native_policy.py (death/drain ladder view).
constexpr int kNodeAlive = 0;

// Deterministic cross-incarnation replay rejection. MUST byte-match
// rpc.STALE_EPOCH_ERROR — the differential replay test pins them equal.
constexpr const char* kStaleEpochError =
    "stale session epoch: request may have executed before a server "
    "restart and its reply was lost; re-issue";

struct MethodStats {
  uint64_t handled = 0;
  uint64_t routed = 0;    // per-request fallthrough (complex shape etc.)
  uint64_t degraded = 0;  // breaker-forced fallthrough
};

struct Worker {
  std::string worker_id;
  std::string host;
  int64_t port = 0;
  int64_t fp_port = 0;
};

struct LeasePlane {
  std::mutex mu;
  SendFn send = nullptr;
  InjectFn inject = nullptr;
  void* pump = nullptr;
  int64_t inject_token = 0;

  ChainFrameFn chain_frame = nullptr;
  ChainCloseFn chain_close = nullptr;
  void* chain_ctx = nullptr;

  AcquireFn acquire = nullptr;
  ReleaseFn release = nullptr;
  void* rcore = nullptr;

  contractgen::SessionManager sm;

  std::string node_id;   // full node id (reply field)
  std::string node8;     // lease-id prefix (first 8 chars)
  uint64_t lease_seq = 0;

  // Idle-worker mirror: FIFO ring + membership set (claim arbiter).
  std::deque<std::string> idle;
  std::unordered_map<std::string, Worker> workers;  // pooled idle only
  // Native-granted leases: lease_id -> worker_id.
  std::unordered_map<std::string, std::string> native_leases;

  bool gate_open = true;   // false while Python has queued leases
  bool draining = false;
  // Ladder state of OUR OWN node as the GCS sees it: a
  // SUSPECT/DRAINING raylet must not keep granting natively — the GCS
  // may already be failing our leases over, so grants route to the
  // Python shell (which consults the same drain/death state).
  int node_state = kNodeAlive;
  bool sim = false;        // CreateActor responder mode

  // Divergence breaker: methods forced back to Python.
  std::unordered_map<std::string, bool> degraded_methods;
  std::unordered_map<std::string, MethodStats> method_stats;
  uint64_t degraded = 0;

  // Sim-mode outbound ActorReady session (per plane; dedup'd server-side).
  std::string sim_sid;
  int64_t sim_rseq = 0;
  int64_t out_seq = kNativeSeqBase;

  uint64_t handled = 0;
  uint64_t fallthrough = 0;
  std::atomic<uint64_t> proto_errors{0};
};

double NowS() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

void SendFrame(LeasePlane* s, int64_t conn_id, int msg_type, int64_t seq,
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

int Malformed(LeasePlane* s, int64_t conn_id, int64_t msg_type, int64_t seq,
              std::string_view method, const char* detail) {
  s->proto_errors.fetch_add(1, std::memory_order_relaxed);
  if (msg_type == kMsgRequest) {
    std::string msg = "native lease plane: malformed payload for ";
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

void Inject2(LeasePlane* s, const char* event,
             const std::string& payload_raw) {
  std::string body;
  body.reserve(payload_raw.size() + 24);
  mplite::w_array(body, 2);
  mplite::w_str(body, event);
  mplite::w_raw(body, payload_raw);
  s->inject(s->pump, s->inject_token, body.data(), (uint32_t)body.size());
}

// ---- RequestWorkerLease / ReturnWorker / CreateActor cursor ----

struct LeaseFields {
  // resources: str keys -> numeric values, re-encoded for rcore in the
  // exact native_raylet_core._enc format ("k=%.10g", RS-separated).
  std::string resources_enc;
  bool resources_ok = true;      // parseable as a simple numeric map
  bool complex_shape = false;    // strategy / placement_group / hops
  // A GPU demand: the worker must learn its cards (SetLeaseDevices)
  // before the grant, which only the Python handler can do.
  bool gpu_demand = false;
  std::string_view lease_id;     // ReturnWorker
  bool have_lease_id = false;
  bool kill = false;             // ReturnWorker
  std::string_view actor_id;     // CreateActor (sim)
  bool have_actor_id = false;
  std::string_view sid;
  bool stamped = false;
  int64_t rseq = 0;
  int64_t acked = 0;
  bool have_acked = false;
  int64_t epoch = 0;  // _epoch replay stamp (0 = fresh send / legacy)
};

bool AppendRes(std::string* out, std::string_view key, double val) {
  char buf[64];
  int n = snprintf(buf, sizeof buf, "%.10g", val);
  if (n <= 0) return false;
  if (!out->empty()) out->push_back('\x1e');
  out->append(key.data(), key.size());
  out->push_back('=');
  out->append(buf, (size_t)n);
  return true;
}

bool ParseFields(View& v, LeaseFields* f) {
  if (mplite::try_read_nil(v)) return true;
  uint32_t n;
  if (!mplite::read_map(v, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view k;
    if (!mplite::read_str(v, &k)) return false;
    if (k == "resources") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      uint32_t rn;
      if (!mplite::read_map(v, &rn)) {
        v.off = at;
        if (!mplite::skip(v)) return false;
        f->resources_ok = false;
        continue;
      }
      for (uint32_t j = 0; j < rn; j++) {
        std::string_view rk;
        if (!mplite::read_str(v, &rk)) return false;
        int64_t iv;
        size_t vat = v.off;
        if (mplite::read_int(v, &iv)) {
          if (!AppendRes(&f->resources_enc, rk, (double)iv)) return false;
          if (rk == "GPU" && iv > 0) f->gpu_demand = true;
          continue;
        }
        v.off = vat;
        // float64/float32 value
        if (v.has(1) && (v.peek() == 0xcb || v.peek() == 0xca)) {
          uint8_t tag = v.peek();
          v.off++;
          double d = 0;
          if (tag == 0xcb) {
            if (!v.has(8)) return false;
            uint64_t bits = v.be64(v.off);
            v.off += 8;
            memcpy(&d, &bits, 8);
          } else {
            if (!v.has(4)) return false;
            uint32_t bits = v.be32(v.off);
            v.off += 4;
            float fl;
            memcpy(&fl, &bits, 4);
            d = fl;
          }
          if (!AppendRes(&f->resources_enc, rk, d)) return false;
          if (rk == "GPU" && d > 0) f->gpu_demand = true;
          continue;
        }
        // Non-numeric resource value: not ours to judge.
        if (!mplite::skip(v)) return false;
        f->resources_ok = false;
      }
    } else if (k == "strategy") {
      if (!mplite::try_read_nil(v)) {
        f->complex_shape = true;
        if (!mplite::skip(v)) return false;
      }
    } else if (k == "placement_group") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      std::string_view pg;
      if (!mplite::read_str(v, &pg)) return false;
      if (!pg.empty()) f->complex_shape = true;
    } else if (k == "pg_bundle_index") {
      int64_t bi;
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      if (!mplite::read_int(v, &bi)) return false;
      if (bi >= 0) f->complex_shape = true;
    } else if (k == "hops") {
      if (!mplite::skip(v)) return false;
    } else if (k == "lease_id") {
      if (!mplite::read_str(v, &f->lease_id)) return false;
      f->have_lease_id = true;
    } else if (k == "kill") {
      size_t at = v.off;
      if (mplite::try_read_nil(v)) continue;
      v.off = at;
      if (!mplite::read_bool(v, &f->kill)) return false;
    } else if (k == "actor_id") {
      if (!mplite::read_str(v, &f->actor_id)) return false;
      f->have_actor_id = true;
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

// Granted-lease reply, shape-matched to raylet.py _grant_lease.
std::string GrantReply(LeasePlane* s, const std::string& lease_id,
                       const Worker& w, double received_at,
                       double acquired_at, double granted_at) {
  std::string r;
  mplite::w_map(r, s->sm.epoch != 0 ? 9 : 8);
  mplite::w_str(r, "granted");
  mplite::w_bool(r, true);
  mplite::w_str(r, "lease_id");
  mplite::w_str(r, lease_id);
  mplite::w_str(r, "worker_id");
  mplite::w_str(r, w.worker_id);
  mplite::w_str(r, "worker_host");
  mplite::w_str(r, w.host);
  mplite::w_str(r, "worker_port");
  mplite::w_int(r, w.port);
  mplite::w_str(r, "worker_fp_port");
  mplite::w_int(r, w.fp_port);
  mplite::w_str(r, "node_id");
  mplite::w_str(r, s->node_id);
  mplite::w_str(r, "lease_timing");
  mplite::w_map(r, 4);
  auto w_float = [&r](double d) {
    uint64_t bits;
    memcpy(&bits, &d, 8);
    r.push_back((char)0xcb);
    mplite::w_be64(r, bits);
  };
  mplite::w_str(r, "received_at");
  w_float(received_at);
  mplite::w_str(r, "granted_at");
  w_float(granted_at);
  mplite::w_str(r, "queue_wait_ms");
  w_float((acquired_at - received_at) * 1000.0);
  mplite::w_str(r, "worker_attach_ms");
  w_float((granted_at - acquired_at) * 1000.0);
  if (s->sm.epoch != 0) {
    mplite::w_str(r, "_epoch");
    mplite::w_int(r, (int64_t)s->sm.epoch);
  }
  return r;
}

// {"ok": true} plus the _epoch advertisement when an incarnation epoch
// is configured — byte-matching rpc._stamp_reply's key order ("ok"
// first, "_epoch" appended) so python/native replies stay identical.
std::string MapOkTrue(const LeasePlane* s) {
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

}  // namespace

extern "C" {

void* rlease_create(void* send_fn, void* inject_fn, void* pump,
                    int64_t inject_token, void* acquire_fn,
                    void* release_fn, void* rcore) {
  auto* s = new LeasePlane();
  s->send = (SendFn)send_fn;
  s->inject = (InjectFn)inject_fn;
  s->pump = pump;
  s->inject_token = inject_token;
  s->acquire = (AcquireFn)acquire_fn;
  s->release = (ReleaseFn)release_fn;
  s->rcore = rcore;
  char buf[48];
  snprintf(buf, sizeof buf, "rlsim-%llx",
           (unsigned long long)(uint64_t)(NowS() * 1e6));
  s->sim_sid = buf;
  return s;
}

void rlease_destroy(void* h) { delete static_cast<LeasePlane*>(h); }

void rlease_chain(void* h, void* next_frame, void* next_close,
                  void* next_ctx) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->chain_frame = (ChainFrameFn)next_frame;
  s->chain_close = (ChainCloseFn)next_close;
  s->chain_ctx = next_ctx;
}

void rlease_set_node(void* h, const char* node_id) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->node_id = node_id;
  s->node8 = s->node_id.substr(0, 8);
}

// FIFO fairness gate: closed while Python has queued leases — a fresh
// request must not be granted natively ahead of the queue (mirrors the
// pending_leases check in handle_request_worker_lease).
void rlease_set_gate(void* h, int open) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->gate_open = open != 0;
}

void rlease_set_draining(void* h, int draining) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->draining = draining != 0;
}

void rlease_set_sim(void* h, int sim) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->sim = sim != 0;
}

// Pool one idle worker into the mirror (idempotent on worker_id).
void rlease_push(void* h, const char* worker_id, const char* host,
                 int64_t port, int64_t fp_port) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string wid(worker_id);
  if (s->workers.count(wid)) return;
  s->workers[wid] = Worker{wid, host, port, fp_port};
  s->idle.push_back(wid);
}

// Claim arbiter: Python MUST claim a worker here before assigning it
// itself. 1 = claimed (it was pooled), 0 = not pooled (native already
// granted it, or it was never pushed) — the caller skips that worker.
int rlease_claim(void* h, const char* worker_id) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->workers.erase(std::string(worker_id)) > 0 ? 1 : 0;
}

// Worker died / killed: drop it from the pool wherever it is.
void rlease_remove(void* h, const char* worker_id) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->workers.erase(std::string(worker_id));
}

int64_t rlease_idle_count(void* h) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->workers.size();
}

int64_t rlease_session_count(void* h) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->sm.session_count();
}

void rlease_counters(void* h, uint64_t* handled, uint64_t* fallthrough,
                     uint64_t* deduped) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *handled = s->handled;
  *fallthrough = s->fallthrough;
  *deduped = s->sm.deduped_requests_total;
}

uint64_t rlease_proto_errors(void* h) {
  return static_cast<LeasePlane*>(h)->proto_errors.load(
      std::memory_order_relaxed);
}

// Install the server incarnation epoch (rpc._server_sessions.epoch) so
// native replies advertise the same value Python stamps and replays
// from dead incarnations are rejected identically on both paths.
void rlease_set_epoch(void* h, uint64_t epoch) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->sm.SetEpoch(epoch);
}

uint64_t rlease_stale_epoch_total(void* h) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->sm.stale_epoch_total;
}

// Ladder state of our own node as mirrored from the GCS view
// (native_policy NODE_* encoding); != ALIVE blocks native grants.
void rlease_set_node_state(void* h, int state) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->node_state = state;
}

// Divergence breaker control: on!=0 degrades `method` (every new
// request routes to Python); on==0 re-arms the native handler.
void rlease_set_degraded(void* h, const char* method, int on) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->degraded_methods[std::string(method)] = (on != 0);
}

uint64_t rlease_degraded_total(void* h) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->degraded;
}

void rlease_method_stats(void* h, const char* method, uint64_t* handled,
                         uint64_t* routed, uint64_t* degraded) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  const MethodStats& ms = s->method_stats[std::string(method)];
  *handled = ms.handled;
  *routed = ms.routed;
  *degraded = ms.degraded;
}

// Crash rehydration: replay one persisted native-lease-ledger
// row into the plane BEFORE install. Bumps lease_seq past the restored
// id's "-n<seq>" suffix so post-restart grants can never collide with a
// pre-restart lease id. Resource re-acquisition stays Python's job (the
// caller re-books rcore from its own persisted ledger).
void rlease_restore_lease(void* h, const char* lease_id,
                          const char* worker_id) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string lid(lease_id);
  s->native_leases[lid] = worker_id;
  size_t at = lid.rfind("-n");
  if (at != std::string::npos) {
    unsigned long long seq = strtoull(lid.c_str() + at + 2, nullptr, 10);
    if (seq > s->lease_seq) s->lease_seq = seq;
  }
}

int64_t rlease_native_lease_count(void* h) {
  auto* s = static_cast<LeasePlane*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return (int64_t)s->native_leases.size();
}

void rlease_on_close(void* h, int64_t conn_id) {
  auto* s = static_cast<LeasePlane*>(h);
  if (s->chain_close != nullptr) s->chain_close(s->chain_ctx, conn_id);
}

int rlease_on_frame(void* h, int64_t conn_id, const char* data,
                    uint32_t len) {
  auto* s = static_cast<LeasePlane*>(h);
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
    return 1;  // reply to our own sim-mode ActorReady: nothing to do
  }
  bool is_req = msg_type == kMsgRequest || msg_type == kMsgNotify;
  bool owned =
      is_req && (method == "RequestWorkerLease" ||
                 method == "ReturnWorker" ||
                 (method == "CreateActor" && s->sim));
  if (!owned) {
    return s->chain_frame != nullptr
               ? s->chain_frame(s->chain_ctx, conn_id, data, len)
               : 0;
  }

  const contractgen::MethodInfo* mi = contractgen::FindMethod(method);
  View vv = v;
  const char* missing = nullptr;
  if (mi != nullptr && mi->n_required > 0 &&
      !contractgen::ValidateRequired(*mi, vv, &missing))
    return Malformed(s, conn_id, msg_type, seq, method, missing);

  View fv = v;
  LeaseFields f;
  if (!ParseFields(fv, &f)) {
    if (mi != nullptr && mi->n_required > 0)
      return Malformed(s, conn_id, msg_type, seq, method, nullptr);
    // Zero-required methods (RequestWorkerLease/CreateActor) never
    // reject shapes here — Python answers whatever it answers.
    std::lock_guard<std::mutex> lock(s->mu);
    s->fallthrough++;
    return s->chain_frame != nullptr
               ? s->chain_frame(s->chain_ctx, conn_id, data, len)
               : 0;
  }

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
      return 0;
    }
    if (pr == contractgen::SessionManager::kProbeStaleEpoch) {
      // Replay from a pre-restart incarnation whose cached reply died
      // with the old process: deterministic rejection, byte-matching
      // Python's STALE_EPOCH_ERROR (differential test pins both).
      std::string err;
      mplite::w_str(err, kStaleEpochError);
      if (msg_type == kMsgRequest)
        SendFrame(s, conn_id, kMsgError, seq, method, err);
      return 1;
    }
  }
  auto route_to_python = [&]() -> int {
    if (f.stamped) s->sm.MarkRouted(sid, f.rseq);
    s->fallthrough++;
    s->method_stats[reply_method].routed++;
    return 0;
  };

  // Divergence breaker: a degraded method routes every NEW (sid, rseq)
  // to Python until the audit clears it (replays already served above).
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

  // graftgen: native-handler RequestWorkerLease
  if (method == "RequestWorkerLease") {
    if (f.complex_shape || f.gpu_demand || !f.resources_ok ||
        s->draining || s->node_state != kNodeAlive || !s->gate_open || s->idle.empty())
      return route_to_python();
    double received_at = NowS();
    s->lease_seq++;
    char lid[64];
    snprintf(lid, sizeof lid, "%s-n%llu", s->node8.c_str(),
             (unsigned long long)s->lease_seq);
    if (s->acquire(s->rcore, lid, f.resources_enc.c_str(), "", -1) != 1)
      return route_to_python();  // no fit NOW: Python queues/spills
    double acquired_at = NowS();
    // Claim an idle worker; stale ring entries (claimed/removed by
    // Python) are skipped.
    Worker w;
    bool got = false;
    while (!s->idle.empty()) {
      std::string wid = s->idle.front();
      s->idle.pop_front();
      auto wit = s->workers.find(wid);
      if (wit == s->workers.end()) continue;
      w = wit->second;
      s->workers.erase(wit);
      got = true;
      break;
    }
    if (!got) {
      // Pool raced empty: roll the acquisition back and let Python
      // spawn a worker. Transient state — pin the routing.
      s->release(s->rcore, lid);
      return route_to_python();
    }
    std::string lease_id(lid);
    s->native_leases[lease_id] = w.worker_id;
    double granted_at = NowS();
    std::string result =
        GrantReply(s, lease_id, w, received_at, acquired_at, granted_at);
    if (f.stamped) s->sm.Begin(sid, f.rseq);
    s->handled++;
    s->method_stats[reply_method].handled++;
    {
      std::string ev;
      mplite::w_map(ev, 2);
      mplite::w_str(ev, "lease_id");
      mplite::w_str(ev, lease_id);
      mplite::w_str(ev, "worker_id");
      mplite::w_str(ev, w.worker_id);
      Inject2(s, "lease_granted", ev);
    }
    if (msg_type == kMsgRequest)
      SendFrame(s, conn_id, kMsgResponse, seq, method, result);
    if (f.stamped) s->sm.Finish(sid, f.rseq, kMsgResponse, result);
    return 1;
  }

  // graftgen: native-handler ReturnWorker
  if (method == "ReturnWorker") {
    std::string lease_id(f.lease_id);
    auto lit = s->native_leases.find(lease_id);
    if (lit == s->native_leases.end())
      return route_to_python();  // Python-granted lease: Python's books
    std::string worker_id = lit->second;
    s->native_leases.erase(lit);
    s->release(s->rcore, lease_id.c_str());
    std::string result = MapOkTrue(s);
    if (f.stamped) s->sm.Begin(sid, f.rseq);
    s->handled++;
    s->method_stats[reply_method].handled++;
    std::string ev;
    mplite::w_map(ev, 3);
    mplite::w_str(ev, "lease_id");
    mplite::w_str(ev, lease_id);
    mplite::w_str(ev, "worker_id");
    mplite::w_str(ev, worker_id);
    mplite::w_str(ev, "kill");
    mplite::w_bool(ev, f.kill);
    // kill=true: Python reaps the process on the inject event; the
    // worker does NOT re-enter the pool either side.
    Inject2(s, "worker_returned", ev);
    if (msg_type == kMsgRequest)
      SendFrame(s, conn_id, kMsgResponse, seq, method, result);
    if (f.stamped) s->sm.Finish(sid, f.rseq, kMsgResponse, result);
    return 1;
  }

  // graftgen: native-handler CreateActor
  // CreateActor (sim mode): ack {"ok": true} under full session dedup,
  // then fire the ladder's next rung (ActorReady) back at the caller —
  // a mock raylet entirely in native code.
  std::string result = MapOkTrue(s);
  if (f.stamped) s->sm.Begin(sid, f.rseq);
  s->handled++;
  s->method_stats[reply_method].handled++;
  if (msg_type == kMsgRequest)
    SendFrame(s, conn_id, kMsgResponse, seq, method, result);
  if (f.stamped) s->sm.Finish(sid, f.rseq, kMsgResponse, result);
  if (f.have_actor_id) {
    int64_t rseq = ++s->sim_rseq;
    std::string payload;
    mplite::w_map(payload, 5);
    mplite::w_str(payload, "actor_id");
    mplite::w_str(payload, f.actor_id);
    mplite::w_str(payload, "address");
    mplite::w_array(payload, 2);
    mplite::w_str(payload, "sim");
    mplite::w_int(payload, 0);
    mplite::w_str(payload, "_session");
    mplite::w_str(payload, s->sim_sid);
    mplite::w_str(payload, "_rseq");
    mplite::w_int(payload, rseq);
    mplite::w_str(payload, "_acked");
    mplite::w_int(payload, rseq - 1);
    SendFrame(s, conn_id, kMsgRequest, ++s->out_seq, "ActorReady",
              payload);
  }
  return 1;
}

}  // extern "C"
