// raylet_lease_test.cc — native raylet lease grant/return plane tests.
//
// Exercises raylet_lease.cc against the REAL resource core
// (raylet_core.cc) so the double-booking invariant is tested against
// production accounting, not a mock: native grants and Python claims
// arbitrate over the same idle-worker mirror, and every grant/return
// moves CPUs through rcore.  Covers the fast-grant path and every
// fallthrough reason (complex shape, draining, FIFO gate, empty pool,
// no-fit rollback), replay dedup via the generated SessionManager,
// ReturnWorker ownership split, the sim-mode CreateActor responder
// (the bench/differential-test mock raylet), and a malformed-frame
// storm over the generated validators — the ASan fuzz gate mirroring
// gcs_service_test.cc.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

#include "generated/contract_gen.h"
#include "msgpack_lite.h"

extern "C" {
// fastpath.cc
void* fpump_create();
void fpump_destroy(void* p);
int fpump_listen(void* p, const char* host, int port);
int64_t fpump_connect(void* p, const char* host, int port);
int fpump_send(void* p, int64_t conn_id, const void* buf, uint32_t len);
void fpump_inject(void* p, int64_t token, const void* buf, uint32_t len);
int fpump_next(void* p, int64_t* conn_id, int* kind, void* out,
               uint32_t* len, int timeout_ms);
void fpump_set_service(void* p, void* frame_fn, void* close_fn, void* ctx);
// raylet_core.cc
void* rcore_create(const char* total_resources);
void rcore_destroy(void* h);
int rcore_try_acquire(void* h, const char* lease_id, const char* resources,
                      const char* pg_id, int bundle_index);
int rcore_release(void* h, const char* lease_id);
int rcore_num_leases(void* h);
// raylet_lease.cc
void* rlease_create(void* send_fn, void* inject_fn, void* pump,
                    int64_t inject_token, void* acquire_fn, void* release_fn,
                    void* rcore);
void rlease_destroy(void* h);
void rlease_chain(void* h, void* next_frame, void* next_close,
                  void* next_ctx);
void rlease_set_node(void* h, const char* node_id);
void rlease_set_gate(void* h, int open);
void rlease_set_draining(void* h, int draining);
void rlease_set_sim(void* h, int sim);
void rlease_push(void* h, const char* worker_id, const char* host,
                 int64_t port, int64_t fp_port);
int rlease_claim(void* h, const char* worker_id);
void rlease_remove(void* h, const char* worker_id);
int64_t rlease_idle_count(void* h);
int64_t rlease_session_count(void* h);
void rlease_counters(void* h, uint64_t* handled, uint64_t* fallthrough,
                     uint64_t* deduped);
uint64_t rlease_proto_errors(void* h);
void rlease_set_epoch(void* h, uint64_t epoch);
uint64_t rlease_stale_epoch_total(void* h);
void rlease_set_node_state(void* h, int state);
void rlease_set_degraded(void* h, const char* method, int on);
uint64_t rlease_degraded_total(void* h);
void rlease_method_stats(void* h, const char* method, uint64_t* handled,
                         uint64_t* routed, uint64_t* degraded);
void rlease_restore_lease(void* h, const char* lease_id,
                          const char* worker_id);
int64_t rlease_native_lease_count(void* h);
void rlease_on_close(void* h, int64_t conn_id);
int rlease_on_frame(void* h, int64_t conn_id, const char* data,
                    uint32_t len);
}

namespace {

using mplite::View;

constexpr int kEvFrame = 1;
constexpr int64_t kNativeSeqBase = int64_t(1) << 40;

int failures = 0;

#define CHECK(cond)                                               \
  do {                                                            \
    if (!(cond)) {                                                \
      std::printf("FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      failures++;                                                 \
    }                                                             \
  } while (0)

std::string PackFrame(int msg_type, int64_t seq, std::string_view method,
                      const std::string& payload) {
  std::string f;
  mplite::w_array(f, 4);
  mplite::w_int(f, msg_type);
  mplite::w_int(f, seq);
  mplite::w_str(f, method);
  mplite::w_raw(f, payload);
  return f;
}

// Capture sends/injects from the plane (no pump needed: rlease_on_frame
// is called directly and s->send/s->inject are these functions).
std::vector<std::string> g_sends;
std::vector<std::string> g_injects;

int CapSend(void* /*pump*/, int64_t /*conn*/, const void* buf,
            uint32_t len) {
  g_sends.emplace_back((const char*)buf, len);
  return 0;
}

void CapInject(void* /*pump*/, int64_t /*token*/, const void* buf,
               uint32_t len) {
  g_injects.emplace_back((const char*)buf, len);
}

bool DecodeEnvelope(const std::string& body, int64_t* msg_type, int64_t* seq,
                    std::string* method, std::string* payload) {
  View v{(const uint8_t*)body.data(), body.size(), 0};
  uint32_t alen;
  std::string_view m, raw;
  if (!mplite::read_array(v, &alen) || alen != 4) return false;
  if (!mplite::read_int(v, msg_type)) return false;
  if (!mplite::read_int(v, seq)) return false;
  if (!mplite::read_str(v, &m)) return false;
  if (!mplite::read_raw(v, &raw)) return false;
  method->assign(m);
  payload->assign(raw);
  return true;
}

bool DecodeInject(const std::string& body, std::string* event,
                  std::string* payload) {
  View v{(const uint8_t*)body.data(), body.size(), 0};
  uint32_t alen;
  std::string_view ev, raw;
  if (!mplite::read_array(v, &alen) || alen != 2) return false;
  if (!mplite::read_str(v, &ev)) return false;
  if (!mplite::read_raw(v, &raw)) return false;
  event->assign(ev);
  payload->assign(raw);
  return true;
}

// Flat string/int/float field extraction from a msgpack map payload.
struct GrantFields {
  bool granted = false;
  std::string lease_id, worker_id, worker_host, node_id;
  int64_t worker_port = -1, worker_fp_port = -1;
  double queue_wait_ms = -1, worker_attach_ms = -1;
  bool have_timing = false;
};

bool ParseGrant(const std::string& payload, GrantFields* g) {
  View v{(const uint8_t*)payload.data(), payload.size(), 0};
  uint32_t n;
  if (!mplite::read_map(v, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view k;
    if (!mplite::read_str(v, &k)) return false;
    if (k == "granted") {
      if (!mplite::read_bool(v, &g->granted)) return false;
    } else if (k == "lease_id" || k == "worker_id" || k == "worker_host" ||
               k == "node_id") {
      std::string_view s;
      if (!mplite::read_str(v, &s)) return false;
      if (k == "lease_id") g->lease_id.assign(s);
      else if (k == "worker_id") g->worker_id.assign(s);
      else if (k == "worker_host") g->worker_host.assign(s);
      else g->node_id.assign(s);
    } else if (k == "worker_port" || k == "worker_fp_port") {
      int64_t iv;
      if (!mplite::read_int(v, &iv)) return false;
      if (k == "worker_port") g->worker_port = iv;
      else g->worker_fp_port = iv;
    } else if (k == "lease_timing") {
      g->have_timing = true;
      uint32_t tn;
      if (!mplite::read_map(v, &tn)) return false;
      for (uint32_t j = 0; j < tn; j++) {
        std::string_view tk;
        if (!mplite::read_str(v, &tk)) return false;
        if (!v.has(9) || v.peek() != 0xcb) return false;  // float64
        uint64_t bits = v.be64(v.off + 1);
        v.off += 9;
        double d;
        memcpy(&d, &bits, 8);
        if (tk == "queue_wait_ms") g->queue_wait_ms = d;
        if (tk == "worker_attach_ms") g->worker_attach_ms = d;
      }
    } else {
      if (!mplite::skip(v)) return false;
    }
  }
  return true;
}

// RequestWorkerLease payload: resources {"CPU": cpu} + stamps.
std::string LeasePayload(double cpu, const char* sid, int64_t rseq,
                         const char* strategy = nullptr) {
  std::string p;
  uint32_t n = 4 + (strategy ? 1 : 0);
  mplite::w_map(p, n);
  mplite::w_str(p, "resources");
  mplite::w_map(p, 1);
  mplite::w_str(p, "CPU");
  if (cpu == (double)(int64_t)cpu) {
    mplite::w_int(p, (int64_t)cpu);
  } else {
    uint64_t bits;
    memcpy(&bits, &cpu, 8);
    p.push_back((char)0xcb);
    mplite::w_be64(p, bits);
  }
  if (strategy) {
    mplite::w_str(p, "strategy");
    mplite::w_str(p, strategy);
  }
  mplite::w_str(p, "_session");
  mplite::w_str(p, sid);
  mplite::w_str(p, "_rseq");
  mplite::w_int(p, rseq);
  mplite::w_str(p, "_acked");
  mplite::w_int(p, rseq - 1);
  return p;
}

// RequestWorkerLease payload with a GPU share: {"CPU": 1, "GPU": gpu}.
std::string GpuLeasePayload(double gpu, const char* sid, int64_t rseq) {
  std::string p;
  mplite::w_map(p, 4);
  mplite::w_str(p, "resources");
  mplite::w_map(p, 2);
  mplite::w_str(p, "CPU");
  mplite::w_int(p, 1);
  mplite::w_str(p, "GPU");
  uint64_t bits;
  memcpy(&bits, &gpu, 8);
  p.push_back((char)0xcb);
  mplite::w_be64(p, bits);
  mplite::w_str(p, "_session");
  mplite::w_str(p, sid);
  mplite::w_str(p, "_rseq");
  mplite::w_int(p, rseq);
  mplite::w_str(p, "_acked");
  mplite::w_int(p, rseq - 1);
  return p;
}

std::string ReturnPayload(const std::string& lease_id, bool kill,
                          const char* sid, int64_t rseq) {
  std::string p;
  mplite::w_map(p, 5);
  mplite::w_str(p, "lease_id");
  mplite::w_str(p, lease_id);
  mplite::w_str(p, "kill");
  mplite::w_bool(p, kill);
  mplite::w_str(p, "_session");
  mplite::w_str(p, sid);
  mplite::w_str(p, "_rseq");
  mplite::w_int(p, rseq);
  mplite::w_str(p, "_acked");
  mplite::w_int(p, rseq - 1);
  return p;
}

void TestGrantAndReturn() {
  void* rcore = rcore_create("CPU=2");
  void* plane = rlease_create((void*)&CapSend, (void*)&CapInject, nullptr, 2,
                              (void*)&rcore_try_acquire,
                              (void*)&rcore_release, rcore);
  rlease_set_node(plane, "node12345678abcd");
  g_sends.clear();
  g_injects.clear();

  // Empty pool: route to Python (return 0), nothing sent.
  std::string req = PackFrame(0, 1, "RequestWorkerLease",
                              LeasePayload(1, "cli-1", 1));
  CHECK(rlease_on_frame(plane, 9, req.data(), (uint32_t)req.size()) == 0);
  CHECK(g_sends.empty());
  uint64_t handled, fallthrough, deduped;
  rlease_counters(plane, &handled, &fallthrough, &deduped);
  CHECK(fallthrough == 1);
  // ... and the routing is pinned: a replay of the same (sid, rseq)
  // keeps falling through even now that a worker is pooled.
  rlease_push(plane, "w1", "10.0.0.1", 7001, 7101);
  CHECK(rlease_idle_count(plane) == 1);
  CHECK(rlease_on_frame(plane, 9, req.data(), (uint32_t)req.size()) == 0);
  CHECK(rlease_idle_count(plane) == 1);  // nothing granted on the replay
  CHECK(rcore_num_leases(rcore) == 0);

  // Fresh (sid, rseq): native fast grant. Reply shape matches raylet.py
  // _grant_lease; lease id carries the native -n marker; rcore books it.
  std::string req2 = PackFrame(0, 2, "RequestWorkerLease",
                               LeasePayload(1, "cli-1", 2));
  CHECK(rlease_on_frame(plane, 9, req2.data(), (uint32_t)req2.size()) == 1);
  CHECK(g_sends.size() == 1);
  int64_t msg_type, seq;
  std::string method, payload;
  CHECK(DecodeEnvelope(g_sends[0], &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && seq == 2 && method == "RequestWorkerLease");
  GrantFields g;
  CHECK(ParseGrant(payload, &g));
  CHECK(g.granted);
  CHECK(g.lease_id == "node1234-n1");
  CHECK(g.worker_id == "w1");
  CHECK(g.worker_host == "10.0.0.1");
  CHECK(g.worker_port == 7001 && g.worker_fp_port == 7101);
  CHECK(g.node_id == "node12345678abcd");
  CHECK(g.have_timing);
  CHECK(g.queue_wait_ms >= 0 && g.worker_attach_ms >= 0);
  CHECK(rcore_num_leases(rcore) == 1);
  CHECK(rlease_idle_count(plane) == 0);
  // Mirror event for Python bookkeeping.
  CHECK(g_injects.size() == 1);
  std::string ev, evp;
  CHECK(DecodeInject(g_injects[0], &ev, &evp));
  CHECK(ev == "lease_granted");
  // Python can no longer claim the granted worker.
  CHECK(rlease_claim(plane, "w1") == 0);

  // Replay of the granted request: answered byte-identically from the
  // reply cache — no second grant, no rcore movement.
  std::string first_grant = g_sends[0];
  CHECK(rlease_on_frame(plane, 9, req2.data(), (uint32_t)req2.size()) == 1);
  CHECK(g_sends.size() == 2);
  CHECK(g_sends[1] == first_grant);
  CHECK(rcore_num_leases(rcore) == 1);
  rlease_counters(plane, &handled, &fallthrough, &deduped);
  CHECK(handled == 1 && deduped == 1);
  CHECK(rlease_session_count(plane) == 1);

  // Claim arbitration: Python claims a pooled worker exactly once.
  rlease_push(plane, "w2", "10.0.0.1", 7002, 7102);
  CHECK(rlease_claim(plane, "w2") == 1);
  CHECK(rlease_claim(plane, "w2") == 0);
  // The ring entry for w2 is now stale; a grant must skip it. With no
  // live pooled worker the request routes to Python and the CPU
  // acquisition is rolled back (no leaked booking).
  std::string req3 = PackFrame(0, 3, "RequestWorkerLease",
                               LeasePayload(1, "cli-1", 3));
  CHECK(rlease_on_frame(plane, 9, req3.data(), (uint32_t)req3.size()) == 0);
  CHECK(rcore_num_leases(rcore) == 1);  // still only the w1 lease

  // No-fit: CPU=9 over a 2-CPU node -> route to Python (queue/spill).
  rlease_push(plane, "w3", "10.0.0.1", 7003, 7103);
  std::string req4 = PackFrame(0, 4, "RequestWorkerLease",
                               LeasePayload(9, "cli-1", 4));
  CHECK(rlease_on_frame(plane, 9, req4.data(), (uint32_t)req4.size()) == 0);
  CHECK(rcore_num_leases(rcore) == 1);

  // Complex shape (strategy): Python policy shell.
  std::string req5 = PackFrame(0, 5, "RequestWorkerLease",
                               LeasePayload(1, "cli-1", 5, "SPREAD"));
  CHECK(rlease_on_frame(plane, 9, req5.data(), (uint32_t)req5.size()) == 0);

  // FIFO gate closed (Python has queued leases): no native grant.
  rlease_set_gate(plane, 0);
  std::string req6 = PackFrame(0, 6, "RequestWorkerLease",
                               LeasePayload(1, "cli-1", 6));
  CHECK(rlease_on_frame(plane, 9, req6.data(), (uint32_t)req6.size()) == 0);
  rlease_set_gate(plane, 1);

  // Draining node: no native grant.
  rlease_set_draining(plane, 1);
  std::string req7 = PackFrame(0, 7, "RequestWorkerLease",
                               LeasePayload(1, "cli-1", 7));
  CHECK(rlease_on_frame(plane, 9, req7.data(), (uint32_t)req7.size()) == 0);
  rlease_set_draining(plane, 0);

  // GPU demand: the worker must learn its cards before the grant, so
  // Python handles it (counted as routed), with a worker pooled and the
  // gate open; nothing is booked.
  uint64_t routed_before, h_, d_;
  rlease_method_stats(plane, "RequestWorkerLease", &h_, &routed_before,
                      &d_);
  std::string reqg = PackFrame(0, 70, "RequestWorkerLease",
                               GpuLeasePayload(0.25, "cli-1", 70));
  CHECK(rlease_on_frame(plane, 9, reqg.data(), (uint32_t)reqg.size()) == 0);
  CHECK(rcore_num_leases(rcore) == 1);
  CHECK(rlease_idle_count(plane) == 1);
  uint64_t routed_after;
  rlease_method_stats(plane, "RequestWorkerLease", &h_, &routed_after, &d_);
  CHECK(routed_after == routed_before + 1);

  // Fractional resources go through the same rcore math as Python.
  std::string req8 = PackFrame(0, 8, "RequestWorkerLease",
                               LeasePayload(0.5, "cli-1", 8));
  CHECK(rlease_on_frame(plane, 9, req8.data(), (uint32_t)req8.size()) == 1);
  GrantFields g2;
  CHECK(DecodeEnvelope(g_sends.back(), &msg_type, &seq, &method, &payload));
  CHECK(ParseGrant(payload, &g2));
  CHECK(g2.granted && g2.worker_id == "w3");
  CHECK(rcore_num_leases(rcore) == 2);

  // ReturnWorker for a NATIVE lease: released in rcore, mirrored to
  // Python with the kill flag; the worker does not silently re-pool.
  g_injects.clear();
  std::string ret = PackFrame(0, 9, "ReturnWorker",
                              ReturnPayload(g2.lease_id, false, "cli-1", 9));
  CHECK(rlease_on_frame(plane, 9, ret.data(), (uint32_t)ret.size()) == 1);
  CHECK(rcore_num_leases(rcore) == 1);
  CHECK(DecodeInject(g_injects.back(), &ev, &evp));
  CHECK(ev == "worker_returned");
  CHECK(rlease_idle_count(plane) == 0);  // Python re-pools via the event
  // Double return (replay): cached, no double release.
  CHECK(rlease_on_frame(plane, 9, ret.data(), (uint32_t)ret.size()) == 1);
  CHECK(rcore_num_leases(rcore) == 1);

  // ReturnWorker for an UNKNOWN (Python-granted) lease: Python's books.
  std::string ret2 = PackFrame(0, 10, "ReturnWorker",
                               ReturnPayload("node1234-77", false, "cli-1",
                                             10));
  CHECK(rlease_on_frame(plane, 9, ret2.data(), (uint32_t)ret2.size()) == 0);

  // Worker death: removed from the pool, claim fails afterwards.
  rlease_push(plane, "w4", "10.0.0.1", 7004, 7104);
  rlease_remove(plane, "w4");
  CHECK(rlease_claim(plane, "w4") == 0);

  CHECK(rlease_proto_errors(plane) == 0);
  rlease_destroy(plane);
  rcore_destroy(rcore);
}

void TestSimCreateActor() {
  void* plane = rlease_create((void*)&CapSend, (void*)&CapInject, nullptr, 2,
                              nullptr, nullptr, nullptr);
  g_sends.clear();

  // Sim off: CreateActor is not owned — falls through untouched.
  std::string cp;
  mplite::w_map(cp, 4);
  mplite::w_str(cp, "actor_id");
  mplite::w_str(cp, "a1");
  mplite::w_str(cp, "_session");
  mplite::w_str(cp, "gcs-1");
  mplite::w_str(cp, "_rseq");
  mplite::w_int(cp, 1);
  mplite::w_str(cp, "_acked");
  mplite::w_int(cp, 0);
  std::string create = PackFrame(0, kNativeSeqBase + 1, "CreateActor", cp);
  CHECK(rlease_on_frame(plane, 3, create.data(), (uint32_t)create.size())
        == 0);
  CHECK(g_sends.empty());

  // Sim on: the plane is the mock raylet — ack {"ok": true} under full
  // session dedup, then fire the stamped ActorReady rung back.
  rlease_set_sim(plane, 1);
  CHECK(rlease_on_frame(plane, 3, create.data(), (uint32_t)create.size())
        == 1);
  CHECK(g_sends.size() == 2);
  int64_t msg_type, seq;
  std::string method, payload;
  CHECK(DecodeEnvelope(g_sends[0], &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && seq == kNativeSeqBase + 1 &&
        method == "CreateActor");
  const uint8_t ok_true[] = {0x81, 0xa2, 'o', 'k', 0xc3};
  CHECK(payload.size() == sizeof(ok_true) &&
        memcmp(payload.data(), ok_true, sizeof(ok_true)) == 0);
  CHECK(DecodeEnvelope(g_sends[1], &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 0 && method == "ActorReady");
  CHECK(seq >= kNativeSeqBase);  // own out-seq range: replies swallowed
  {
    View v{(const uint8_t*)payload.data(), payload.size(), 0};
    uint32_t n;
    CHECK(mplite::read_map(v, &n) && n == 5);
    bool saw_sid = false, saw_rseq = false, saw_actor = false;
    for (uint32_t i = 0; i < n && failures == 0; i++) {
      std::string_view k;
      CHECK(mplite::read_str(v, &k));
      if (k == "actor_id") {
        std::string_view a;
        CHECK(mplite::read_str(v, &a) && a == "a1");
        saw_actor = true;
      } else if (k == "_session") {
        std::string_view s;
        CHECK(mplite::read_str(v, &s));
        CHECK(s.substr(0, 6) == "rlsim-");
        saw_sid = true;
      } else if (k == "_rseq") {
        int64_t r;
        CHECK(mplite::read_int(v, &r) && r == 1);
        saw_rseq = true;
      } else {
        CHECK(mplite::skip(v));
      }
    }
    CHECK(saw_actor && saw_sid && saw_rseq);
  }

  // Replay the same CreateActor (sid, rseq): cached ack only — the
  // ladder rung does NOT fire twice (at-most-once across replays).
  CHECK(rlease_on_frame(plane, 3, create.data(), (uint32_t)create.size())
        == 1);
  CHECK(g_sends.size() == 3);
  CHECK(g_sends[2] == g_sends[0]);
  uint64_t handled, fallthrough, deduped;
  rlease_counters(plane, &handled, &fallthrough, &deduped);
  CHECK(handled == 1 && deduped == 1);

  // The caller's reply to our ActorReady (native seq range) is
  // swallowed, not chained to Python.
  std::string ack = PackFrame(1, seq, "ActorReady", std::string("\xc0", 1));
  CHECK(rlease_on_frame(plane, 3, ack.data(), (uint32_t)ack.size()) == 1);

  rlease_destroy(plane);
}

void TestMalformedFrames() {
  void* plane = rlease_create((void*)&CapSend, (void*)&CapInject, nullptr, 2,
                              nullptr, nullptr, nullptr);
  rlease_set_node(plane, "nodeff");
  g_sends.clear();

  std::string env;
  mplite::w_array(env, 4);
  mplite::w_int(env, 0);  // MSG_REQUEST
  mplite::w_int(env, 77);
  mplite::w_str(env, "ReturnWorker");
  std::string payload = ReturnPayload("node1234-n1", false, "cli-9", 1);
  std::string frame = env + payload;

  // Envelope truncation: pass-through (no chain installed -> 0).
  for (size_t cut = 0; cut < env.size(); cut++) {
    CHECK(rlease_on_frame(plane, 1, frame.data(), (uint32_t)cut) == 0);
  }
  CHECK(g_sends.empty());
  CHECK(rlease_proto_errors(plane) == 0);

  // Payload truncation: ReturnWorker requires lease_id, so every cut
  // inside the payload must answer one Malformed error echoing seq 77.
  int malformed = 0;
  for (size_t cut = env.size(); cut < frame.size(); cut++) {
    CHECK(rlease_on_frame(plane, 1, frame.data(), (uint32_t)cut) == 1);
    malformed++;
    CHECK((int)g_sends.size() == malformed);
    View v{(const uint8_t*)g_sends.back().data(), g_sends.back().size(), 0};
    uint32_t alen;
    int64_t mt, seq;
    std::string_view method, msg;
    CHECK(mplite::read_array(v, &alen) && alen == 4);
    CHECK(mplite::read_int(v, &mt) && mt == 2);  // MSG_ERROR
    CHECK(mplite::read_int(v, &seq) && seq == 77);
    CHECK(mplite::read_str(v, &method) && method == "ReturnWorker");
    CHECK(mplite::read_str(v, &msg));
    CHECK(msg.find("malformed payload for ReturnWorker") !=
          std::string_view::npos);
  }
  CHECK(rlease_proto_errors(plane) == (uint64_t)malformed);

  // RequestWorkerLease has zero required fields: even an unparseable
  // payload is never rejected natively — Python answers whatever it
  // answers (shape parity beats strictness on the hot path).
  std::string lenv;
  mplite::w_array(lenv, 4);
  mplite::w_int(lenv, 0);
  mplite::w_int(lenv, 78);
  mplite::w_str(lenv, "RequestWorkerLease");
  std::string garbage_payload = "\x81\xa3res";  // truncated map
  std::string lframe = lenv + garbage_payload;
  size_t sends_before = g_sends.size();
  CHECK(rlease_on_frame(plane, 1, lframe.data(), (uint32_t)lframe.size())
        == 0);
  CHECK(g_sends.size() == sends_before);

  // Bit flips and PRNG garbage: any verdict, never a crash (ASan gate).
  for (size_t i = 0; i < frame.size(); i++) {
    for (uint8_t mask : {0xFF, 0x80, 0x01}) {
      std::string m = frame;
      m[i] = (char)(m[i] ^ mask);
      int r = rlease_on_frame(plane, 1, m.data(), (uint32_t)m.size());
      CHECK(r == 0 || r == 1);
    }
  }
  uint64_t rng = 0x2545f4914f6cdd1dull;
  auto next = [&rng]() {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    return (uint8_t)(rng >> 33);
  };
  for (int it = 0; it < 512; it++) {
    std::string buf;
    size_t n = next() % 97;
    for (size_t i = 0; i < n; i++) buf.push_back((char)next());
    int r = rlease_on_frame(plane, 1, buf.data(), (uint32_t)buf.size());
    CHECK(r == 0 || r == 1);
  }

  rlease_destroy(plane);
}

// The fast-grant path over a real loopback pump: the plane installed
// as the in-pump service grants on the epoll thread and the client
// sees the reply without any Python-side hop.
void TestGrantThroughPump() {
  void* rcore = rcore_create("CPU=4");
  void* server = fpump_create();
  void* plane = rlease_create((void*)&fpump_send, (void*)&fpump_inject,
                              server, 2, (void*)&rcore_try_acquire,
                              (void*)&rcore_release, rcore);
  rlease_set_node(plane, "pumpnode12345678");
  fpump_set_service(server, (void*)&rlease_on_frame, (void*)&rlease_on_close,
                    plane);
  int port = fpump_listen(server, "127.0.0.1", 0);
  CHECK(port > 0);
  rlease_push(plane, "w1", "127.0.0.1", 7001, 7101);

  void* client = fpump_create();
  int64_t conn = fpump_connect(client, "127.0.0.1", port);
  CHECK(conn > 0);

  std::string req = PackFrame(0, 100, "RequestWorkerLease",
                              LeasePayload(1, "pcli-1", 1));
  CHECK(fpump_send(client, conn, req.data(), (uint32_t)req.size()) == 0);

  std::vector<char> buf(1 << 16);
  std::string body;
  for (;;) {
    int64_t cid;
    int kind;
    uint32_t len = (uint32_t)buf.size();
    int r = fpump_next(client, &cid, &kind, buf.data(), &len, 3000);
    CHECK(r == 1);
    if (r != 1) break;
    if (kind == kEvFrame) {
      body.assign(buf.data(), len);
      break;
    }
  }
  int64_t msg_type, seq;
  std::string method, payload;
  CHECK(DecodeEnvelope(body, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && seq == 100);
  GrantFields g;
  CHECK(ParseGrant(payload, &g));
  CHECK(g.granted && g.worker_id == "w1");
  CHECK(rcore_num_leases(rcore) == 1);

  fpump_destroy(client);
  fpump_destroy(server);
  rlease_destroy(plane);
  rcore_destroy(rcore);
}

// ---- epoch handshake, ledger rehydration, breaker ----

std::string LeasePayloadEpoch(double cpu, const char* sid, int64_t rseq,
                              int64_t epoch) {
  std::string p = LeasePayload(cpu, sid, rseq);
  // Re-pack with the _epoch stamp appended (map header count +1).
  std::string out;
  View v{(const uint8_t*)p.data(), p.size(), 0};
  uint32_t n;
  if (!mplite::read_map(v, &n)) return p;
  mplite::w_map(out, n + 1);
  out.append(p, v.off, std::string::npos);
  mplite::w_str(out, "_epoch");
  mplite::w_int(out, epoch);
  return out;
}

void TestEpochRestoreDegraded() {
  void* rcore = rcore_create("CPU=4");
  void* plane = rlease_create((void*)&CapSend, (void*)&CapInject, nullptr, 2,
                              (void*)&rcore_try_acquire,
                              (void*)&rcore_release, rcore);
  rlease_set_node(plane, "epnode1234567890");
  rlease_set_epoch(plane, 42);
  rlease_push(plane, "w1", "10.0.0.1", 7001, 7101);
  g_sends.clear();

  // Fresh grant: the reply advertises the incarnation epoch as its
  // LAST key (rpc._stamp_reply appends after existing keys).
  std::string req = PackFrame(0, 1, "RequestWorkerLease",
                              LeasePayload(1, "ecli-1", 1));
  CHECK(rlease_on_frame(plane, 9, req.data(), (uint32_t)req.size()) == 1);
  int64_t msg_type, seq;
  std::string method, payload;
  CHECK(DecodeEnvelope(g_sends.back(), &msg_type, &seq, &method, &payload));
  GrantFields g;
  CHECK(ParseGrant(payload, &g));
  CHECK(g.granted);
  {
    View v{(const uint8_t*)payload.data(), payload.size(), 0};
    uint32_t n;
    CHECK(mplite::read_map(v, &n) && n == 9);
    bool saw_epoch = false;
    for (uint32_t i = 0; i < n; i++) {
      std::string_view k;
      CHECK(mplite::read_str(v, &k));
      if (k == "_epoch") {
        int64_t e;
        CHECK(mplite::read_int(v, &e) && e == 42);
        saw_epoch = true;
      } else {
        CHECK(mplite::skip(v));
      }
    }
    CHECK(saw_epoch);
  }

  // Same-epoch replay: cached reply, no stale rejection.
  std::string rep = PackFrame(0, 1, "RequestWorkerLease",
                              LeasePayloadEpoch(1, "ecli-1", 1, 42));
  CHECK(rlease_on_frame(plane, 9, rep.data(), (uint32_t)rep.size()) == 1);
  CHECK(g_sends.back() == g_sends.front());
  CHECK(rlease_stale_epoch_total(plane) == 0);

  // Dead-incarnation replay with no cache entry: deterministic error.
  std::string stale = PackFrame(0, 2, "RequestWorkerLease",
                                LeasePayloadEpoch(1, "ecli-1", 2, 41));
  CHECK(rlease_on_frame(plane, 9, stale.data(), (uint32_t)stale.size())
        == 1);
  CHECK(rlease_stale_epoch_total(plane) == 1);
  {
    View v{(const uint8_t*)g_sends.back().data(), g_sends.back().size(), 0};
    uint32_t alen;
    int64_t mt, es;
    std::string_view m, msg;
    CHECK(mplite::read_array(v, &alen) && alen == 4);
    CHECK(mplite::read_int(v, &mt) && mt == 2);  // MSG_ERROR
    CHECK(mplite::read_int(v, &es) && es == 2);
    CHECK(mplite::read_str(v, &m) && m == "RequestWorkerLease");
    CHECK(mplite::read_str(v, &msg));
    CHECK(msg.substr(0, 19) == "stale session epoch");
  }
  CHECK(rcore_num_leases(rcore) == 1);  // nothing was granted for it

  // SUSPECT/DRAINING node state (GCS ladder mirror): no native grant.
  rlease_push(plane, "w2", "10.0.0.1", 7002, 7102);
  rlease_set_node_state(plane, /*SUSPECT=*/1);
  std::string req3 = PackFrame(0, 3, "RequestWorkerLease",
                               LeasePayload(1, "ecli-1", 3));
  CHECK(rlease_on_frame(plane, 9, req3.data(), (uint32_t)req3.size()) == 0);
  CHECK(rcore_num_leases(rcore) == 1);
  rlease_set_node_state(plane, /*ALIVE=*/0);

  // Breaker: degraded RequestWorkerLease routes to Python, counted.
  rlease_set_degraded(plane, "RequestWorkerLease", 1);
  std::string req4 = PackFrame(0, 4, "RequestWorkerLease",
                               LeasePayload(1, "ecli-1", 4));
  CHECK(rlease_on_frame(plane, 9, req4.data(), (uint32_t)req4.size()) == 0);
  CHECK(rlease_degraded_total(plane) == 1);
  uint64_t mh, mr, md;
  rlease_method_stats(plane, "RequestWorkerLease", &mh, &mr, &md);
  CHECK(mh == 1 && md == 1);
  rlease_set_degraded(plane, "RequestWorkerLease", 0);
  std::string req5 = PackFrame(0, 5, "RequestWorkerLease",
                               LeasePayload(1, "ecli-1", 5));
  CHECK(rlease_on_frame(plane, 9, req5.data(), (uint32_t)req5.size()) == 1);
  rlease_destroy(plane);

  // Ledger rehydration on a NEW plane (raylet restart): the restored
  // native lease is returnable natively, and lease_seq advanced past
  // the restored id so new grants cannot collide.
  void* p2 = rlease_create((void*)&CapSend, (void*)&CapInject, nullptr, 2,
                           (void*)&rcore_try_acquire,
                           (void*)&rcore_release, rcore);
  rlease_set_node(p2, "epnode1234567890");
  rlease_set_epoch(p2, 43);
  rlease_restore_lease(p2, "epnode12-n7", "w1");
  CHECK(rlease_native_lease_count(p2) == 1);
  // Python re-books rcore from its own ledger on restart.
  CHECK(rcore_try_acquire(rcore, "epnode12-n7", "CPU=1", "", -1) == 1);
  rlease_push(p2, "w9", "10.0.0.1", 7009, 7109);
  g_sends.clear();
  std::string req6 = PackFrame(0, 6, "RequestWorkerLease",
                               LeasePayload(1, "rcli-1", 1));
  CHECK(rlease_on_frame(p2, 9, req6.data(), (uint32_t)req6.size()) == 1);
  CHECK(DecodeEnvelope(g_sends.back(), &msg_type, &seq, &method, &payload));
  GrantFields g6;
  CHECK(ParseGrant(payload, &g6));
  CHECK(g6.granted && g6.lease_id == "epnode12-n8");  // past restored -n7
  std::string ret = PackFrame(0, 7, "ReturnWorker",
                              ReturnPayload("epnode12-n7", false, "rcli-1",
                                            2));
  int leases_before = rcore_num_leases(rcore);
  CHECK(rlease_on_frame(p2, 9, ret.data(), (uint32_t)ret.size()) == 1);
  CHECK(rcore_num_leases(rcore) == leases_before - 1);
  CHECK(rlease_native_lease_count(p2) == 1);  // only the new grant left
  rlease_destroy(p2);
  rcore_destroy(rcore);
}

}  // namespace

int main() {
  TestGrantAndReturn();
  TestSimCreateActor();
  TestMalformedFrames();
  TestGrantThroughPump();
  TestEpochRestoreDegraded();
  if (failures == 0) {
    std::printf("raylet_lease_test: all OK\n");
    return 0;
  }
  std::printf("raylet_lease_test: %d FAILURES\n", failures);
  return 1;
}
