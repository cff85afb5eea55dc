// gcs_actor_test.cc — native GCS actor-creation plane tests.
//
// Drives gcs_actor.cc through a REAL fastpath pump (server pump with
// the plane installed as the in-pump service, driver + fake-raylet
// clients over loopback TCP), covering the full native ladder:
// RegisterActor -> round-robin pick -> CreateActor out -> ActorReady
// -> ALIVE, with mirror events observed on the EV_INJECT queue.  Also
// exercises the graftgen layer directly: the generated validator table
// is fuzzed for EVERY method with required fields (missing-key,
// truncation at every offset), and the plane's malformed-payload path
// is stormed with truncations, bit flips and PRNG garbage — under
// ASan/UBSan (make test-asan) this is the fuzz gate for the generated
// contract tables, mirroring the gcs_service_test.cc pattern.

#include <time.h>

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
// gcs_actor.cc
void* gact_create(void* send_fn, void* inject_fn, void* pump,
                  int64_t inject_token);
void gact_destroy(void* h);
void gact_chain(void* h, void* next_frame, void* next_close, void* next_ctx);
void gact_node_up(void* h, const char* node_id, int64_t conn_id);
void gact_node_down(void* h, const char* node_id);
void gact_actor_forget(void* h, const char* actor_id);
void gact_counters(void* h, uint64_t* handled, uint64_t* fallthrough,
                   uint64_t* deduped);
uint64_t gact_proto_errors(void* h);
int64_t gact_actor_count(void* h);
int64_t gact_session_count(void* h);
void gact_set_epoch(void* h, uint64_t epoch);
uint64_t gact_stale_epoch_total(void* h);
void gact_node_state(void* h, const char* node_id, int state);
void gact_set_degraded(void* h, const char* method, int on);
uint64_t gact_degraded_total(void* h);
void gact_method_stats(void* h, const char* method, uint64_t* handled,
                       uint64_t* routed, uint64_t* degraded);
void gact_restore_actor(void* h, const char* actor_id, const char* state,
                        int64_t restarts, int64_t max_restarts,
                        const char* node_id, const char* spec,
                        uint32_t spec_len, const char* resources,
                        uint32_t res_len);
void gact_restore_node(void* h, const char* node_id, int state);
int gact_actor_state(void* h, const char* actor_id, char* buf, uint32_t cap);
void gact_on_close(void* h, int64_t conn_id);
int gact_on_frame(void* h, int64_t conn_id, const char* data, uint32_t len);
}

namespace {

using mplite::View;

constexpr int kEvFrame = 1;
constexpr int kEvAccept = 2;
constexpr int kEvInject = 4;
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

// Wait for one event of `want_kind` on the pump, skipping others.
bool NextEvent(void* pump, int want_kind, std::string* body,
               int64_t* id = nullptr, int timeout_ms = 3000) {
  std::vector<char> buf(1 << 20);
  for (;;) {
    int64_t cid;
    int kind;
    uint32_t len = (uint32_t)buf.size();
    int r = fpump_next(pump, &cid, &kind, buf.data(), &len, timeout_ms);
    if (r != 1) return false;
    if (kind == want_kind) {
      if (body) body->assign(buf.data(), len);
      if (id) *id = cid;
      return true;
    }
  }
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

// Decode an EV_INJECT body: msgpack [event, payload].
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

// Pull string/int fields out of a flat msgpack map payload.
struct FlatMap {
  std::string_view str(std::string_view key) const {
    for (auto& [k, val] : strs)
      if (k == key) return val;
    return {};
  }
  bool has_int(std::string_view key, int64_t* out) const {
    for (auto& [k, val] : ints)
      if (k == key) {
        *out = val;
        return true;
      }
    return false;
  }
  std::string_view raw(std::string_view key) const {
    for (auto& [k, val] : raws)
      if (k == key) return val;
    return {};
  }
  std::vector<std::pair<std::string_view, std::string_view>> strs;
  std::vector<std::pair<std::string_view, int64_t>> ints;
  std::vector<std::pair<std::string_view, std::string_view>> raws;
};

bool ParseFlatMap(const std::string& payload, FlatMap* out) {
  View v{(const uint8_t*)payload.data(), payload.size(), 0};
  uint32_t n;
  if (!mplite::read_map(v, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view k;
    if (!mplite::read_str(v, &k)) return false;
    size_t at = v.off;
    std::string_view sv;
    int64_t iv;
    if (mplite::read_str(v, &sv)) {
      out->strs.push_back({k, sv});
      continue;
    }
    v.off = at;
    if (mplite::read_int(v, &iv)) {
      out->ints.push_back({k, iv});
      continue;
    }
    v.off = at;
    std::string_view raw;
    if (!mplite::read_raw(v, &raw)) return false;
    out->raws.push_back({k, raw});
  }
  return true;
}

const uint8_t kOkTrue[] = {0x81, 0xa2, 'o', 'k', 0xc3};

std::string RegisterActorPayload(const char* actor_id,
                                 const std::string& spec_raw,
                                 int64_t max_restarts, const char* sid,
                                 int64_t rseq, const char* name = nullptr) {
  std::string p;
  uint32_t n = 6 + (name ? 1 : 0);
  mplite::w_map(p, n);
  mplite::w_str(p, "actor_id");
  mplite::w_str(p, actor_id);
  mplite::w_str(p, "spec");
  mplite::w_raw(p, spec_raw);
  mplite::w_str(p, "max_restarts");
  mplite::w_int(p, max_restarts);
  if (name) {
    mplite::w_str(p, "name");
    mplite::w_str(p, name);
  }
  mplite::w_str(p, "_session");
  mplite::w_str(p, sid);
  mplite::w_str(p, "_rseq");
  mplite::w_int(p, rseq);
  mplite::w_str(p, "_acked");
  mplite::w_int(p, rseq - 1);
  return p;
}

// ---- generated validator table fuzz (every method) ----
//
// For each contract method with required fields: a payload carrying all
// of them passes; dropping any single one fails naming exactly that
// field; truncating a valid payload at every byte offset never crashes
// or over-reads (the ASan gate for the generated tables).

void TestValidatorTableFuzz() {
  int with_required = 0;
  for (uint32_t mi = 0; mi < contractgen::kNumMethods; mi++) {
    const contractgen::MethodInfo& m = contractgen::kMethods[mi];
    CHECK(contractgen::FindMethod(m.name) == &m);
    if (m.n_required == 0) {
      // Zero-required validators accept anything parseable — and an
      // empty map.
      std::string p;
      mplite::w_map(p, 0);
      View v{(const uint8_t*)p.data(), p.size(), 0};
      const char* missing = nullptr;
      CHECK(contractgen::ValidateRequired(m, v, &missing));
      continue;
    }
    with_required++;
    // Full payload: every required key present (value: int 1).
    std::string full;
    mplite::w_map(full, m.n_required);
    for (uint32_t r = 0; r < m.n_required; r++) {
      mplite::w_str(full, m.required[r]);
      mplite::w_int(full, 1);
    }
    {
      View v{(const uint8_t*)full.data(), full.size(), 0};
      const char* missing = nullptr;
      CHECK(contractgen::ValidateRequired(m, v, &missing));
    }
    // Drop each required key in turn: must fail naming that key.
    for (uint32_t drop = 0; drop < m.n_required; drop++) {
      std::string p;
      mplite::w_map(p, m.n_required - 1);
      for (uint32_t r = 0; r < m.n_required; r++) {
        if (r == drop) continue;
        mplite::w_str(p, m.required[r]);
        mplite::w_int(p, 1);
      }
      View v{(const uint8_t*)p.data(), p.size(), 0};
      const char* missing = nullptr;
      CHECK(!contractgen::ValidateRequired(m, v, &missing));
      CHECK(missing != nullptr && strcmp(missing, m.required[drop]) == 0);
    }
    // Truncation at every offset: either verdict, never a crash.
    for (size_t cut = 0; cut < full.size(); cut++) {
      View v{(const uint8_t*)full.data(), cut, 0};
      const char* missing = nullptr;
      (void)contractgen::ValidateRequired(m, v, &missing);
    }
  }
  CHECK(with_required >= 30);  // the contract really has validators
  CHECK(contractgen::FindMethod("NoSuchMethod") == nullptr);
}

// ---- plane malformed-frame storm (no pump; counting send) ----

int g_sent = 0;
std::string g_last_sent;
int g_injected = 0;

int CountingSend(void* /*pump*/, int64_t /*conn*/, const void* buf,
                 uint32_t len) {
  g_sent++;
  g_last_sent.assign((const char*)buf, len);
  return 0;
}

void CountingInject(void* /*pump*/, int64_t /*token*/, const void* /*buf*/,
                    uint32_t /*len*/) {
  g_injected++;
}

bool DecodeError(const std::string& body, int64_t* seq, std::string* text) {
  View v{(const uint8_t*)body.data(), body.size(), 0};
  uint32_t alen;
  int64_t msg_type;
  std::string_view method, msg;
  if (!mplite::read_array(v, &alen) || alen != 4) return false;
  if (!mplite::read_int(v, &msg_type) || msg_type != 2) return false;
  if (!mplite::read_int(v, seq)) return false;
  if (!mplite::read_str(v, &method)) return false;
  if (!mplite::read_str(v, &msg)) return false;
  text->assign(msg);
  return true;
}

void TestMalformedFrames() {
  void* svc = gact_create((void*)&CountingSend, (void*)&CountingInject,
                          nullptr, 1);
  g_sent = 0;
  g_injected = 0;

  std::string env;
  mplite::w_array(env, 4);
  mplite::w_int(env, 0);  // MSG_REQUEST
  mplite::w_int(env, 42);
  mplite::w_str(env, "RegisterActor");
  std::string spec;
  mplite::w_map(spec, 1);
  mplite::w_str(spec, "cls");
  mplite::w_str(spec, "Foo");
  std::string payload = RegisterActorPayload("a-fuzz", spec, 0, "sfz", 1);
  std::string frame = env + payload;

  // Envelope truncation: unparseable header, chained/passed (chain is
  // unset here, so return 0), nothing sent.
  for (size_t cut = 0; cut < env.size(); cut++) {
    CHECK(gact_on_frame(svc, 1, frame.data(), (uint32_t)cut) == 0);
  }
  CHECK(g_sent == 0);
  CHECK(gact_proto_errors(svc) == 0);

  // Payload truncation at every offset: owned method, each must answer
  // exactly one Malformed error echoing the request seq.
  int malformed = 0;
  for (size_t cut = env.size(); cut < frame.size(); cut++) {
    CHECK(gact_on_frame(svc, 1, frame.data(), (uint32_t)cut) == 1);
    malformed++;
    CHECK(g_sent == malformed);
    int64_t seq;
    std::string text;
    CHECK(DecodeError(g_last_sent, &seq, &text));
    CHECK(seq == 42);
    CHECK(text.find("malformed payload for RegisterActor") !=
          std::string::npos);
  }
  CHECK(gact_proto_errors(svc) == (uint64_t)malformed);

  // Malformed NOTIFY: no seq to answer — counted, not replied.
  std::string nenv;
  mplite::w_array(nenv, 4);
  mplite::w_int(nenv, 3);  // MSG_NOTIFY
  mplite::w_int(nenv, 0);
  mplite::w_str(nenv, "ActorReady");
  std::string junkmap = "\x81";  // fixmap(1) then nothing
  std::string nframe = nenv + junkmap;
  int sent_before = g_sent;
  CHECK(gact_on_frame(svc, 1, nframe.data(), (uint32_t)nframe.size()) == 1);
  CHECK(g_sent == sent_before);
  CHECK(gact_proto_errors(svc) == (uint64_t)malformed + 1);

  // Deterministic single-byte corruption at every offset: any verdict
  // is fine; crashing or over-reading (ASan) is not.
  for (size_t i = 0; i < frame.size(); i++) {
    for (uint8_t mask : {0xFF, 0x80, 0x01}) {
      std::string m = frame;
      m[i] = (char)(m[i] ^ mask);
      int r = gact_on_frame(svc, 1, m.data(), (uint32_t)m.size());
      CHECK(r == 0 || r == 1);
    }
  }

  // PRNG garbage (fixed seed, CI-stable).
  uint64_t rng = 0x9e3779b97f4a7c15ull;
  auto next = [&rng]() {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    return (uint8_t)(rng >> 33);
  };
  for (int it = 0; it < 512; it++) {
    std::string buf;
    size_t n = next() % 97;
    for (size_t i = 0; i < n; i++) buf.push_back((char)next());
    int r = gact_on_frame(svc, 1, buf.data(), (uint32_t)buf.size());
    CHECK(r == 0 || r == 1);
  }

  // After the storm the plane still routes correctly: a valid
  // RegisterActor with no node registered falls through to Python
  // (transient no-node state), not an error.
  uint64_t errs_before = gact_proto_errors(svc);
  CHECK(gact_on_frame(svc, 1, frame.data(), (uint32_t)frame.size()) == 0);
  CHECK(gact_proto_errors(svc) == errs_before);
  gact_destroy(svc);
}

// ---- the creation ladder through a real pump ----

void TestLadderThroughPump() {
  void* server = fpump_create();
  void* plane = gact_create((void*)&fpump_send, (void*)&fpump_inject,
                            server, /*inject_token=*/7);
  fpump_set_service(server, (void*)&gact_on_frame, (void*)&gact_on_close,
                    plane);
  int port = fpump_listen(server, "127.0.0.1", 0);
  CHECK(port > 0);

  // Fake raylet connects first; its server-side conn id arrives as
  // EV_ACCEPT and becomes the node's conn (gcs.py binds node_conns the
  // same way on RegisterNode).
  void* raylet = fpump_create();
  int64_t rconn = fpump_connect(raylet, "127.0.0.1", port);
  CHECK(rconn > 0);
  int64_t raylet_sconn = -1;
  CHECK(NextEvent(server, kEvAccept, nullptr, &raylet_sconn));
  gact_node_up(plane, "node-A", raylet_sconn);

  void* driver = fpump_create();
  int64_t dconn = fpump_connect(driver, "127.0.0.1", port);
  CHECK(dconn > 0);
  CHECK(NextEvent(server, kEvAccept, nullptr, nullptr));

  // RegisterActor: simple shape, stamped (sid "drv-1", rseq 1).
  std::string spec;
  mplite::w_map(spec, 1);
  mplite::w_str(spec, "cls");
  mplite::w_str(spec, "Foo");
  std::string reg = PackFrame(0, 11, "RegisterActor",
                              RegisterActorPayload("a1", spec, 1, "drv-1", 1));
  CHECK(fpump_send(driver, dconn, reg.data(), (uint32_t)reg.size()) == 0);

  // Driver gets {"ok": true} echoing seq 11.
  std::string body, method, payload;
  int64_t msg_type, seq;
  CHECK(NextEvent(driver, kEvFrame, &body));
  CHECK(DecodeEnvelope(body, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && seq == 11 && method == "RegisterActor");
  CHECK(payload.size() == sizeof(kOkTrue) &&
        memcmp(payload.data(), kOkTrue, sizeof(kOkTrue)) == 0);
  std::string first_reply = body;

  // Raylet gets the outbound CreateActor: native seq range, original
  // spec bytes replayed, stamped with the plane's per-node session.
  CHECK(NextEvent(raylet, kEvFrame, &body));
  CHECK(DecodeEnvelope(body, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 0 && method == "CreateActor");
  CHECK(seq >= kNativeSeqBase);
  FlatMap cm;
  CHECK(ParseFlatMap(payload, &cm));
  CHECK(cm.str("actor_id") == "a1");
  CHECK(cm.raw("spec") == spec);
  std::string create_sid(cm.str("_session"));
  CHECK(!create_sid.empty());
  int64_t create_rseq = 0;
  CHECK(cm.has_int("_rseq", &create_rseq));
  CHECK(create_rseq == 1);

  // Mirror events, in order: "registered" (full raw payload) then
  // "scheduled" {actor_id, node_id}, tagged with our inject token.
  int64_t token = -1;
  std::string ev, evp;
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(token == 7);
  CHECK(DecodeInject(body, &ev, &evp));
  CHECK(ev == "registered");
  FlatMap rm;
  CHECK(ParseFlatMap(evp, &rm));
  CHECK(rm.str("actor_id") == "a1");
  CHECK(rm.str("_session") == "drv-1");  // stamps ride along; Python strips
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp));
  CHECK(ev == "scheduled");
  FlatMap sm;
  CHECK(ParseFlatMap(evp, &sm));
  CHECK(sm.str("actor_id") == "a1" && sm.str("node_id") == "node-A");

  // Replay the SAME RegisterActor (sid, rseq): answered from the reply
  // cache byte-identically; handled does not advance, deduped does.
  CHECK(fpump_send(driver, dconn, reg.data(), (uint32_t)reg.size()) == 0);
  CHECK(NextEvent(driver, kEvFrame, &body));
  CHECK(body == first_reply);
  uint64_t handled, fallthrough, deduped;
  gact_counters(plane, &handled, &fallthrough, &deduped);
  CHECK(handled == 1);
  CHECK(deduped == 1);
  CHECK(gact_session_count(plane) == 1);

  // Node flap BEFORE the raylet answered: drop the raylet conn, bring
  // the node back on a new conn — the pending CreateActor is re-sent
  // with the SAME (sid, rseq), so the raylet-side reply cache makes the
  // create at-most-once across the rebind.
  fpump_destroy(raylet);
  void* raylet2 = fpump_create();
  int64_t rconn2 = fpump_connect(raylet2, "127.0.0.1", port);
  CHECK(rconn2 > 0);
  int64_t raylet2_sconn = -1;
  CHECK(NextEvent(server, kEvAccept, nullptr, &raylet2_sconn));
  gact_node_up(plane, "node-A", raylet2_sconn);
  CHECK(NextEvent(raylet2, kEvFrame, &body));
  int64_t create_seq2;
  CHECK(DecodeEnvelope(body, &msg_type, &create_seq2, &method, &payload));
  CHECK(method == "CreateActor");
  FlatMap cm2;
  CHECK(ParseFlatMap(payload, &cm2));
  CHECK(cm2.str("_session") == create_sid);
  int64_t rs2 = 0;
  CHECK(cm2.has_int("_rseq", &rs2));
  CHECK(rs2 == create_rseq);

  // Raylet accepts; then reports ActorReady (stamped on its own
  // session) — plane answers ok and mirrors "ready" with the restart
  // count (still 0).
  std::string okp;
  mplite::w_map(okp, 1);
  mplite::w_str(okp, "ok");
  mplite::w_bool(okp, true);
  std::string resp = PackFrame(1, create_seq2, "CreateActor", okp);
  CHECK(fpump_send(raylet2, rconn2, resp.data(), (uint32_t)resp.size()) == 0);

  std::string rp;
  mplite::w_map(rp, 5);
  mplite::w_str(rp, "actor_id");
  mplite::w_str(rp, "a1");
  mplite::w_str(rp, "address");
  mplite::w_array(rp, 2);
  mplite::w_str(rp, "h1");
  mplite::w_int(rp, 9001);
  mplite::w_str(rp, "_session");
  mplite::w_str(rp, "ray-1");
  mplite::w_str(rp, "_rseq");
  mplite::w_int(rp, 1);
  mplite::w_str(rp, "_acked");
  mplite::w_int(rp, 0);
  std::string ready = PackFrame(0, 21, "ActorReady", rp);
  CHECK(fpump_send(raylet2, rconn2, ready.data(), (uint32_t)ready.size())
        == 0);
  CHECK(NextEvent(raylet2, kEvFrame, &body));
  CHECK(DecodeEnvelope(body, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && seq == 21 && method == "ActorReady");
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp));
  CHECK(ev == "ready");
  FlatMap rdm;
  CHECK(ParseFlatMap(evp, &rdm));
  CHECK(rdm.str("actor_id") == "a1");
  int64_t restarts = -1;
  CHECK(rdm.has_int("restarts", &restarts));
  CHECK(restarts == 0);
  CHECK(gact_actor_count(plane) == 1);

  // Complex shape (named actor): falls through to the Python queue as
  // a plain EV_FRAME, and the (sid, rseq) routing is PINNED — the
  // replay falls through too instead of executing natively.
  std::string named = PackFrame(
      0, 12, "RegisterActor",
      RegisterActorPayload("a-named", spec, 0, "drv-1", 2, "bob"));
  CHECK(fpump_send(driver, dconn, named.data(), (uint32_t)named.size()) == 0);
  CHECK(NextEvent(server, kEvFrame, &body));
  CHECK(body == named);
  CHECK(fpump_send(driver, dconn, named.data(), (uint32_t)named.size()) == 0);
  CHECK(NextEvent(server, kEvFrame, &body));
  CHECK(body == named);
  gact_counters(plane, &handled, &fallthrough, &deduped);
  CHECK(fallthrough == 2);

  // Restart ladder for a2 (max_restarts=1): draining bounce repicks
  // WITHOUT consuming a restart, a real failure consumes one, the next
  // failure exhausts the budget -> "dead".
  std::string reg2 = PackFrame(0, 13, "RegisterActor",
                               RegisterActorPayload("a2", spec, 1, "drv-1", 3));
  CHECK(fpump_send(driver, dconn, reg2.data(), (uint32_t)reg2.size()) == 0);
  CHECK(NextEvent(driver, kEvFrame, &body));  // ok reply
  // registered + scheduled events
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "registered");
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "scheduled");

  auto bounce = [&](const char* reason, bool ok) {
    CHECK(NextEvent(raylet2, kEvFrame, &body));
    int64_t cseq;
    CHECK(DecodeEnvelope(body, &msg_type, &cseq, &method, &payload));
    CHECK(method == "CreateActor");
    std::string bp;
    mplite::w_map(bp, 2);
    mplite::w_str(bp, "ok");
    mplite::w_bool(bp, ok);
    mplite::w_str(bp, "reason");
    mplite::w_str(bp, reason);
    std::string r = PackFrame(1, cseq, "CreateActor", bp);
    CHECK(fpump_send(raylet2, rconn2, r.data(), (uint32_t)r.size()) == 0);
  };

  bounce("node draining", false);  // drain race: repick, no restart
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "scheduled");

  bounce("worker died", false);  // restart #1
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "restarting");
  FlatMap rstm;
  CHECK(ParseFlatMap(evp, &rstm));
  int64_t n_restarts = -1;
  CHECK(rstm.has_int("restarts", &n_restarts) && n_restarts == 1);
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "scheduled");

  bounce("worker died again", false);  // budget exhausted -> dead
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "dead");
  FlatMap dm;
  CHECK(ParseFlatMap(evp, &dm));
  CHECK(dm.str("actor_id") == "a2");
  CHECK(gact_actor_count(plane) == 1);  // only a1 remains

  // Node death with a pending create and NO surviving node: the actor
  // is orphaned to Python (plane forgets it, Python's scheduler owns
  // the mirror record).
  std::string reg3 = PackFrame(0, 14, "RegisterActor",
                               RegisterActorPayload("a3", spec, 5, "drv-1", 4));
  CHECK(fpump_send(driver, dconn, reg3.data(), (uint32_t)reg3.size()) == 0);
  CHECK(NextEvent(driver, kEvFrame, &body));  // ok reply
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "registered");
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "scheduled");
  CHECK(NextEvent(raylet2, kEvFrame, &body));  // its CreateActor
  gact_node_down(plane, "node-A");
  // restart #1 (budget 5) -> but no node up -> orphaned
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "restarting");
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "orphaned");
  FlatMap om;
  CHECK(ParseFlatMap(evp, &om));
  CHECK(om.str("actor_id") == "a3");

  // With the only node down (ring non-empty but nothing up), a fresh
  // RegisterActor is still acked natively, then immediately orphaned
  // to Python's scheduler — registration is never lost either way.
  std::string reg4 = PackFrame(0, 15, "RegisterActor",
                               RegisterActorPayload("a4", spec, 0, "drv-1", 5));
  CHECK(fpump_send(driver, dconn, reg4.data(), (uint32_t)reg4.size()) == 0);
  CHECK(NextEvent(driver, kEvFrame, &body));  // ok reply
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "registered");
  CHECK(NextEvent(server, kEvInject, &body, &token));
  CHECK(DecodeInject(body, &ev, &evp) && ev == "orphaned");

  // Forget drops the native record: a later ActorReady for it falls
  // through instead of being claimed.
  gact_actor_forget(plane, "a1");
  CHECK(gact_actor_count(plane) == 0);

  CHECK(gact_proto_errors(plane) == 0);
  fpump_destroy(driver);
  fpump_destroy(raylet2);
  fpump_destroy(server);
  gact_destroy(plane);
}

// Chaining: frames the plane does not own are forwarded to the next
// in-pump service (the KV plane in production) rather than to Python.
int g_chained = 0;
std::string g_chain_last;
int ChainFrame(void* /*ctx*/, int64_t /*conn*/, const char* data,
               uint32_t len) {
  g_chained++;
  g_chain_last.assign(data, len);
  return 1;  // "handled" by the chained service
}
int g_chain_closes = 0;
void ChainClose(void* /*ctx*/, int64_t /*conn*/) { g_chain_closes++; }

void TestChaining() {
  void* plane = gact_create((void*)&CountingSend, (void*)&CountingInject,
                            nullptr, 1);
  gact_chain(plane, (void*)&ChainFrame, (void*)&ChainClose, nullptr);
  g_chained = 0;
  g_chain_closes = 0;

  std::string p;
  mplite::w_map(p, 1);
  mplite::w_str(p, "ns");
  mplite::w_str(p, "fn");
  std::string kv = PackFrame(0, 3, "KVKeys", p);
  CHECK(gact_on_frame(plane, 1, kv.data(), (uint32_t)kv.size()) == 1);
  CHECK(g_chained == 1);
  CHECK(g_chain_last == kv);

  // Garbage envelope also rides the chain (the next service may still
  // want its own accounting of it).
  const char junk[] = "\xc1\xc1junk";
  CHECK(gact_on_frame(plane, 1, junk, (uint32_t)sizeof(junk) - 1) == 1);
  CHECK(g_chained == 2);

  gact_on_close(plane, 1);
  CHECK(g_chain_closes == 1);
  gact_destroy(plane);
}

// ---- epoch handshake, rehydration, parking, breaker ----
//
// CountingSend-only (no pump): drive gact_on_frame directly and decode
// what the plane tried to send.

std::string StampedRegister(const char* actor_id, const char* sid,
                            int64_t rseq, int64_t epoch) {
  std::string spec;
  mplite::w_map(spec, 1);
  mplite::w_str(spec, "cls");
  mplite::w_str(spec, "Foo");
  std::string p;
  mplite::w_map(p, epoch != 0 ? 7 : 6);
  mplite::w_str(p, "actor_id");
  mplite::w_str(p, actor_id);
  mplite::w_str(p, "spec");
  mplite::w_raw(p, spec);
  mplite::w_str(p, "max_restarts");
  mplite::w_int(p, 0);
  mplite::w_str(p, "_session");
  mplite::w_str(p, sid);
  mplite::w_str(p, "_rseq");
  mplite::w_int(p, rseq);
  mplite::w_str(p, "_acked");
  mplite::w_int(p, rseq - 1);
  if (epoch != 0) {
    mplite::w_str(p, "_epoch");
    mplite::w_int(p, epoch);
  }
  return PackFrame(0, 31, "RegisterActor", p);
}

void TestEpochRestoreDegraded() {
  void* plane = gact_create((void*)&CountingSend, (void*)&CountingInject,
                            nullptr, 1);
  gact_set_epoch(plane, 42);
  gact_node_up(plane, "node-A", 5);

  // Fresh stamped request (no _epoch): executes; the reply advertises
  // the incarnation epoch after "ok" (rpc._stamp_reply key order).
  g_sent = 0;
  std::string reg = StampedRegister("e1", "drv-e", 1, 0);
  CHECK(gact_on_frame(plane, 9, reg.data(), (uint32_t)reg.size()) == 1);
  CHECK(g_sent >= 1);
  std::string expect;
  mplite::w_map(expect, 2);
  mplite::w_str(expect, "ok");
  mplite::w_bool(expect, true);
  mplite::w_str(expect, "_epoch");
  mplite::w_int(expect, 42);
  // First send is the driver reply (the CreateActor went to conn 5 via
  // the same counting stub afterwards).
  int64_t msg_type, seq;
  std::string method, payload;
  // g_last_sent holds the LAST frame (CreateActor out); re-send the
  // replay to observe the cached driver reply deterministically.
  std::string replay = StampedRegister("e1", "drv-e", 1, 42);
  CHECK(gact_on_frame(plane, 9, replay.data(), (uint32_t)replay.size()) == 1);
  CHECK(DecodeEnvelope(g_last_sent, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 1 && method == "RegisterActor");
  CHECK(payload == expect);
  CHECK(gact_stale_epoch_total(plane) == 0);

  // Replay stamped with a DEAD incarnation's epoch and no cache entry:
  // deterministic rejection, never blind re-execution.
  std::string stale = StampedRegister("e2", "drv-e", 7, 41);
  CHECK(gact_on_frame(plane, 9, stale.data(), (uint32_t)stale.size()) == 1);
  CHECK(gact_stale_epoch_total(plane) == 1);
  std::string etext;
  CHECK(DecodeError(g_last_sent, &seq, &etext));
  CHECK(etext.find("stale session epoch") == 0);
  CHECK(gact_actor_count(plane) == 1);  // e2 was NOT created

  // Breaker: degraded method routes new requests to Python (return 0),
  // counted per-method; re-arm restores native handling.
  gact_set_degraded(plane, "RegisterActor", 1);
  std::string reg3 = StampedRegister("e3", "drv-e", 3, 0);
  CHECK(gact_on_frame(plane, 9, reg3.data(), (uint32_t)reg3.size()) == 0);
  CHECK(gact_degraded_total(plane) == 1);
  uint64_t mh, mr, md;
  gact_method_stats(plane, "RegisterActor", &mh, &mr, &md);
  CHECK(mh == 1 && md == 1);
  gact_set_degraded(plane, "RegisterActor", 0);
  std::string reg4 = StampedRegister("e4", "drv-e", 4, 0);
  CHECK(gact_on_frame(plane, 9, reg4.data(), (uint32_t)reg4.size()) == 1);
  gact_method_stats(plane, "RegisterActor", &mh, &mr, &md);
  CHECK(mh == 2 && md == 1);

  // Fault-aware parking: node SUSPECT -> a new creation PARKS (stays
  // PENDING, nothing sent to the node) instead of forking or orphaning;
  // recovery to ALIVE re-drives it.
  gact_node_state(plane, "node-A", /*SUSPECT=*/1);
  g_sent = 0;
  std::string reg5 = StampedRegister("e5", "drv-e", 5, 0);
  CHECK(gact_on_frame(plane, 9, reg5.data(), (uint32_t)reg5.size()) == 1);
  char state_buf[16];
  CHECK(gact_actor_state(plane, "e5", state_buf, sizeof state_buf) == 1);
  CHECK(strcmp(state_buf, "PENDING") == 0);
  CHECK(g_sent == 1);  // ONLY the driver ack; no CreateActor went out
  gact_node_state(plane, "node-A", /*ALIVE=*/0);
  CHECK(DecodeEnvelope(g_last_sent, &msg_type, &seq, &method, &payload));
  CHECK(msg_type == 0 && method == "CreateActor");
  FlatMap cm;
  CHECK(ParseFlatMap(payload, &cm));
  CHECK(cm.str("actor_id") == "e5");
  gact_destroy(plane);

  // Crash rehydration: a NEW plane (restart) restores the persisted
  // tables; the re-registering node triggers the parked re-drive with
  // the restored spec bytes.
  void* p2 = gact_create((void*)&CountingSend, (void*)&CountingInject,
                         nullptr, 1);
  gact_set_epoch(p2, 43);
  std::string spec;
  mplite::w_map(spec, 1);
  mplite::w_str(spec, "cls");
  mplite::w_str(spec, "Restored");
  gact_restore_node(p2, "node-A", /*SUSPECT=*/1);
  gact_restore_actor(p2, "r1", "PENDING", 2, 5, "", spec.data(),
                     (uint32_t)spec.size(), "", 0);
  gact_restore_actor(p2, "r2", "ALIVE", 0, 1, "node-A", spec.data(),
                     (uint32_t)spec.size(), "", 0);
  CHECK(gact_actor_count(p2) == 2);
  g_sent = 0;
  gact_node_up(p2, "node-A", 6);
  // r1 (PENDING, parked) was re-driven: exactly one CreateActor out.
  CHECK(g_sent == 1);
  CHECK(DecodeEnvelope(g_last_sent, &msg_type, &seq, &method, &payload));
  CHECK(method == "CreateActor");
  FlatMap rm;
  CHECK(ParseFlatMap(payload, &rm));
  CHECK(rm.str("actor_id") == "r1");
  CHECK(rm.raw("spec") == spec);
  // r2 (ALIVE) was restored untouched.
  CHECK(gact_actor_state(p2, "r2", state_buf, sizeof state_buf) == 1);
  CHECK(strcmp(state_buf, "ALIVE") == 0);
  // A pre-restart replay against the restored plane: stale epoch.
  std::string old = StampedRegister("e9", "drv-e", 9, 42);
  CHECK(gact_on_frame(p2, 9, old.data(), (uint32_t)old.size()) == 1);
  CHECK(gact_stale_epoch_total(p2) == 1);
  gact_destroy(p2);
}

}  // namespace

int main() {
  TestValidatorTableFuzz();
  TestMalformedFrames();
  TestChaining();
  TestLadderThroughPump();
  TestEpochRestoreDegraded();
  if (failures == 0) {
    std::printf("gcs_actor_test: all OK\n");
    return 0;
  }
  std::printf("gcs_actor_test: %d FAILURES\n", failures);
  return 1;
}
