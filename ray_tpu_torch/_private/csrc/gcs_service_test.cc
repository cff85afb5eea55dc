// gcs_service_test.cc — native in-pump GCS service tests.
//
// Drives gcs_service.cc through a REAL fastpath pump pair (server pump
// with the service installed, client pump sending frames over loopback
// TCP), so the test covers the full native path: epoll read -> frame
// parse -> in-loop handler -> table mutation -> WAL append -> response
// pack -> writev.  Also checks the codec against hand-computed msgpack
// bytes and that unknown methods still reach the Python-facing queue.

#include <stdlib.h>
#include <time.h>

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

#include "msgpack_lite.h"

extern "C" {
// fastpath.cc
void* fpump_create();
void fpump_destroy(void* p);
int fpump_listen(void* p, const char* host, int port);
int64_t fpump_connect(void* p, const char* host, int port);
int fpump_send(void* p, int64_t conn_id, const void* buf, uint32_t len);
void fpump_close_conn(void* p, int64_t conn_id);
int fpump_next(void* p, int64_t* conn_id, int* kind, void* out,
               uint32_t* len, int timeout_ms);
void fpump_set_service(void* p, void* frame_fn, void* close_fn, void* ctx);
// gcs_store.cc
void* gstore_create(const char* path_prefix);
void gstore_destroy(void* h);
int gstore_get(void* h, const char* ns, const char* key, char* out,
               int out_len);
int gstore_put(void* h, const char* ns, const char* key, const char* val,
               int val_len);
int gstore_del(void* h, const char* ns, const char* key);
// gcs_service.cc
void* gsvc_create(void* send_fn, void* pump, void* gput_fn, void* gdel_fn,
                  void* store);
void gsvc_destroy(void* h);
int gsvc_on_frame(void* h, int64_t conn_id, const char* data, uint32_t len);
void gsvc_on_close(void* h, int64_t conn_id);
void gsvc_kv_load(void* h, const char* ns, int ns_len, const void* key_raw,
                  int key_len, const void* val_raw, int val_len);
int gsvc_fanout(void* h, const char* channel, int ch_len, const void* frame,
                uint32_t len);
int gsvc_sub_count(void* h, const char* channel, int ch_len);
void gsvc_kv_stats(void* h, int64_t* n_ns, int64_t* n_rows);
void gsvc_counters(void* h, uint64_t* handled, uint64_t* wal_appends,
                   uint64_t* wal_failures);
uint64_t gsvc_proto_errors(void* h);
}

namespace {

using mplite::View;

int failures = 0;

#define CHECK(cond)                                              \
  do {                                                           \
    if (!(cond)) {                                               \
      std::printf("FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      failures++;                                                \
    }                                                            \
  } while (0)

std::string PackRequest(int64_t seq, std::string_view method,
                        const std::string& payload) {
  std::string f;
  mplite::w_array(f, 4);
  mplite::w_int(f, 0);  // MSG_REQUEST
  mplite::w_int(f, seq);
  mplite::w_str(f, method);
  mplite::w_raw(f, payload);
  return f;
}

// Wait for one frame on the pump; returns its body.
bool NextFrame(void* pump, std::string* body, int64_t* from = nullptr,
               int timeout_ms = 3000) {
  std::vector<char> buf(1 << 20);
  for (;;) {
    int64_t cid;
    int kind;
    uint32_t len = (uint32_t)buf.size();
    int r = fpump_next(pump, &cid, &kind, buf.data(), &len, timeout_ms);
    if (r != 1) return false;
    if (kind == 1 /*EV_FRAME*/) {
      body->assign(buf.data(), len);
      if (from) *from = cid;
      return true;
    }
    // skip accepts/closes
  }
}

// Decode a response envelope; returns the raw result slice.
bool DecodeResponse(const std::string& body, int64_t* seq,
                    std::string* result) {
  mplite::View v{(const uint8_t*)body.data(), body.size(), 0};
  uint32_t alen;
  int64_t msg_type;
  std::string_view method, raw;
  if (!mplite::read_array(v, &alen) || alen != 4) return false;
  if (!mplite::read_int(v, &msg_type) || msg_type != 1) return false;
  if (!mplite::read_int(v, seq)) return false;
  if (!mplite::read_str(v, &method)) return false;
  if (!mplite::read_raw(v, &raw)) return false;
  result->assign(raw);
  return true;
}


void TestCodecBytes() {
  // Byte-compat with msgpack-python packb for the forms the row-key
  // contract depends on.
  std::string s;
  mplite::w_array(s, 2);
  mplite::w_str(s, "fn");
  mplite::w_bin(s, std::string_view("abc", 3));
  const uint8_t expect[] = {0x92, 0xa2, 'f', 'n', 0xc4, 0x03, 'a', 'b', 'c'};
  CHECK(s.size() == sizeof(expect));
  CHECK(memcmp(s.data(), expect, sizeof(expect)) == 0);

  std::string i;
  mplite::w_int(i, 127);
  mplite::w_int(i, 128);
  mplite::w_int(i, 65536);
  mplite::w_int(i, -1);
  mplite::w_int(i, -33);
  const uint8_t iexpect[] = {0x7f, 0xcc, 0x80, 0xce, 0x00, 0x01,
                             0x00, 0x00, 0xff, 0xd0, 0xdf};
  CHECK(i.size() == sizeof(iexpect));
  CHECK(memcmp(i.data(), iexpect, sizeof(iexpect)) == 0);

  // Decoder roundtrip incl. skip over nested containers.
  View v{(const uint8_t*)s.data(), s.size(), 0};
  uint32_t alen;
  CHECK(mplite::read_array(v, &alen) && alen == 2);
  std::string_view sv;
  CHECK(mplite::read_str(v, &sv) && sv == "fn");
  CHECK(mplite::read_strbin(v, &sv) && sv == "abc");
  CHECK(v.off == v.n);
}

void TestKvThroughPump(const char* store_prefix) {
  void* store = gstore_create(store_prefix);
  void* server = fpump_create();
  void* svc = gsvc_create((void*)&fpump_send, server, (void*)&gstore_put,
                          (void*)&gstore_del, store);
  fpump_set_service(server, (void*)&gsvc_on_frame, (void*)&gsvc_on_close,
                    svc);
  int port = fpump_listen(server, "127.0.0.1", 0);
  CHECK(port > 0);

  void* client = fpump_create();
  int64_t conn = fpump_connect(client, "127.0.0.1", port);
  CHECK(conn > 0);

  // KVPut {"ns": "fn", "key": b"k1", "value": b"v1"}
  std::string payload;
  mplite::w_map(payload, 3);
  mplite::w_str(payload, "ns");
  mplite::w_str(payload, "fn");
  mplite::w_str(payload, "key");
  mplite::w_bin(payload, "k1");
  mplite::w_str(payload, "value");
  mplite::w_bin(payload, "v1");
  std::string req = PackRequest(7, "KVPut", payload);
  CHECK(fpump_send(client, conn, req.data(), (uint32_t)req.size()) == 0);

  std::string body, result;
  int64_t seq;
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  CHECK(seq == 7);
  // {"added": true}
  const uint8_t added_true[] = {0x81, 0xa5, 'a', 'd', 'd', 'e', 'd', 0xc3};
  CHECK(result.size() == sizeof(added_true) &&
        memcmp(result.data(), added_true, sizeof(added_true)) == 0);

  // overwrite=False on the same key -> {"added": false}
  std::string p2;
  mplite::w_map(p2, 4);
  mplite::w_str(p2, "ns");
  mplite::w_str(p2, "fn");
  mplite::w_str(p2, "key");
  mplite::w_bin(p2, "k1");
  mplite::w_str(p2, "value");
  mplite::w_bin(p2, "zz");
  mplite::w_str(p2, "overwrite");
  mplite::w_bool(p2, false);
  req = PackRequest(8, "KVPut", p2);
  fpump_send(client, conn, req.data(), (uint32_t)req.size());
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  CHECK(result.size() >= 1 && (uint8_t)result.back() == 0xc2);  // false

  // KVGet returns the original value slice.
  std::string p3;
  mplite::w_map(p3, 2);
  mplite::w_str(p3, "ns");
  mplite::w_str(p3, "fn");
  mplite::w_str(p3, "key");
  mplite::w_bin(p3, "k1");
  req = PackRequest(9, "KVGet", p3);
  fpump_send(client, conn, req.data(), (uint32_t)req.size());
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  // {"value": b"v1"}
  const uint8_t val_v1[] = {0x81, 0xa5, 'v', 'a', 'l', 'u', 'e',
                            0xc4, 0x02, 'v', '1'};
  CHECK(result.size() == sizeof(val_v1) &&
        memcmp(result.data(), val_v1, sizeof(val_v1)) == 0);

  // KVKeys with prefix "k" finds it; with prefix "z" does not.
  std::string p4;
  mplite::w_map(p4, 2);
  mplite::w_str(p4, "ns");
  mplite::w_str(p4, "fn");
  mplite::w_str(p4, "prefix");
  mplite::w_bin(p4, "k");
  req = PackRequest(10, "KVKeys", p4);
  fpump_send(client, conn, req.data(), (uint32_t)req.size());
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  // {"keys": [b"k1"]}
  const uint8_t keys_k1[] = {0x81, 0xa4, 'k', 'e', 'y', 's',
                             0x91, 0xc4, 0x02, 'k', '1'};
  CHECK(result.size() == sizeof(keys_k1) &&
        memcmp(result.data(), keys_k1, sizeof(keys_k1)) == 0);

  // Unknown method passes through to the server's Python-facing queue.
  req = PackRequest(11, "RegisterActor", payload);
  fpump_send(client, conn, req.data(), (uint32_t)req.size());
  std::string passed;
  CHECK(NextFrame(server, &passed));
  CHECK(passed == req);

  // WAL write-through: row must be on disk NOW (pre-reply contract),
  // under the exact hex key the Python fallback would use:
  // hex(msgpack(["fn", b"k1"])) -- 92 a2 66 6e c4 02 6b 31.
  const char* row_key = "92a2666ec4026b31";
  char out[16];
  int n = gstore_get(store, "kv", row_key, out, sizeof(out));
  CHECK(n == 4);  // msgpack(b"v1") = c4 02 76 31
  CHECK(memcmp(out, "\xc4\x02v1", 4) == 0);

  // KVDel removes the row from memory and disk.
  req = PackRequest(12, "KVDel", p3);
  fpump_send(client, conn, req.data(), (uint32_t)req.size());
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  CHECK(result.size() >= 1 && (uint8_t)result.back() == 0xc3);  // deleted
  CHECK(gstore_get(store, "kv", row_key, out, sizeof(out)) == -1);

  uint64_t handled, appends, wal_failures;
  gsvc_counters(svc, &handled, &appends, &wal_failures);
  CHECK(handled == 5);       // put, put(no-overwrite), get, keys, del
  CHECK(appends == 2);       // put + del (no-overwrite put skips WAL)
  CHECK(wal_failures == 0);

  fpump_destroy(client);
  fpump_destroy(server);
  gsvc_destroy(svc);
  gstore_destroy(store);
}

void TestPubSubThroughPump() {
  void* server = fpump_create();
  void* svc = gsvc_create((void*)&fpump_send, server, nullptr, nullptr,
                          nullptr);
  fpump_set_service(server, (void*)&gsvc_on_frame, (void*)&gsvc_on_close,
                    svc);
  int port = fpump_listen(server, "127.0.0.1", 0);

  void* sub1 = fpump_create();
  void* sub2 = fpump_create();
  int64_t c1 = fpump_connect(sub1, "127.0.0.1", port);
  int64_t c2 = fpump_connect(sub2, "127.0.0.1", port);

  std::string subp;
  mplite::w_map(subp, 1);
  mplite::w_str(subp, "channels");
  mplite::w_array(subp, 1);
  mplite::w_str(subp, "NODE");
  std::string req = PackRequest(1, "Subscribe", subp);
  fpump_send(sub1, c1, req.data(), (uint32_t)req.size());
  fpump_send(sub2, c2, req.data(), (uint32_t)req.size());
  std::string body;
  CHECK(NextFrame(sub1, &body));
  CHECK(NextFrame(sub2, &body));
  CHECK(gsvc_sub_count(svc, "NODE", 4) == 2);

  // Publish from sub1: both subscribers receive the notify.
  std::string pubp;
  mplite::w_map(pubp, 2);
  mplite::w_str(pubp, "channel");
  mplite::w_str(pubp, "NODE");
  mplite::w_str(pubp, "message");
  mplite::w_map(pubp, 1);
  mplite::w_str(pubp, "event");
  mplite::w_str(pubp, "alive");
  req = PackRequest(2, "Publish", pubp);
  fpump_send(sub1, c1, req.data(), (uint32_t)req.size());

  // sub1 gets notify + response (order not guaranteed between conns but
  // FIFO per conn: notify was queued before the response).
  std::string notify1, resp1, notify2;
  CHECK(NextFrame(sub1, &notify1));
  CHECK(NextFrame(sub1, &resp1));
  CHECK(NextFrame(sub2, &notify2));
  CHECK(notify1 == notify2);
  View v{(const uint8_t*)notify1.data(), notify1.size(), 0};
  uint32_t alen;
  int64_t mt;
  std::string_view method;
  CHECK(mplite::read_array(v, &alen) && alen == 4);
  CHECK(mplite::read_int(v, &mt) && mt == 3);  // MSG_NOTIFY
  int64_t zero;
  CHECK(mplite::read_int(v, &zero) && zero == 0);
  CHECK(mplite::read_str(v, &method) && method == "Publish");

  // Python-side internal fanout path.
  std::string frame = notify1;
  CHECK(gsvc_fanout(svc, "NODE", 4, frame.data(), (uint32_t)frame.size())
        == 2);
  CHECK(NextFrame(sub1, &body));
  CHECK(body == frame);
  CHECK(NextFrame(sub2, &body));
  CHECK(body == frame);

  // Closing a subscriber cleans its registration.
  fpump_destroy(sub2);
  for (int i = 0; i < 100 && gsvc_sub_count(svc, "NODE", 4) == 2; i++) {
    // wait for the server loop to observe the close
    struct timespec ts {0, 10 * 1000 * 1000};
    nanosleep(&ts, nullptr);
  }
  CHECK(gsvc_sub_count(svc, "NODE", 4) == 1);

  fpump_destroy(sub1);
  fpump_destroy(server);
  gsvc_destroy(svc);
}

// ---- malformed / corrupt frame robustness ----
//
// The wire contract under garbage input: an unparseable ENVELOPE is
// passed through to Python (return 0, no reply — Python owns the
// can't-even-read-the-header error path); an owned method whose
// PAYLOAD fails to parse must be answered with a Malformed error frame
// (return 1) and never crash or mutate state.  Runs the decoder over
// every truncation point, deterministic single-byte corruptions, and
// PRNG garbage — under ASan/UBSan (make test-asan) this is the fuzz
// gate for msgpack_lite.h's has()/skip() truncation guards.

int g_sent_frames = 0;
std::string g_last_sent;

int CountingSend(void* /*pump*/, int64_t /*conn_id*/, const void* buf,
                 uint32_t len) {
  g_sent_frames++;
  g_last_sent.assign((const char*)buf, len);
  return 0;
}

// Decode an error envelope; returns the error text.
bool DecodeError(const std::string& body, int64_t* seq, std::string* text) {
  mplite::View v{(const uint8_t*)body.data(), body.size(), 0};
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
  void* svc = gsvc_create((void*)&CountingSend, nullptr, nullptr, nullptr,
                          nullptr);
  g_sent_frames = 0;

  // Envelope and payload built separately so truncation points can be
  // classified: inside the envelope -> pass-through, inside the
  // payload of an owned method -> Malformed reply.
  std::string env;
  mplite::w_array(env, 4);
  mplite::w_int(env, 0);  // MSG_REQUEST
  mplite::w_int(env, 99);
  mplite::w_str(env, "KVPut");
  std::string payload;
  mplite::w_map(payload, 3);
  mplite::w_str(payload, "ns");
  mplite::w_str(payload, "fn");
  mplite::w_str(payload, "key");
  mplite::w_bin(payload, "k1");
  mplite::w_str(payload, "value");
  mplite::w_bin(payload, "v1");
  std::string frame = env + payload;

  // 1) Truncation at every offset inside the envelope: unparseable
  // header, pass to Python, nothing sent.
  for (size_t cut = 0; cut < env.size(); cut++) {
    CHECK(gsvc_on_frame(svc, 1, frame.data(), (uint32_t)cut) == 0);
  }
  CHECK(g_sent_frames == 0);
  CHECK(gsvc_proto_errors(svc) == 0);

  // 2) Truncation at every offset inside the payload: envelope names an
  // owned method, so each must answer exactly one Malformed error frame
  // echoing the request seq — never a KeyError-style crash.
  int malformed = 0;
  for (size_t cut = env.size(); cut < frame.size(); cut++) {
    CHECK(gsvc_on_frame(svc, 1, frame.data(), (uint32_t)cut) == 1);
    malformed++;
    CHECK(g_sent_frames == malformed);
    int64_t seq;
    std::string text;
    CHECK(DecodeError(g_last_sent, &seq, &text));
    CHECK(seq == 99);
    CHECK(text.find("malformed payload for KVPut") != std::string::npos);
  }
  CHECK(gsvc_proto_errors(svc) == (uint64_t)malformed);

  // 3) A malformed NOTIFY has no seq to answer: counted, not replied.
  std::string nenv;
  mplite::w_array(nenv, 4);
  mplite::w_int(nenv, 3);  // MSG_NOTIFY
  mplite::w_int(nenv, 0);
  mplite::w_str(nenv, "Publish");
  int sent_before = g_sent_frames;
  CHECK(gsvc_on_frame(svc, 1, nenv.data(), (uint32_t)nenv.size()) == 1);
  CHECK(g_sent_frames == sent_before);
  CHECK(gsvc_proto_errors(svc) == (uint64_t)malformed + 1);

  // 4) Deterministic single-byte corruption at every offset: any
  // outcome (pass-through, Malformed, or an accidentally-valid frame)
  // is acceptable; crashing or over-reading (ASan) is not.
  for (size_t i = 0; i < frame.size(); i++) {
    for (uint8_t mask : {0xFF, 0x80, 0x01}) {
      std::string m = frame;
      m[i] = (char)(m[i] ^ mask);
      int r = gsvc_on_frame(svc, 1, m.data(), (uint32_t)m.size());
      CHECK(r == 0 || r == 1);
    }
  }

  // 5) PRNG garbage (fixed seed: reproducible, CI-stable). Short
  // buffers exercise the header guards, longer ones the nested
  // skip()/depth paths when bytes happen to form container headers.
  uint64_t rng = 0x9e3779b97f4a7c15ull;
  auto next = [&rng]() {
    rng = rng * 6364136223846793005ull + 1442695040888963407ull;
    return (uint8_t)(rng >> 33);
  };
  for (int it = 0; it < 512; it++) {
    std::string buf;
    size_t n = next() % 97;
    for (size_t i = 0; i < n; i++) buf.push_back((char)next());
    int r = gsvc_on_frame(svc, 1, buf.data(), (uint32_t)buf.size());
    CHECK(r == 0 || r == 1);
  }

  // 6) The service still works after the storm: a valid KVPut is
  // handled and answered with a response frame.
  sent_before = g_sent_frames;
  CHECK(gsvc_on_frame(svc, 1, frame.data(), (uint32_t)frame.size()) == 1);
  CHECK(g_sent_frames == sent_before + 1);
  int64_t seq;
  std::string result;
  CHECK(DecodeResponse(g_last_sent, &seq, &result));
  CHECK(seq == 99);
  gsvc_destroy(svc);
}

// Same storm over real loopback TCP: corrupt frames must not wedge the
// pump loop thread or poison the connection for later valid requests.
void TestMalformedFramesThroughPump() {
  void* server = fpump_create();
  void* svc = gsvc_create((void*)&fpump_send, server, nullptr, nullptr,
                          nullptr);
  fpump_set_service(server, (void*)&gsvc_on_frame, (void*)&gsvc_on_close,
                    svc);
  int port = fpump_listen(server, "127.0.0.1", 0);
  CHECK(port > 0);
  void* client = fpump_create();
  int64_t conn = fpump_connect(client, "127.0.0.1", port);
  CHECK(conn > 0);

  std::string payload;
  mplite::w_map(payload, 2);
  mplite::w_str(payload, "ns");
  mplite::w_str(payload, "fn");
  mplite::w_str(payload, "key");
  mplite::w_bin(payload, "k1");
  std::string req = PackRequest(5, "KVGet", payload);

  // Truncated bodies of an owned-method request (well-framed on the
  // wire — the 4-byte length prefix is the pump's, the rot is inside).
  // Each must come back as an error frame, in order.
  int expect_errors = 0;
  for (size_t cut = req.size() - 1; cut > req.size() - (size_t)4; cut--) {
    CHECK(fpump_send(client, conn, req.data(), (uint32_t)cut) == 0);
    expect_errors++;
  }
  for (int i = 0; i < expect_errors; i++) {
    std::string body, text;
    int64_t seq;
    CHECK(NextFrame(client, &body));
    CHECK(DecodeError(body, &seq, &text));
    CHECK(seq == 5);
  }
  // Pure garbage body: not even an envelope — passed to the Python
  // queue, no reply.
  const char junk[] = "\xc1\xc1\xc1\xc1junkjunk";
  CHECK(fpump_send(client, conn, junk, (uint32_t)sizeof(junk) - 1) == 0);
  std::string passed;
  CHECK(NextFrame(server, &passed));
  CHECK(passed == std::string(junk, sizeof(junk) - 1));

  // The same connection still serves a valid request afterwards.
  CHECK(fpump_send(client, conn, req.data(), (uint32_t)req.size()) == 0);
  std::string body, result;
  int64_t seq;
  CHECK(NextFrame(client, &body));
  CHECK(DecodeResponse(body, &seq, &result));
  CHECK(seq == 5);
  // {"value": nil} — the table is empty; what matters is a well-formed
  // response, not an error or a hang.
  CHECK(result.size() >= 1);

  fpump_destroy(client);
  fpump_destroy(server);
  gsvc_destroy(svc);
}

void TestRestoreLoad() {
  void* svc = gsvc_create((void*)&fpump_send, nullptr, nullptr, nullptr,
                          nullptr);
  std::string key_raw, val_raw;
  mplite::w_bin(key_raw, "k9");
  mplite::w_bin(val_raw, "v9");
  gsvc_kv_load(svc, "ns1", 3, key_raw.data(), (int)key_raw.size(),
               val_raw.data(), (int)val_raw.size());
  int64_t n_ns, n_rows;
  gsvc_kv_stats(svc, &n_ns, &n_rows);
  CHECK(n_ns == 1 && n_rows == 1);
  gsvc_destroy(svc);
}

}  // namespace

int main(int argc, char** argv) {
  TestCodecBytes();
  // The state's directory: a fresh one under argv[1], else $TMPDIR,
  // else /tmp.
  const char* dir = argc > 1 ? argv[1] : getenv("TMPDIR");
  if (dir == nullptr || *dir == 0) dir = "/tmp";
  std::string tmpl = std::string(dir) + "/gsvc_test_XXXXXX";
  CHECK(mkdtemp(tmpl.data()) != nullptr);
  std::string prefix = tmpl + "/gcs_state";
  TestKvThroughPump(prefix.c_str());
  TestPubSubThroughPump();
  TestMalformedFrames();
  TestMalformedFramesThroughPump();
  TestRestoreLoad();
  if (failures == 0) {
    std::printf("gcs_service_test: all OK\n");
    return 0;
  }
  std::printf("gcs_service_test: %d FAILURES\n", failures);
  return 1;
}
