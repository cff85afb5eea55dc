// Unit tests for the fastpath frame pump (fastpath.cc).
// Covers: listen/connect/accept, framing round-trip (incl. fragmented
// and coalesced TCP delivery), inject, close propagation, batch drain,
// backlog send/recv under load, destroy-while-blocked safety.
#include <assert.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <string>
#include <thread>
#include <vector>

extern "C" {
struct FPump;
FPump* fpump_create();
void fpump_destroy(FPump*);
int fpump_listen(FPump*, const char* host, int port);
int64_t fpump_connect(FPump*, const char* host, int port);
void fpump_close_conn(FPump*, int64_t);
int fpump_send(FPump*, int64_t, const void*, uint32_t);
void fpump_inject(FPump*, int64_t, const void*, uint32_t);
int fpump_recv_eventfd(FPump*);
void fpump_arm_eventfd(FPump*, int);
int fpump_next(FPump*, int64_t*, int*, void*, uint32_t*, int);
int fpump_drain(FPump*, void*, uint32_t, int, uint32_t*);
}

namespace {

struct Ev {
  int64_t conn_id;
  int kind;
  std::string data;
};

bool next_ev(FPump* p, Ev* ev, int timeout_ms = 2000) {
  static thread_local std::vector<char> buf(1 << 20);
  int64_t cid;
  int kind;
  uint32_t len = (uint32_t)buf.size();
  int r = fpump_next(p, &cid, &kind, buf.data(), &len, timeout_ms);
  if (r == -2) {
    buf.resize(len);
    len = (uint32_t)buf.size();
    r = fpump_next(p, &cid, &kind, buf.data(), &len, timeout_ms);
  }
  if (r != 1) return false;
  ev->conn_id = cid;
  ev->kind = kind;
  ev->data.assign(buf.data(), len);
  return true;
}

void test_roundtrip() {
  FPump* a = fpump_create();
  FPump* b = fpump_create();
  int port = fpump_listen(a, "127.0.0.1", 0);
  assert(port > 0);
  int64_t cb = fpump_connect(b, "127.0.0.1", port);
  assert(cb > 0);
  assert(fpump_send(b, cb, "hello", 5) == 0);
  Ev ev;
  assert(next_ev(a, &ev) && ev.kind == 2);  // accept
  int64_t ca = ev.conn_id;
  assert(next_ev(a, &ev) && ev.kind == 1 && ev.data == "hello");
  // big frame (forces multiple reads server-side)
  std::string big(3 << 20, 'z');
  assert(fpump_send(a, ca, big.data(), (uint32_t)big.size()) == 0);
  assert(next_ev(b, &ev) && ev.kind == 1 && ev.data.size() == big.size() &&
         ev.data == big);
  // inject
  fpump_inject(a, 42, "tok", 3);
  assert(next_ev(a, &ev) && ev.kind == 4 && ev.conn_id == 42 &&
         ev.data == "tok");
  // close propagation
  fpump_close_conn(b, cb);
  assert(next_ev(a, &ev) && ev.kind == 3 && ev.conn_id == ca);
  fpump_destroy(a);
  fpump_destroy(b);
  printf("roundtrip OK\n");
}

void test_many_frames_and_drain() {
  FPump* a = fpump_create();
  FPump* b = fpump_create();
  int port = fpump_listen(a, "127.0.0.1", 0);
  int64_t cb = fpump_connect(b, "127.0.0.1", port);
  const int N = 20000;
  std::thread sender([&] {
    char msg[64];
    for (int i = 0; i < N; i++) {
      int n = snprintf(msg, sizeof(msg), "frame-%d", i);
      while (fpump_send(b, cb, msg, (uint32_t)n) != 0) {}
    }
  });
  int got = 0, accepts = 0;
  std::vector<char> dbuf(1 << 18);
  int last_seen = -1;
  while (got < N) {
    uint32_t needed = 0;
    int n = fpump_drain(a, dbuf.data(), (uint32_t)dbuf.size(), 512, &needed);
    if (n == 0) {
      Ev ev;
      if (!next_ev(a, &ev, 2000)) break;
      if (ev.kind == 2) { accepts++; continue; }
      assert(ev.kind == 1);
      int idx = atoi(ev.data.substr(6).c_str());
      assert(idx == last_seen + 1);
      last_seen = idx;
      got++;
      continue;
    }
    uint32_t off = 0;
    for (int i = 0; i < n; i++) {
      int64_t cid;
      int32_t kind;
      uint32_t len;
      memcpy(&cid, dbuf.data() + off, 8);
      memcpy(&kind, dbuf.data() + off + 8, 4);
      memcpy(&len, dbuf.data() + off + 12, 4);
      if (kind == 2) { accepts++; off += 16 + len; continue; }
      assert(kind == 1);
      // FIFO ordering within the socket
      int idx = atoi(std::string(dbuf.data() + off + 16 + 6, len - 6).c_str());
      if (idx != last_seen + 1) {
        fprintf(stderr, "MISMATCH got=%d idx=%d last=%d len=%u\n", got, idx,
                last_seen, len);
        assert(false);
      }
      last_seen = idx;
      got++;
      off += 16 + len;
    }
  }
  assert(got == N);
  sender.join();
  fpump_destroy(a);
  fpump_destroy(b);
  printf("many_frames/drain OK (%d frames)\n", N);
}

void test_destroy_wakes_blocked_consumer() {
  FPump* p = fpump_create();
  std::thread consumer([&] {
    Ev ev;
    bool got = next_ev(p, &ev, 10000);  // blocks until destroy wakes it
    assert(!got);
  });
  std::this_thread::sleep_for(std::chrono::milliseconds(100));
  fpump_destroy(p);
  consumer.join();
  printf("destroy-wakes-blocked OK\n");
}

void test_send_to_dead_conn() {
  FPump* a = fpump_create();
  FPump* b = fpump_create();
  int port = fpump_listen(a, "127.0.0.1", 0);
  int64_t cb = fpump_connect(b, "127.0.0.1", port);
  fpump_close_conn(b, cb);
  Ev ev;
  // wait for close to be observed locally
  bool closed = false;
  for (int i = 0; i < 2 && next_ev(b, &ev, 2000); i++)
    if (ev.kind == 3) closed = true;
  assert(closed);
  assert(fpump_send(b, cb, "x", 1) == -1);
  fpump_destroy(a);
  fpump_destroy(b);
  printf("send-to-dead-conn OK\n");
}

}  // namespace

int main() {
  test_roundtrip();
  test_many_frames_and_drain();
  test_destroy_wakes_blocked_consumer();
  test_send_to_dead_conn();
  printf("fastpath_test: ALL OK\n");
  return 0;
}
