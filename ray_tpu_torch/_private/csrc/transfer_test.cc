// Unit tests for the native transfer plane (plain-assert harness, same
// conventions as store_test.cc). Run by `make test` and the asan/tsan
// configs — the sanitizer builds exercise the server's detached
// connection threads against concurrent fetches.

#include <assert.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <stdlib.h>
#include <unistd.h>

#include <string>

extern "C" {
void* store_create_arena(const char* path, uint64_t arena_size,
                         uint32_t table_capacity);
void store_detach(void* handle);
void* store_base(void* handle);
int store_create(void* h, const uint8_t* id, uint64_t size, uint64_t meta,
                 uint64_t* out_off);
int store_seal(void* h, const uint8_t* id);
int store_get(void* h, const uint8_t* id, uint64_t* off, uint64_t* size,
              uint64_t* meta);
int store_release(void* h, const uint8_t* id);
int store_contains(void* h, const uint8_t* id);

void* transfer_server_start(const char* store_path, int* out_port);
void transfer_server_stop(void* h);
int transfer_fetch(const char* store_path, const char* host, int port,
                   const uint8_t* id);
int transfer_fetch_multi(const char* store_path, const char* peers_csv,
                         const uint8_t* id);
}

static void make_id(uint8_t* id, int n) {
  memset(id, 0, 20);
  memcpy(id, &n, sizeof(n));
}

// Scratch files live in the directory given as argv[1], else $TMPDIR,
// else /tmp, and carry this process's pid: runs side by side never share
// one.
static std::string scratch_path(int argc, char** argv, const char* name) {
  const char* dir = argc > 1 ? argv[1] : getenv("TMPDIR");
  if (dir == nullptr || *dir == 0) dir = "/tmp";
  return std::string(dir) + "/" + name + "_" + std::to_string(getpid());
}

static std::string g_src, g_dst;
static const char* kSrc = nullptr;  // set by main
static const char* kDst = nullptr;

static void put_object(void* store, int n, uint64_t size) {
  uint8_t id[20];
  make_id(id, n);
  uint64_t off = 0;
  assert(store_create(store, id, size, 8, &off) == 0);
  uint8_t* base = (uint8_t*)store_base(store);
  for (uint64_t i = 0; i < size; i++) base[off + i] = (uint8_t)(n + i);
  assert(store_seal(store, id) == 0);
}

static void check_object(const char* store_path, void* store, int n,
                         uint64_t size) {
  uint8_t id[20];
  make_id(id, n);
  uint64_t off = 0, got_size = 0, meta = 0;
  assert(store_get(store, id, &off, &got_size, &meta) == 0);
  assert(got_size == size);
  assert(meta == 8);
  uint8_t* base = (uint8_t*)store_base(store);
  for (uint64_t i = 0; i < size; i += 97)
    assert(base[off + i] == (uint8_t)(n + i));
  assert(store_release(store, id) == 0);
  (void)store_path;
}

struct FetchJob {
  const char* dst;
  int port;
  int n;
  int rc;
  const char* host = "127.0.0.1";
};

static void* fetch_thread(void* arg) {
  FetchJob* j = (FetchJob*)arg;
  uint8_t id[20];
  make_id(id, j->n);
  j->rc = transfer_fetch(j->dst, j->host, j->port, id);
  return nullptr;
}

int main(int argc, char** argv) {
  g_src = scratch_path(argc, argv, "tputransfer_test_src");
  g_dst = scratch_path(argc, argv, "tputransfer_test_dst");
  kSrc = g_src.c_str();
  kDst = g_dst.c_str();
  unlink(kSrc);
  unlink(kDst);
  void* src = store_create_arena(kSrc, 160 << 20, 256);
  void* dst_handle = store_create_arena(kDst, 160 << 20, 256);
  assert(src && dst_handle);

  for (int n = 1; n <= 6; n++) put_object(src, n, 1 << 20);

  int port = 0;
  void* server = transfer_server_start(kSrc, &port);
  assert(server && port > 0);

  // Single fetch round-trips bytes exactly.
  uint8_t id[20];
  make_id(id, 1);
  assert(transfer_fetch(kDst, "127.0.0.1", port, id) == 0);
  check_object(kDst, dst_handle, 1, 1 << 20);
  // Idempotent: second fetch is a no-op success.
  assert(transfer_fetch(kDst, "127.0.0.1", port, id) == 0);
  printf("single fetch ok\n");

  // Missing object reports not-found and the connection stays usable.
  make_id(id, 99);
  assert(transfer_fetch(kDst, "127.0.0.1", port, id) == -2);
  make_id(id, 2);
  assert(transfer_fetch(kDst, "127.0.0.1", port, id) == 0);
  printf("not-found ok\n");

  // Concurrent fetches of distinct objects. The fetch side caches ONE
  // connection per host:port key, so alternating loopback addresses
  // (Linux routes all of 127.0.0.0/8 to lo; no /etc/hosts dependency)
  // forces two genuinely parallel server-side connection threads — the
  // conn_fds/live_conns bookkeeping the sanitizer builds must watch.
  pthread_t threads[4];
  FetchJob jobs[4];
  for (int i = 0; i < 4; i++) {
    jobs[i] = {kDst, port, 3 + i, -100};
    jobs[i].host = (i % 2) ? "127.0.0.2" : "127.0.0.1";
    pthread_create(&threads[i], nullptr, fetch_thread, &jobs[i]);
  }
  for (int i = 0; i < 4; i++) pthread_join(threads[i], nullptr);
  for (int i = 0; i < 4; i++) assert(jobs[i].rc == 0);
  for (int n = 3; n <= 6; n++) check_object(kDst, dst_handle, n, 1 << 20);
  printf("concurrent fetch ok\n");

  // Large object: multi-chunk, parallel-striped path (> 32 MiB
  // threshold) round-trips byte-exact through several connections.
  put_object(src, 40, 72u << 20);
  make_id(id, 40);
  assert(transfer_fetch(kDst, "127.0.0.1", port, id) == 0);
  check_object(kDst, dst_handle, 40, 72u << 20);
  printf("large striped fetch ok\n");

  // Multi-peer fetch: two servers over the SAME source store; stripes
  // split across both peers.
  int port2 = 0;
  void* server2 = transfer_server_start(kSrc, &port2);
  assert(server2 && port2 > 0);
  put_object(src, 41, 48u << 20);
  make_id(id, 41);
  char peers[128];
  snprintf(peers, sizeof(peers), "127.0.0.1:%d,127.0.0.1:%d", port, port2);
  assert(transfer_fetch_multi(kDst, peers, id) == 0);
  check_object(kDst, dst_handle, 41, 48u << 20);
  // First peer listed dead: falls through to the live one.
  put_object(src, 42, 1 << 20);
  make_id(id, 42);
  snprintf(peers, sizeof(peers), "127.0.0.1:1,127.0.0.1:%d", port2);
  assert(transfer_fetch_multi(kDst, peers, id) == 0);
  check_object(kDst, dst_handle, 42, 1 << 20);
  transfer_server_stop(server2);
  printf("multi-peer fetch ok\n");

  transfer_server_stop(server);

  // Server gone: fetch of a NEW object fails with a connection error.
  make_id(id, 77);
  int rc = transfer_fetch(kDst, "127.0.0.1", port, id);
  assert(rc != 0);
  printf("post-stop ok\n");

  store_detach(src);
  store_detach(dst_handle);
  unlink(kSrc);
  unlink(kDst);
  printf("transfer_test: ALL OK\n");
  return 0;
}
