// Unit tests for the shared-memory object store (plain-assert harness —
// the reference uses gtest, src/ray/object_manager/plasma/test/; same
// coverage intent, no gtest dependency in this image). Built and run by
// `make test` / `make test-asan` / `make test-tsan` (sanitizer builds are
// the race-detection story, reference: .bazelrc:103-110 --config=tsan).

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
void* store_attach(const char* path);
void store_detach(void* handle);
void* store_base(void* handle);
int store_create(void* h, const uint8_t* id, uint64_t size, uint64_t meta,
                 uint64_t* out_off);
int store_seal(void* h, const uint8_t* id);
int store_get(void* h, const uint8_t* id, uint64_t* off, uint64_t* size,
              uint64_t* meta);
int store_release(void* h, const uint8_t* id);
int store_contains(void* h, const uint8_t* id);
int store_delete(void* h, const uint8_t* id, int force);
int store_abort(void* h, const uint8_t* id);
void store_set_auto_evict(void* h, int enabled);
int store_lru_candidates(void* h, uint64_t needed, uint8_t* out, int max_n);
void store_stats(void* h, uint64_t* out5);
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

static std::string g_path;
static const char* kPath = nullptr;  // set by main

static void test_create_seal_get() {
  void* h = store_create_arena(kPath, 1 << 20, 64);
  assert(h);
  uint8_t id[20];
  make_id(id, 1);
  uint64_t off = 0;
  assert(store_create(h, id, 1000, 16, &off) == 0);
  assert(store_contains(h, id) == 0);  // not sealed yet
  uint8_t* base = (uint8_t*)store_base(h);
  memset(base + off, 0xAB, 1000);
  assert(store_seal(h, id) == 0);
  assert(store_contains(h, id) == 1);
  uint64_t goff, gsize, gmeta;
  assert(store_get(h, id, &goff, &gsize, &gmeta) == 0);
  assert(goff == off && gsize == 1000 && gmeta == 16);
  assert(base[goff] == 0xAB);
  // In use: non-forced delete must refuse (-6).
  assert(store_delete(h, id, 0) == -6);
  assert(store_release(h, id) == 0);
  assert(store_delete(h, id, 0) == 0);
  assert(store_contains(h, id) == 0);
  store_detach(h);
}

static void test_attach_shares_state() {
  void* h1 = store_create_arena(kPath, 1 << 20, 64);
  uint8_t id[20];
  make_id(id, 7);
  uint64_t off;
  assert(store_create(h1, id, 64, 0, &off) == 0);
  assert(store_seal(h1, id) == 0);
  void* h2 = store_attach(kPath);
  assert(h2);
  assert(store_contains(h2, id) == 1);
  store_detach(h2);
  store_detach(h1);
}

static void test_oom_and_auto_evict() {
  void* h = store_create_arena(kPath, 1 << 20, 64);  // ~1MB heap
  uint8_t id[20];
  uint64_t off;
  for (int i = 0; i < 3; i++) {
    make_id(id, 100 + i);
    assert(store_create(h, id, 250000, 0, &off) == 0);
    assert(store_seal(h, id) == 0);
  }
  // auto_evict off: big create reports OOM (-3), victims survive.
  store_set_auto_evict(h, 0);
  make_id(id, 999);
  assert(store_create(h, id, 700000, 0, &off) == -3);
  make_id(id, 100);
  assert(store_contains(h, id) == 1);
  // Candidates: LRU order, enough bytes.
  uint8_t out[64 * 20];
  int n = store_lru_candidates(h, 500000, out, 64);
  assert(n == 2);
  int first;
  memcpy(&first, out, sizeof(first));
  assert(first == 100);  // oldest first
  // auto_evict on: the same create succeeds by evicting.
  store_set_auto_evict(h, 1);
  make_id(id, 999);
  assert(store_create(h, id, 700000, 0, &off) == 0);
  assert(store_seal(h, id) == 0);
  make_id(id, 100);
  assert(store_contains(h, id) == 0);  // evicted
  store_detach(h);
}

static void test_abort_frees() {
  void* h = store_create_arena(kPath, 1 << 20, 64);
  uint64_t stats[5];
  store_stats(h, stats);
  uint64_t in_use0 = stats[1];
  uint8_t id[20];
  make_id(id, 42);
  uint64_t off;
  assert(store_create(h, id, 5000, 0, &off) == 0);
  assert(store_abort(h, id) == 0);
  store_stats(h, stats);
  assert(stats[1] == in_use0);
  store_detach(h);
}

// Concurrency: N threads create/seal/get/release distinct objects through
// their own attach handles — exercises the process-shared mutex (TSAN
// target).
struct ThreadArg {
  int tid;
};

static void* thread_body(void* p) {
  ThreadArg* a = (ThreadArg*)p;
  void* h = store_attach(kPath);
  assert(h);
  uint8_t id[20];
  for (int i = 0; i < 50; i++) {
    make_id(id, a->tid * 1000 + i);
    uint64_t off;
    if (store_create(h, id, 512, 0, &off) != 0) continue;
    uint8_t* base = (uint8_t*)store_base(h);
    memset(base + off, a->tid, 512);
    store_seal(h, id);
    uint64_t goff, gsize, gmeta;
    assert(store_get(h, id, &goff, &gsize, &gmeta) == 0);
    assert(base[goff] == (uint8_t)a->tid);
    store_release(h, id);
    store_delete(h, id, 0);
  }
  store_detach(h);
  return nullptr;
}

static void test_concurrent_clients() {
  void* h = store_create_arena(kPath, 4 << 20, 4096);
  pthread_t threads[8];
  ThreadArg args[8];
  for (int i = 0; i < 8; i++) {
    args[i].tid = i + 1;
    pthread_create(&threads[i], nullptr, thread_body, &args[i]);
  }
  for (int i = 0; i < 8; i++) pthread_join(threads[i], nullptr);
  uint64_t stats[5];
  store_stats(h, stats);
  assert(stats[0] == 0);  // every object deleted
  store_detach(h);
}

static void test_forced_delete_defers_under_pins() {
  // Owner-driven GC (force delete) while a reader holds a pin: the
  // object becomes invisible immediately, but its EXTENT must survive
  // until the last release — a new create reusing the memory would
  // corrupt the reader's zero-copy view.
  void* h = store_create_arena(kPath, 1 << 20, 64);
  assert(h);
  uint8_t id[20], id2[20];
  make_id(id, 41);
  make_id(id2, 42);
  uint64_t off = 0;
  assert(store_create(h, id, 1000, 16, &off) == 0);
  uint8_t* base = (uint8_t*)store_base(h);
  memset(base + off, 0x5A, 1000);
  assert(store_seal(h, id) == 0);
  uint64_t goff, gsize, gmeta;
  assert(store_get(h, id, &goff, &gsize, &gmeta) == 0);  // pin
  assert(store_delete(h, id, 1) == 0);                   // doomed
  assert(store_contains(h, id) == 0);                    // invisible
  uint64_t o2, s2, m2;
  assert(store_get(h, id, &o2, &s2, &m2) != 0);          // no new gets
  // Fill the heap with creates: none may land on the pinned extent.
  for (int i = 0; i < 32; i++) {
    uint8_t idn[20];
    make_id(idn, 100 + i);
    uint64_t offn = 0;
    if (store_create(h, idn, 1000, 16, &offn) != 0) break;
    assert(offn != goff);
    memset(base + offn, 0xEE, 1000);
    assert(store_seal(h, idn) == 0);
  }
  assert(base[goff] == 0x5A);                            // view intact
  assert(store_release(h, id) == 0);                     // last ref: freed
  // The extent is reusable now.
  uint64_t off2 = 0;
  assert(store_create(h, id2, 1000, 16, &off2) == 0);
  assert(store_seal(h, id2) == 0);
  store_detach(h);
}

int main(int argc, char** argv) {
  g_path = scratch_path(argc, argv, "tpustore_test_arena");
  kPath = g_path.c_str();
  unlink(kPath);
  test_create_seal_get();
  test_attach_shares_state();
  test_oom_and_auto_evict();
  test_abort_frees();
  test_concurrent_clients();
  test_forced_delete_defers_under_pins();
  unlink(kPath);
  printf("store_test: OK\n");
  return 0;
}
