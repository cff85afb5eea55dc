// Unit tests for the native GCS table storage (plain-assert harness;
// parity intent: reference gcs_table_storage/store_client tests —
// put/get/del round-trips, WAL replay after crash, compaction, and a
// truncated-WAL tail). Run via `make test` and sanitizer variants.

#include <assert.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

extern "C" {
void* gstore_create(const char* path_prefix);
void gstore_destroy(void*);
int gstore_put(void*, const char* ns, const char* key, const char* val,
               int val_len);
int gstore_del(void*, const char* ns, const char* key);
int gstore_get(void*, const char* ns, const char* key, char* out, int len);
int gstore_num_rows(void*);
uint64_t gstore_wal_bytes(void*);
int gstore_scan(void*, const char* ns, int* cursor, char* kout, int klen,
                char* vout, int vlen);
int gstore_namespaces(void*, char* out, int len);
int gstore_compact(void*);
int gstore_sync(void*);
}

static char prefix[256];
// The directory of the test's files: argv[1], else $TMPDIR, else /tmp.
static const char* scratch_dir = "/tmp";

static void fresh_prefix(const char* name) {
  snprintf(prefix, sizeof(prefix), "%s/gstore_test_%d_%s", scratch_dir,
           getpid(), name);
  char p[300];
  snprintf(p, sizeof(p), "%s.snap", prefix);
  remove(p);
  snprintf(p, sizeof(p), "%s.wal", prefix);
  remove(p);
}

static void test_basic_roundtrip() {
  fresh_prefix("basic");
  void* g = gstore_create(prefix);
  assert(gstore_put(g, "actors", "a1", "spec-bytes", 10) == 0);
  assert(gstore_put(g, "actors", "a2", "x", 1) == 0);
  assert(gstore_put(g, "kv", "fn", "blob\0bin", 8) == 0);  // binary-safe
  char buf[64];
  assert(gstore_get(g, "actors", "a1", buf, sizeof(buf)) == 10);
  assert(memcmp(buf, "spec-bytes", 10) == 0);
  assert(gstore_get(g, "kv", "fn", buf, sizeof(buf)) == 8);
  assert(memcmp(buf, "blob\0bin", 8) == 0);
  assert(gstore_get(g, "actors", "nope", buf, sizeof(buf)) == -1);
  assert(gstore_num_rows(g) == 3);
  assert(gstore_del(g, "actors", "a2") == 0);
  assert(gstore_get(g, "actors", "a2", buf, sizeof(buf)) == -1);
  assert(gstore_num_rows(g) == 2);
  // overwrite
  assert(gstore_put(g, "actors", "a1", "v2", 2) == 0);
  assert(gstore_get(g, "actors", "a1", buf, sizeof(buf)) == 2);
  gstore_destroy(g);
}

static void test_wal_replay_after_crash() {
  fresh_prefix("wal");
  void* g = gstore_create(prefix);
  assert(gstore_put(g, "jobs", "j1", "running", 7) == 0);
  assert(gstore_put(g, "jobs", "j2", "done", 4) == 0);
  assert(gstore_del(g, "jobs", "j2") == 0);
  assert(gstore_wal_bytes(g) > 0);
  // "Crash": destroy without compact — state must come back from WAL.
  gstore_destroy(g);
  void* g2 = gstore_create(prefix);
  char buf[32];
  assert(gstore_get(g2, "jobs", "j1", buf, sizeof(buf)) == 7);
  assert(memcmp(buf, "running", 7) == 0);
  assert(gstore_get(g2, "jobs", "j2", buf, sizeof(buf)) == -1);
  gstore_destroy(g2);
}

static void test_compact_and_reload() {
  fresh_prefix("compact");
  void* g = gstore_create(prefix);
  for (int i = 0; i < 100; i++) {
    char key[16], val[16];
    snprintf(key, sizeof(key), "k%d", i);
    snprintf(val, sizeof(val), "v%d", i * i);
    assert(gstore_put(g, "pg", key, val, strlen(val)) == 0);
  }
  assert(gstore_compact(g) == 0);
  assert(gstore_wal_bytes(g) == 0);
  // Post-compact mutations land in a fresh WAL.
  assert(gstore_put(g, "pg", "k5", "updated", 7) == 0);
  gstore_destroy(g);

  void* g2 = gstore_create(prefix);
  assert(gstore_num_rows(g2) == 100);
  char buf[32];
  assert(gstore_get(g2, "pg", "k5", buf, sizeof(buf)) == 7);
  assert(memcmp(buf, "updated", 7) == 0);
  assert(gstore_get(g2, "pg", "k99", buf, sizeof(buf)) == 5);
  gstore_destroy(g2);
}

static void test_truncated_wal_tail() {
  fresh_prefix("trunc");
  void* g = gstore_create(prefix);
  assert(gstore_put(g, "t", "complete", "ok", 2) == 0);
  gstore_destroy(g);
  // Append garbage — a record cut mid-write by a crash.
  char p[300];
  snprintf(p, sizeof(p), "%s.wal", prefix);
  FILE* f = fopen(p, "ab");
  uint8_t op = 1;
  uint32_t nslen = 100;  // claims 100 bytes, provides 3
  fwrite(&op, 1, 1, f);
  fwrite(&nslen, 4, 1, f);
  fwrite("abc", 3, 1, f);
  fclose(f);
  void* g2 = gstore_create(prefix);
  char buf[8];
  assert(gstore_get(g2, "t", "complete", buf, sizeof(buf)) == 2);
  assert(gstore_num_rows(g2) == 1);
  gstore_destroy(g2);
}

static void test_corrupt_length_field() {
  // A corrupted length (e.g. bit flip to ~4 GiB) must stop replay at
  // the bad record — not bad_alloc the restarting GCS.
  fresh_prefix("corrupt");
  void* g = gstore_create(prefix);
  assert(gstore_put(g, "t", "good", "v", 1) == 0);
  assert(gstore_sync(g) == 0);
  gstore_destroy(g);
  char p[300];
  snprintf(p, sizeof(p), "%s.wal", prefix);
  FILE* f = fopen(p, "ab");
  uint8_t op = 1;
  uint32_t huge = 0xfffffff0u;  // claims ~4 GiB
  fwrite(&op, 1, 1, f);
  fwrite(&huge, 4, 1, f);
  fwrite("x", 1, 1, f);
  fclose(f);
  void* g2 = gstore_create(prefix);  // must not crash/alloc 4 GiB
  char buf[8];
  assert(gstore_get(g2, "t", "good", buf, sizeof(buf)) == 1);
  assert(gstore_num_rows(g2) == 1);
  gstore_destroy(g2);
}

static void test_scan_and_namespaces() {
  fresh_prefix("scan");
  void* g = gstore_create(prefix);
  assert(gstore_put(g, "nodes", "n1", "a", 1) == 0);
  assert(gstore_put(g, "nodes", "n2", "bb", 2) == 0);
  assert(gstore_put(g, "kv", "x", "y", 1) == 0);
  char nss[64];
  assert(gstore_namespaces(g, nss, sizeof(nss)) == 2);
  assert(strcmp(nss, "kv\x1enodes") == 0);
  int cursor = 0, count = 0, vlen;
  char key[32], val[32];
  while ((vlen = gstore_scan(g, "nodes", &cursor, key, sizeof(key), val,
                             sizeof(val))) >= 0) {
    count++;
    if (strcmp(key, "n2") == 0) assert(vlen == 2);
  }
  assert(count == 2 && cursor == 2);
  gstore_destroy(g);
}

struct ChurnArgs {
  void* g;
  int tid;
};

static void* churn(void* arg) {
  auto* a = static_cast<ChurnArgs*>(arg);
  char key[32];
  for (int i = 0; i < 500; i++) {
    snprintf(key, sizeof(key), "t%d-%d", a->tid, i % 16);
    gstore_put(a->g, "churn", key, key, strlen(key));
    char buf[32];
    gstore_get(a->g, "churn", key, buf, sizeof(buf));
    if (i % 7 == 0) gstore_del(a->g, "churn", key);
  }
  return nullptr;
}

static void test_concurrent_churn() {
  fresh_prefix("churn");
  void* g = gstore_create(prefix);
  pthread_t t[4];
  ChurnArgs args[4];
  for (int i = 0; i < 4; i++) {
    args[i] = {g, i};
    pthread_create(&t[i], nullptr, churn, &args[i]);
  }
  for (int i = 0; i < 4; i++) pthread_join(t[i], nullptr);
  assert(gstore_compact(g) == 0);
  gstore_destroy(g);
  void* g2 = gstore_create(prefix);
  assert(gstore_num_rows(g2) <= 64);
  gstore_destroy(g2);
}

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : getenv("TMPDIR");
  if (dir != nullptr && *dir != 0) scratch_dir = dir;
  test_basic_roundtrip();
  test_wal_replay_after_crash();
  test_compact_and_reload();
  test_truncated_wal_tail();
  test_corrupt_length_field();
  test_scan_and_namespaces();
  test_concurrent_churn();
  printf("gcs_store_test: all passed\n");
  return 0;
}
