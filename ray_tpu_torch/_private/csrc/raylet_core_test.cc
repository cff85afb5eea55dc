// Unit tests for the native raylet local-resource core (plain-assert
// harness; parity intent: reference local_task_manager /
// placement_group_resource_manager accounting semantics, incl. the
// blocked-worker release and bundle 2PC). Run via `make test` and the
// sanitizer variants.

#include <assert.h>
#include <pthread.h>
#include <stdio.h>
#include <string.h>

extern "C" {
void* rcore_create(const char* total);
void rcore_destroy(void*);
int rcore_try_acquire(void*, const char* lease_id, const char* res,
                      const char* pg_id, int bundle_index);
int rcore_release(void*, const char* lease_id);
int rcore_block(void*, const char* lease_id);
int rcore_unblock(void*, const char* lease_id);
int rcore_pg_prepare(void*, const char* pg_id, int idx, const char* res);
int rcore_pg_commit(void*, const char* pg_id, int idx);
int rcore_pg_return(void*, const char* pg_id, int idx, char* out, int len);
int rcore_available(void*, char* out, int len);
int rcore_num_leases(void*);
int rcore_num_bundles(void*);
void* rcore_create_with_cards(const char* total, const char* gpu_ids);
int rcore_gpu_ids(void*, const char* lease_id, char* out, int len);
int rcore_cards(void*, char* out, int len);
}

#define SEP "\x1e"

static void expect_avail(void* h, const char* want) {
  char buf[256];
  int n = rcore_available(h, buf, sizeof(buf));
  assert(n >= 0);
  if (strcmp(buf, want) != 0) {
    fprintf(stderr, "avail mismatch: got %s want %s\n", buf, want);
    assert(false);
  }
}

static void test_node_pool_lifecycle() {
  void* h = rcore_create("CPU=4" SEP "TPU=8");
  expect_avail(h, "CPU=4" SEP "TPU=8");

  assert(rcore_try_acquire(h, "l1", "CPU=1", "", -1) == 1);
  assert(rcore_try_acquire(h, "l2", "CPU=2" SEP "TPU=4", "", -1) == 1);
  expect_avail(h, "CPU=1" SEP "TPU=4");
  // duplicate lease id is a caller bug
  assert(rcore_try_acquire(h, "l1", "CPU=1", "", -1) == -2);
  // no fit -> 0, nothing debited
  assert(rcore_try_acquire(h, "l3", "CPU=2", "", -1) == 0);
  expect_avail(h, "CPU=1" SEP "TPU=4");

  assert(rcore_release(h, "l2") == 0);
  expect_avail(h, "CPU=3" SEP "TPU=8");
  assert(rcore_release(h, "l2") == -1);  // idempotent
  assert(rcore_num_leases(h) == 1);
  assert(rcore_release(h, "l1") == 0);
  expect_avail(h, "CPU=4" SEP "TPU=8");
  rcore_destroy(h);
}

static void test_blocked_worker_release() {
  void* h = rcore_create("CPU=1");
  assert(rcore_try_acquire(h, "l1", "CPU=1", "", -1) == 1);
  assert(rcore_try_acquire(h, "n", "CPU=1", "", -1) == 0);  // full

  // Worker parks in ray.get: its CPU frees, nested task can run.
  assert(rcore_block(h, "l1") == 1);
  assert(rcore_block(h, "l1") == 0);  // already blocked
  expect_avail(h, "CPU=1");
  assert(rcore_try_acquire(h, "nested", "CPU=1", "", -1) == 1);

  // Unblock re-debits and may go negative; releases self-correct.
  assert(rcore_unblock(h, "l1") == 1);
  assert(rcore_unblock(h, "l1") == 0);
  expect_avail(h, "CPU=-1");
  assert(rcore_release(h, "nested") == 0);
  expect_avail(h, "CPU=0");
  // release of an unblocked lease credits normally
  assert(rcore_release(h, "l1") == 0);
  expect_avail(h, "CPU=1");
  // blocked lease released while blocked must NOT double-credit
  assert(rcore_try_acquire(h, "l2", "CPU=1", "", -1) == 1);
  assert(rcore_block(h, "l2") == 1);
  assert(rcore_release(h, "l2") == 0);
  expect_avail(h, "CPU=1");
  rcore_destroy(h);
}

static void test_bundle_2pc_and_leases() {
  void* h = rcore_create("CPU=8");
  // prepare carves out of the node pool
  assert(rcore_pg_prepare(h, "pg1", 0, "CPU=2") == 1);
  assert(rcore_pg_prepare(h, "pg1", 0, "CPU=2") == 1);  // idempotent
  assert(rcore_pg_prepare(h, "pg1", 1, "CPU=2") == 1);
  expect_avail(h, "CPU=4");
  assert(rcore_pg_prepare(h, "big", 0, "CPU=100") == 0);  // no fit
  expect_avail(h, "CPU=4");

  // leases against an uncommitted bundle fail with -1
  assert(rcore_try_acquire(h, "a", "CPU=1", "pg1", 0) == -1);
  assert(rcore_pg_commit(h, "pg1", 0) == 0);
  assert(rcore_pg_commit(h, "nope", 0) == -1);

  assert(rcore_try_acquire(h, "a", "CPU=1", "pg1", 0) == 1);
  assert(rcore_try_acquire(h, "b", "CPU=1", "pg1", 0) == 1);
  assert(rcore_try_acquire(h, "c", "CPU=1", "pg1", 0) == 0);  // bundle full
  // node pool untouched by bundle leases
  expect_avail(h, "CPU=4");

  // wildcard index -1 finds the lowest committed bundle of the pg
  assert(rcore_pg_commit(h, "pg1", 1) == 0);
  assert(rcore_release(h, "a") == 0);
  assert(rcore_try_acquire(h, "w", "CPU=1", "pg1", -1) == 1);

  // return bundle 0: outstanding leases (b, w) are reported, full
  // reservation goes back to the node pool
  char out[256];
  int n = rcore_pg_return(h, "pg1", 0, out, sizeof(out));
  assert(n == 2);
  assert(strcmp(out, "b" SEP "w") == 0);
  expect_avail(h, "CPU=6");
  assert(rcore_pg_return(h, "pg1", 0, out, sizeof(out)) == -1);  // gone
  // late release of a lease whose pool vanished: dropped, no credit
  assert(rcore_release(h, "b") == 0);
  expect_avail(h, "CPU=6");
  assert(rcore_pg_return(h, "pg1", 1, out, sizeof(out)) == 0);
  expect_avail(h, "CPU=8");
  assert(rcore_num_bundles(h) == 0);
  rcore_destroy(h);
}

static void test_wildcard_spans_all_bundles() {
  // A full (or uncommitted) lowest-index bundle must not mask capacity
  // in a later bundle of the same PG (reference: _group_ wildcard
  // resources aggregate across all of the PG's bundles).
  void* h = rcore_create("CPU=8");
  assert(rcore_pg_prepare(h, "pg", 0, "CPU=1") == 1);
  assert(rcore_pg_prepare(h, "pg", 1, "CPU=2") == 1);
  assert(rcore_pg_commit(h, "pg", 0) == 0);
  assert(rcore_pg_commit(h, "pg", 1) == 0);
  // Fill bundle 0 entirely.
  assert(rcore_try_acquire(h, "f", "CPU=1", "pg", 0) == 1);
  // Wildcard must land in bundle 1, not report "no fit".
  assert(rcore_try_acquire(h, "w1", "CPU=1", "pg", -1) == 1);
  assert(rcore_try_acquire(h, "w2", "CPU=1", "pg", -1) == 1);
  assert(rcore_try_acquire(h, "w3", "CPU=1", "pg", -1) == 0);  // all full
  // Uncommitted lowest bundle: wildcard skips it rather than erroring.
  assert(rcore_pg_prepare(h, "pg2", 0, "CPU=1") == 1);
  assert(rcore_pg_prepare(h, "pg2", 1, "CPU=1") == 1);
  assert(rcore_pg_commit(h, "pg2", 1) == 0);
  assert(rcore_try_acquire(h, "x", "CPU=1", "pg2", -1) == 1);
  rcore_destroy(h);
}

static void test_blocked_bundle_lease() {
  void* h = rcore_create("CPU=4");
  assert(rcore_pg_prepare(h, "pg", 0, "CPU=2") == 1);
  assert(rcore_pg_commit(h, "pg", 0) == 0);
  assert(rcore_try_acquire(h, "l", "CPU=2", "pg", 0) == 1);
  assert(rcore_try_acquire(h, "m", "CPU=1", "pg", 0) == 0);
  assert(rcore_block(h, "l") == 1);
  assert(rcore_try_acquire(h, "m", "CPU=1", "pg", 0) == 1);  // freed into pool
  assert(rcore_unblock(h, "l") == 1);                        // negative pool ok
  assert(rcore_release(h, "m") == 0);
  assert(rcore_release(h, "l") == 0);
  // bundle reservation still intact through all of it
  char out[64];
  assert(rcore_pg_return(h, "pg", 0, out, sizeof(out)) == 0);
  expect_avail(h, "CPU=4");
  rcore_destroy(h);
}

struct ChurnArgs {
  void* h;
  int tid;
};

static void* churn(void* arg) {
  auto* a = static_cast<ChurnArgs*>(arg);
  char lease[64];
  for (int i = 0; i < 2000; i++) {
    snprintf(lease, sizeof(lease), "t%d-%d", a->tid, i);
    int rc = rcore_try_acquire(a->h, lease, "CPU=1", "", -1);
    if (rc == 1) {
      if (i % 3 == 0) {
        rcore_block(a->h, lease);
        rcore_unblock(a->h, lease);
      }
      rcore_release(a->h, lease);
    }
  }
  return nullptr;
}

static void test_concurrent_churn() {
  void* h = rcore_create("CPU=2");
  pthread_t t[4];
  ChurnArgs args[4];
  for (int i = 0; i < 4; i++) {
    args[i] = {h, i};
    pthread_create(&t[i], nullptr, churn, &args[i]);
  }
  for (int i = 0; i < 4; i++) pthread_join(t[i], nullptr);
  // All leases released: the pool must be exactly restored.
  assert(rcore_num_leases(h) == 0);
  expect_avail(h, "CPU=2");
  rcore_destroy(h);
}

static void expect_cards(void* h, const char* lease, const char* want) {
  char buf[256];
  int n = rcore_gpu_ids(h, lease, buf, sizeof(buf));
  assert(n >= 0);
  if (strcmp(buf, want) != 0) {
    fprintf(stderr, "cards of %s: got '%s' want '%s'\n", lease, buf, want);
    assert(false);
  }
}

static void expect_free(void* h, const char* want) {
  char buf[256];
  assert(rcore_cards(h, buf, sizeof(buf)) >= 0);
  if (strcmp(buf, want) != 0) {
    fprintf(stderr, "card free list: got %s want %s\n", buf, want);
    assert(false);
  }
}

// Whole cards for a demand of 1 or more: distinct cards, by id.
static void test_cards_whole() {
  void* h = rcore_create_with_cards("CPU=4" SEP "GPU=3",
                                    "GPU-a" SEP "GPU-b" SEP "GPU-c");
  assert(rcore_try_acquire(h, "l1", "CPU=1" SEP "GPU=1", "", -1) == 1);
  assert(rcore_try_acquire(h, "l2", "GPU=2", "", -1) == 1);
  expect_cards(h, "l1", "GPU-a");
  expect_cards(h, "l2", "GPU-b" SEP "GPU-c");
  assert(rcore_gpu_ids(h, "l2", nullptr, 0) == -2);  // out too small
  assert(rcore_try_acquire(h, "l3", "GPU=1", "", -1) == 0);
  assert(rcore_release(h, "l2") == 0);
  expect_free(h, "GPU-a=0" SEP "GPU-b=1" SEP "GPU-c=1");
  // 1.5 cards is neither whole cards nor a share of one: never granted.
  assert(rcore_try_acquire(h, "l4", "GPU=1.5", "", -1) == 0);
  expect_avail(h, "CPU=3" SEP "GPU=2");
  assert(rcore_try_acquire(h, "l5", "GPU=2", "", -1) == 1);
  expect_cards(h, "l5", "GPU-b" SEP "GPU-c");
  expect_cards(h, "nope", "");
  rcore_release(h, "l1");
  rcore_release(h, "l5");
  expect_free(h, "GPU-a=1" SEP "GPU-b=1" SEP "GPU-c=1");
  expect_avail(h, "CPU=4" SEP "GPU=3");
  rcore_destroy(h);
}

// Shares below 1 pack best-fit onto one card; a pool that fits but whose
// cards are fragmented grants no whole card.
static void test_cards_shares_best_fit() {
  void* h = rcore_create_with_cards("GPU=2", nullptr);
  assert(rcore_try_acquire(h, "s1", "GPU=0.25", "", -1) == 1);
  assert(rcore_try_acquire(h, "s2", "GPU=0.5", "", -1) == 1);
  assert(rcore_try_acquire(h, "s3", "GPU=0.5", "", -1) == 1);
  assert(rcore_try_acquire(h, "s4", "GPU=0.25", "", -1) == 1);
  expect_cards(h, "s1", "0");
  expect_cards(h, "s2", "0");  // 0.75 left on card 0 is the tighter fit
  expect_cards(h, "s3", "1");
  expect_cards(h, "s4", "0");  // exactly fills card 0
  expect_free(h, "0=0" SEP "1=0.5");
  rcore_release(h, "s1");
  rcore_release(h, "s4");
  expect_free(h, "0=0.5" SEP "1=0.5");
  expect_avail(h, "GPU=1");
  assert(rcore_try_acquire(h, "w", "GPU=1", "", -1) == 0);
  expect_avail(h, "GPU=1");  // nothing debited
  assert(rcore_try_acquire(h, "s5", "GPU=0.5", "", -1) == 1);
  expect_cards(h, "s5", "0");
  rcore_release(h, "s2");
  rcore_release(h, "s3");
  rcore_release(h, "s5");
  expect_free(h, "0=1" SEP "1=1");
  assert(rcore_num_leases(h) == 0);
  rcore_destroy(h);
}

// A blocked worker gives back its CPU but keeps its cards.
static void test_cards_kept_while_blocked() {
  void* h = rcore_create_with_cards("CPU=2" SEP "GPU=1", "7");
  assert(rcore_try_acquire(h, "g", "CPU=1" SEP "GPU=1", "", -1) == 1);
  assert(rcore_block(h, "g") == 1);
  expect_avail(h, "CPU=2" SEP "GPU=0");
  expect_cards(h, "g", "7");
  assert(rcore_try_acquire(h, "x", "GPU=0.5", "", -1) == 0);
  assert(rcore_try_acquire(h, "c", "CPU=2", "", -1) == 1);
  assert(rcore_unblock(h, "g") == 1);
  expect_avail(h, "CPU=-1" SEP "GPU=0");
  rcore_release(h, "c");
  assert(rcore_block(h, "g") == 1);
  assert(rcore_release(h, "g") == 0);  // blocked: GPU and card back
  expect_avail(h, "CPU=2" SEP "GPU=1");
  expect_free(h, "7=1");
  rcore_destroy(h);
}

// A bundle reserves GPU share; its leases still draw distinct cards.
static void test_cards_in_bundles() {
  void* h = rcore_create_with_cards("CPU=4" SEP "GPU=2", "0" SEP "1");
  assert(rcore_pg_prepare(h, "pg", 0, "CPU=2" SEP "GPU=2") == 1);
  assert(rcore_pg_commit(h, "pg", 0) == 0);
  assert(rcore_try_acquire(h, "b1", "GPU=1", "pg", 0) == 1);
  assert(rcore_try_acquire(h, "b2", "GPU=1", "pg", -1) == 1);
  expect_cards(h, "b1", "0");
  expect_cards(h, "b2", "1");
  char out[64];
  assert(rcore_pg_return(h, "pg", 0, out, sizeof(out)) == 2);
  expect_free(h, "0=0" SEP "1=0");  // held until the leases release
  rcore_release(h, "b1");
  rcore_release(h, "b2");
  expect_free(h, "0=1" SEP "1=1");
  expect_avail(h, "CPU=4" SEP "GPU=2");
  rcore_destroy(h);
}

int main() {
  test_node_pool_lifecycle();
  test_blocked_worker_release();
  test_bundle_2pc_and_leases();
  test_wildcard_spans_all_bundles();
  test_blocked_bundle_lease();
  test_concurrent_churn();
  test_cards_whole();
  test_cards_shares_best_fit();
  test_cards_kept_while_blocked();
  test_cards_in_bundles();
  printf("raylet_core_test: all passed\n");
  return 0;
}
