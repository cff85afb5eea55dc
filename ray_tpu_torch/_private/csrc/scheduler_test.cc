// Unit tests for the native cluster scheduler (plain-assert harness;
// parity intent: reference hybrid_scheduling_policy_test.cc and
// bundle_scheduling_policy semantics). Run via `make test` and sanitizer
// variants.

#include <assert.h>
#include <pthread.h>
#include <stdio.h>
#include <string.h>

extern "C" {
void* sched_create();
void sched_destroy(void*);
int sched_update_node(void* h, const char* id, const char* total,
                      const char* avail, const char* labels, int alive);
int sched_remove_node(void* h, const char* id);
int sched_num_nodes(void* h);
int sched_debit_node(void* h, const char* id, const char* demand);
int sched_pick_node(void* h, const char* demand, const char* strategy,
                    const char* exclude, int flags, unsigned seed, char* out,
                    int out_len);
int sched_schedule_bundles(void* h, const char* bundles, const char* strategy,
                           const char* ici_key, char* out, int out_len);
}

#define SEP "\x1e"

static void test_pick_policies() {
  void* h = sched_create();
  sched_update_node(h, "a", "CPU=8", "CPU=8", "", 1);
  sched_update_node(h, "b", "CPU=8", "CPU=2", "", 1);
  char out[64];
  assert(sched_pick_node(h, "CPU=1", "pack", "", 0, 0, out, 64) == 0);
  assert(strcmp(out, "b") == 0);
  assert(sched_pick_node(h, "CPU=1", "spread", "", 0, 0, out, 64) == 0);
  assert(strcmp(out, "a") == 0);
  // Infeasible demand.
  assert(sched_pick_node(h, "CPU=16", "pack", "", 0, 0, out, 64) != 0);
  // fallback_total flag: 'a' has total 8 >= 5 even if avail were low.
  sched_update_node(h, "a", nullptr, "CPU=0", nullptr, 1);
  assert(sched_pick_node(h, "CPU=5", "pack", "", 1, 0, out, 64) == 0);
  assert(strcmp(out, "a") == 0);
  sched_destroy(h);
}

static void test_hybrid_threshold() {
  void* h = sched_create();
  sched_update_node(h, "cold", "CPU=10", "CPU=9", "", 1);
  sched_update_node(h, "hot", "CPU=10", "CPU=2", "", 1);
  char out[64];
  for (unsigned seed = 0; seed < 8; seed++) {
    assert(sched_pick_node(h, "CPU=1", "hybrid", "", 0, seed, out, 64) == 0);
    assert(strcmp(out, "cold") == 0);
  }
  sched_destroy(h);
}

static void test_labels_with_commas() {
  // Values containing ',' and '=' survive the RS-separated wire format.
  void* h = sched_create();
  sched_update_node(h, "h1", "TPU=4", "TPU=4",
                    "zone=us,central-1" SEP "tpu-slice=s=1", 1);
  sched_update_node(h, "h2", "TPU=4", "TPU=4",
                    "tpu-slice=s=1", 1);
  char out[256];
  assert(sched_schedule_bundles(h, "TPU=4|TPU=4", "STRICT_ICI", "tpu-slice",
                                out, 256) == 0);
  sched_destroy(h);
}

static void test_bundles() {
  void* h = sched_create();
  sched_update_node(h, "a", "CPU=4", "CPU=4", "", 1);
  sched_update_node(h, "b", "CPU=4", "CPU=4", "", 1);
  char out[256];
  assert(sched_schedule_bundles(h, "CPU=2|CPU=2", "PACK", "", out, 256) == 0);
  assert(strcmp(out, "a,a") == 0);
  assert(sched_schedule_bundles(h, "CPU=1|CPU=1|CPU=1", "STRICT_SPREAD", "",
                                out, 256) != 0);
  assert(sched_schedule_bundles(h, "CPU=1|CPU=1", "STRICT_SPREAD", "",
                                out, 256) == 0);
  assert(sched_schedule_bundles(h, "CPU=3|CPU=3", "STRICT_PACK", "",
                                out, 256) != 0);
  sched_destroy(h);
}

static void test_fixed_point() {
  void* h = sched_create();
  sched_update_node(h, "a", "CPU=1", "CPU=1", "", 1);
  for (int i = 0; i < 10; i++) sched_debit_node(h, "a", "CPU=0.1");
  char out[64];
  // Exactly drained: even 0.0001 CPU must not fit.
  assert(sched_pick_node(h, "CPU=0.0001", "pack", "", 0, 0, out, 64) != 0);
  sched_destroy(h);
}

// Thread-safety smoke (TSAN target): concurrent updates + picks.
static void* churn(void* p) {
  void* h = p;
  char out[64];
  char name[16];
  for (int i = 0; i < 200; i++) {
    snprintf(name, sizeof(name), "n%d", i % 16);
    sched_update_node(h, name, "CPU=4", "CPU=4", "", 1);
    sched_pick_node(h, "CPU=1", "hybrid", "", 0, (unsigned)i, out, 64);
    if (i % 7 == 0) sched_remove_node(h, name);
  }
  return nullptr;
}

static void test_concurrent() {
  void* h = sched_create();
  pthread_t t[4];
  for (int i = 0; i < 4; i++) pthread_create(&t[i], nullptr, churn, h);
  for (int i = 0; i < 4; i++) pthread_join(t[i], nullptr);
  sched_destroy(h);
}

int main() {
  test_pick_policies();
  test_hybrid_threshold();
  test_labels_with_commas();
  test_bundles();
  test_fixed_point();
  test_concurrent();
  printf("scheduler_test: OK\n");
  return 0;
}
