// plasma-lite: shared-memory object store for ray_tpu.
//
// TPU-native re-design of the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h:55,
//  object_lifecycle_manager, eviction_policy, plasma_allocator over
//  dlmalloc.cc). Unlike the reference — which runs the store as a server
// thread inside the raylet speaking a flatbuffer socket protocol — this
// store is a *library*: all processes on a node mmap the same shared-memory
// arena and coordinate through a process-shared robust mutex held in the
// arena header. That removes a socket round-trip from every create/get and
// keeps the zero-copy mmap read path (plasma's key property) intact, which
// matters on TPU hosts where the store is the host-RAM staging area for
// ray_tpu.data blocks and checkpoints feeding jax.device_put.
//
// Exposed as a flat C ABI consumed from Python via ctypes (no pybind11 in
// this environment).
//
// Layout of the arena:
//   [StoreHeader][ObjectEntry x capacity][heap ...]
// Heap allocation: address-ordered first-fit free list with coalescing,
// 64-byte alignment (cacheline; also friendly to numpy/jax buffer reads).
// Eviction: LRU over sealed, refcount==0 objects (reference:
// src/ray/object_manager/plasma/eviction_policy.h).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdio>

namespace {

constexpr uint64_t kMagic = 0x7470755f73746f72ULL;  // "tpu_stor"
constexpr uint64_t kAlign = 64;
constexpr uint64_t kNullOffset = ~0ULL;
constexpr int kIdSize = 20;

// Object states.
enum : uint32_t {
  kStateEmpty = 0,
  kStateCreated = 1,
  kStateSealed = 2,
  kStateTombstone = 3,
  // Deleted while readers still hold refs: invisible to get/contains,
  // extent freed on the LAST release (owner-driven GC must not yank
  // memory out from under a live zero-copy view).
  kStateDoomed = 4,
};

// Error codes (returned as negative ints through the C ABI).
enum : int {
  kOK = 0,
  kErrNotFound = -1,
  kErrExists = -2,
  kErrOutOfMemory = -3,
  kErrNotSealed = -4,
  kErrTableFull = -5,
  kErrInUse = -6,
  kErrBadArena = -7,
};

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;      // data offset from arena base
  uint64_t size;        // payload size visible to readers
  uint64_t alloc_size;  // actual heap bytes reserved (>= size; the
                        // allocator may absorb an unsplittable remainder)
  uint64_t meta_size;   // leading metadata bytes within payload
  int32_t refcount;
  uint32_t _pad;
  uint64_t lru_tick;
  uint64_t create_tick;
};

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // arena offset of next free block, kNullOffset at end
};

struct StoreHeader {
  uint64_t magic;
  uint64_t arena_size;
  uint64_t heap_offset;
  uint64_t heap_size;
  uint32_t table_capacity;
  // 1 = store_create evicts LRU objects itself when full (standalone use);
  // 0 = create returns OOM and the raylet decides (spill-to-disk first,
  // reference: local_object_manager.h spill/restore).
  uint32_t auto_evict;
  pthread_mutex_t mutex;  // process-shared, robust
  uint64_t lru_tick;
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t free_head;  // arena offset of first free block
  uint64_t num_evictions;
  uint64_t num_creates;
};

struct Store {
  uint8_t* base;
  uint64_t mapped_size;
  StoreHeader* hdr;
  ObjectEntry* table;
};

static uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

static uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (int i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

static void lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A worker died holding the lock. Marking consistent lets survivors
    // continue, but free-list splicing is multi-step: a death mid-splice
    // can leave a corrupt chain. KNOWN LIMITATION — crash consistency
    // needs a redo log or an allocation journal (the reference sidesteps
    // this by funneling all mutations through the single raylet-hosted
    // store thread). Until then the raylet treats repeated allocator
    // faults as grounds to recreate the arena.
    pthread_mutex_consistent(&s->hdr->mutex);
  }
}

static void unlock(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

// ---- hash table ----

// Find entry for id. Returns nullptr if absent. If insert_slot is non-null,
// sets *insert_slot to the first usable slot (empty or tombstone) for insert.
static ObjectEntry* table_find(Store* s, const uint8_t* id, ObjectEntry** insert_slot) {
  uint32_t cap = s->hdr->table_capacity;
  uint64_t idx = hash_id(id) % cap;
  ObjectEntry* first_free = nullptr;
  for (uint32_t probe = 0; probe < cap; probe++) {
    ObjectEntry* e = &s->table[(idx + probe) % cap];
    if (e->state == kStateEmpty) {
      if (!first_free) first_free = e;
      break;
    }
    if (e->state == kStateTombstone) {
      if (!first_free) first_free = e;
      continue;
    }
    if (memcmp(e->id, id, kIdSize) == 0) {
      if (insert_slot) *insert_slot = nullptr;
      return e;
    }
  }
  if (insert_slot) *insert_slot = first_free;
  return nullptr;
}

// ---- heap ----

// Allocates >= size bytes; writes the ACTUAL reserved byte count (which the
// caller must pass back to heap_free) to *actual.
static uint64_t heap_alloc(Store* s, uint64_t size, uint64_t* actual) {
  size = align_up(size < kAlign ? kAlign : size, kAlign);
  uint64_t prev_off = kNullOffset;
  uint64_t off = s->hdr->free_head;
  while (off != kNullOffset) {
    FreeBlock* b = reinterpret_cast<FreeBlock*>(s->base + off);
    if (b->size >= size) {
      uint64_t remaining = b->size - size;
      uint64_t next;
      if (remaining >= sizeof(FreeBlock) + kAlign) {
        // Split: tail remains free.
        uint64_t tail_off = off + size;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(s->base + tail_off);
        tail->size = remaining;
        tail->next = b->next;
        next = tail_off;
      } else {
        size = b->size;  // absorb the remainder
        next = b->next;
      }
      if (prev_off == kNullOffset) {
        s->hdr->free_head = next;
      } else {
        reinterpret_cast<FreeBlock*>(s->base + prev_off)->next = next;
      }
      s->hdr->bytes_in_use += size;
      *actual = size;
      return off;
    }
    prev_off = off;
    off = b->next;
  }
  return kNullOffset;
}

static void heap_free(Store* s, uint64_t off, uint64_t size) {
  // `size` is the exact reserved size returned by heap_alloc via *actual.
  s->hdr->bytes_in_use -= size;
  // Insert address-ordered, coalescing with neighbors.
  uint64_t prev_off = kNullOffset;
  uint64_t cur = s->hdr->free_head;
  while (cur != kNullOffset && cur < off) {
    prev_off = cur;
    cur = reinterpret_cast<FreeBlock*>(s->base + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(s->base + off);
  blk->size = size;
  blk->next = cur;
  if (prev_off == kNullOffset) {
    s->hdr->free_head = off;
  } else {
    FreeBlock* prev = reinterpret_cast<FreeBlock*>(s->base + prev_off);
    if (prev_off + prev->size == off) {
      // Coalesce with prev.
      prev->size += size;
      prev->next = cur;
      off = prev_off;
      blk = prev;
    } else {
      prev->next = off;
    }
  }
  if (cur != kNullOffset && off + blk->size == cur) {
    FreeBlock* nxt = reinterpret_cast<FreeBlock*>(s->base + cur);
    blk->size += nxt->size;
    blk->next = nxt->next;
  }
}

// Evict LRU sealed refcount==0 objects until `needed` bytes could plausibly
// be allocated. Returns number of objects evicted.
// PERF: O(table_capacity) scan per victim under the global lock; an
// intrusive LRU list (reference: eviction_policy.h) is the planned upgrade
// if eviction shows up in node-level profiles.
static int evict_lru(Store* s, uint64_t needed) {
  int evicted = 0;
  for (;;) {
    // Try allocation probe: find max contiguous free block.
    uint64_t off = s->hdr->free_head;
    uint64_t max_free = 0;
    while (off != kNullOffset) {
      FreeBlock* b = reinterpret_cast<FreeBlock*>(s->base + off);
      if (b->size > max_free) max_free = b->size;
      off = b->next;
    }
    if (max_free >= align_up(needed < kAlign ? kAlign : needed, kAlign)) return evicted;
    // Pick victim: sealed, refcount<=0, oldest lru_tick.
    ObjectEntry* victim = nullptr;
    for (uint32_t i = 0; i < s->hdr->table_capacity; i++) {
      ObjectEntry* e = &s->table[i];
      if (e->state == kStateSealed && e->refcount <= 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) return evicted;
    heap_free(s, victim->offset, victim->alloc_size);
    victim->state = kStateTombstone;
    s->hdr->num_objects--;
    s->hdr->num_evictions++;
    evicted++;
  }
}

}  // namespace

extern "C" {

// Create (or truncate) the arena file and initialize structures.
// Returns opaque handle or null.
void* store_create_arena(const char* path, uint64_t arena_size, uint32_t table_capacity) {
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)arena_size) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, arena_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Store* s = new Store();
  s->base = reinterpret_cast<uint8_t*>(mem);
  s->mapped_size = arena_size;
  s->hdr = reinterpret_cast<StoreHeader*>(s->base);
  memset(s->hdr, 0, sizeof(StoreHeader));

  uint64_t table_off = align_up(sizeof(StoreHeader), kAlign);
  uint64_t heap_off = align_up(table_off + (uint64_t)table_capacity * sizeof(ObjectEntry), kAlign);
  if (heap_off + kAlign > arena_size) {
    // Arena too small for header + table + any heap at all.
    munmap(mem, arena_size);
    delete s;
    return nullptr;
  }

  s->hdr->magic = kMagic;
  s->hdr->arena_size = arena_size;
  s->hdr->heap_offset = heap_off;
  s->hdr->heap_size = arena_size - heap_off;
  s->hdr->table_capacity = table_capacity;
  s->hdr->auto_evict = 1;
  s->table = reinterpret_cast<ObjectEntry*>(s->base + table_off);
  memset(s->table, 0, (uint64_t)table_capacity * sizeof(ObjectEntry));

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&s->hdr->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  // Entire heap is one free block.
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(s->base + heap_off);
  blk->size = s->hdr->heap_size;
  blk->next = kNullOffset;
  s->hdr->free_head = heap_off;
  return s;
}

// Attach to an existing arena created by store_create_arena.
void* store_attach(const char* path) {
  int fd = open(path, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Store* s = new Store();
  s->base = reinterpret_cast<uint8_t*>(mem);
  s->mapped_size = (uint64_t)st.st_size;
  s->hdr = reinterpret_cast<StoreHeader*>(s->base);
  if (s->hdr->magic != kMagic) {
    munmap(mem, s->mapped_size);
    delete s;
    return nullptr;
  }
  uint64_t table_off = align_up(sizeof(StoreHeader), kAlign);
  s->table = reinterpret_cast<ObjectEntry*>(s->base + table_off);
  return s;
}

void store_detach(void* handle) {
  Store* s = reinterpret_cast<Store*>(handle);
  munmap(s->base, s->mapped_size);
  delete s;
}

// Returns base pointer of the mapping (python uses its own mmap for reads;
// this exists for tests and debugging).
void* store_base(void* handle) { return reinterpret_cast<Store*>(handle)->base; }

// Create an object of data_size bytes (meta_size of which are metadata).
// On success writes arena offset to *out_offset.
int store_create(void* handle, const uint8_t* id, uint64_t data_size, uint64_t meta_size,
                 uint64_t* out_offset) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* slot = nullptr;
  ObjectEntry* existing = table_find(s, id, &slot);
  if (existing) {
    // A kStateDoomed entry also lands here: re-creating an id whose
    // old extent is still pinned fails until the last reader releases
    // (plasma-parity — the alternative, freeing under the pin, is the
    // corruption the Doomed state exists to prevent). Rare: requires
    // force-delete + live local pin + same-id recreate on one node.
    unlock(s);
    return kErrExists;
  }
  if (!slot) {
    unlock(s);
    return kErrTableFull;
  }
  uint64_t actual = 0;
  uint64_t off = heap_alloc(s, data_size, &actual);
  if (off == kNullOffset && s->hdr->auto_evict) {
    evict_lru(s, data_size);
    off = heap_alloc(s, data_size, &actual);
  }
  if (off == kNullOffset) {
    unlock(s);
    return kErrOutOfMemory;
  }
  memcpy(slot->id, id, kIdSize);
  slot->state = kStateCreated;
  slot->offset = off;
  slot->size = data_size;
  slot->alloc_size = actual;
  slot->meta_size = meta_size;
  slot->refcount = 1;  // creator holds a ref until seal+release
  slot->lru_tick = ++s->hdr->lru_tick;
  slot->create_tick = slot->lru_tick;
  s->hdr->num_objects++;
  s->hdr->num_creates++;
  *out_offset = off;
  unlock(s);
  return kOK;
}

int store_seal(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  if (!e) {
    unlock(s);
    return kErrNotFound;
  }
  if (e->state == kStateSealed) {
    unlock(s);
    return kOK;
  }
  e->state = kStateSealed;
  e->refcount -= 1;  // drop creator ref
  unlock(s);
  return kOK;
}

// Get a sealed object: increments refcount, returns offset/size/meta_size.
int store_get(void* handle, const uint8_t* id, uint64_t* out_offset, uint64_t* out_size,
              uint64_t* out_meta_size) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  if (!e) {
    unlock(s);
    return kErrNotFound;
  }
  if (e->state != kStateSealed) {
    unlock(s);
    return kErrNotSealed;
  }
  e->refcount++;
  e->lru_tick = ++s->hdr->lru_tick;
  *out_offset = e->offset;
  *out_size = e->size;
  *out_meta_size = e->meta_size;
  unlock(s);
  return kOK;
}

int store_release(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  if (!e) {
    unlock(s);
    return kErrNotFound;
  }
  if (e->refcount > 0) e->refcount--;
  if (e->state == kStateDoomed && e->refcount <= 0) {
    heap_free(s, e->offset, e->alloc_size);
    e->state = kStateTombstone;
  }
  unlock(s);
  return kOK;
}

int store_contains(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  int r = (e && e->state == kStateSealed) ? 1 : 0;
  unlock(s);
  return r;
}

// Delete. force!=0 (owner-driven refcount GC: once the distributed
// refcount hits zero no NEW reader may appear) hides the object
// immediately, but an extent with live local pins is only reclaimed on
// the LAST release — freeing under a pinned zero-copy view would hand
// its memory to the next create and corrupt the reader.
int store_delete(void* handle, const uint8_t* id, int force) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  if (!e || e->state == kStateTombstone || e->state == kStateDoomed) {
    unlock(s);
    return kErrNotFound;
  }
  if (e->refcount > 0) {
    if (!force) {
      unlock(s);
      return kErrInUse;
    }
    e->state = kStateDoomed;   // no new gets; freed on last release
    s->hdr->num_objects--;
    unlock(s);
    return kOK;
  }
  heap_free(s, e->offset, e->alloc_size);
  e->state = kStateTombstone;
  s->hdr->num_objects--;
  unlock(s);
  return kOK;
}

// Abort an in-progress create (task failed before seal).
int store_abort(void* handle, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  ObjectEntry* e = table_find(s, id, nullptr);
  if (!e || e->state != kStateCreated) {
    unlock(s);
    return kErrNotFound;
  }
  heap_free(s, e->offset, e->alloc_size);
  e->state = kStateTombstone;
  s->hdr->num_objects--;
  unlock(s);
  return kOK;
}

// Fill `out` (capacity max_n*20 bytes) with ids of sealed objects; returns count.
int store_list(void* handle, uint8_t* out, int max_n) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int n = 0;
  for (uint32_t i = 0; i < s->hdr->table_capacity && n < max_n; i++) {
    ObjectEntry* e = &s->table[i];
    if (e->state == kStateSealed) {
      memcpy(out + (size_t)n * kIdSize, e->id, kIdSize);
      n++;
    }
  }
  unlock(s);
  return n;
}

// 1 = evict-on-full inside store_create; 0 = return OOM and let the raylet
// spill (it is the only caller that may flip this, at arena creation).
void store_set_auto_evict(void* handle, int enabled) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  s->hdr->auto_evict = enabled ? 1 : 0;
  unlock(s);
}

// Spill candidate selection: LRU-ordered sealed refcount==0 objects whose
// cumulative reserved bytes reach `needed`. Writes ids (kIdSize bytes each)
// to out; returns the count (may satisfy less than `needed` if the store
// has fewer idle objects).
int store_lru_candidates(void* handle, uint64_t needed, uint8_t* out,
                         int max_n) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int n = 0;
  uint64_t freed = 0;
  // O(candidates · table) selection-sort walk; bounded by max_n picks.
  uint64_t last_tick = 0;
  while (n < max_n && freed < needed) {
    ObjectEntry* best = nullptr;
    for (uint32_t i = 0; i < s->hdr->table_capacity; i++) {
      ObjectEntry* e = &s->table[i];
      if (e->state == kStateSealed && e->refcount <= 0 &&
          e->lru_tick > last_tick &&
          (!best || e->lru_tick < best->lru_tick)) {
        best = e;
      }
    }
    if (!best) break;
    last_tick = best->lru_tick;
    memcpy(out + (size_t)n * kIdSize, best->id, kIdSize);
    freed += best->alloc_size;
    n++;
  }
  unlock(s);
  return n;
}

// stats: [num_objects, bytes_in_use, heap_size, num_evictions, num_creates]
void store_stats(void* handle, uint64_t* out5) {
  Store* s = reinterpret_cast<Store*>(handle);
  lock(s);
  out5[0] = s->hdr->num_objects;
  out5[1] = s->hdr->bytes_in_use;
  out5[2] = s->hdr->heap_size;
  out5[3] = s->hdr->num_evictions;
  out5[4] = s->hdr->num_creates;
  unlock(s);
}

}  // extern "C"
