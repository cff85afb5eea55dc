// Native GCS table storage.
//
// TPU-native re-design of the reference GCS persistence stack
// (reference: src/ray/gcs/gcs_server/gcs_table_storage.cc over
// store_client/ — in-memory or redis store clients; redis gives the
// reference per-mutation durability for GCS fault tolerance).
//
// Design: an in-memory (namespace, key) -> bytes table plus a
// write-ahead log. Every put/del appends one framed record to the WAL
// (fflush'd per append) and the in-memory table updates under a mutex;
// a restarted GCS replays snapshot + WAL, so everything written here
// survives a GCS PROCESS crash (truncated tails and corrupt length
// fields stop replay at the last complete record). OS-crash/power-loss
// durability needs gstore_sync (fdatasync), which the GCS batches on a
// short debounce — the same window redis's default appendfsync-everysec
// gives the reference. The GCS calls put/del per acknowledged mutation
// (write-through before the RPC reply); a debounced hash-diff flush
// remains as the catch-all for internal cascades. `compact` rewrites
// the snapshot file atomically and truncates the WAL; callers trigger
// it when the WAL outgrows the snapshot.
//
// File formats (little-endian u32 lengths):
//   snapshot: [u32 ns_len][ns][u32 key_len][key][u32 val_len][val]...
//   wal:      [u8 op: 1=put 2=del][u32 ns_len][ns][u32 key_len][key]
//             ([u32 val_len][val] for put)...   appended per mutation
//
// Exposed as a C ABI for ctypes (ray_tpu_torch/_private/native_gcs_store.py).

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iterator>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct GcsStore {
  std::mutex mu;
  std::map<std::string, std::map<std::string, std::string>> tables;
  std::string snap_path;
  std::string wal_path;
  FILE* wal = nullptr;
  uint64_t wal_bytes = 0;

  // Scan resume cache: restart-time loads call gstore_scan once per
  // row; without this each call would linearly skip `cursor` entries
  // (O(n^2) across a namespace). Invalidated by any mutation.
  std::string scan_ns;
  int scan_cursor = -1;
  std::map<std::string, std::string>::const_iterator scan_it;

  void InvalidateScan() { scan_cursor = -1; }

  ~GcsStore() {
    if (wal) std::fclose(wal);
  }
};

bool WriteU32(FILE* f, uint32_t v) {
  return std::fwrite(&v, 4, 1, f) == 1;
}

bool WriteBlob(FILE* f, const std::string& s) {
  return WriteU32(f, static_cast<uint32_t>(s.size())) &&
         (s.empty() || std::fwrite(s.data(), s.size(), 1, f) == 1);
}

bool ReadU32(FILE* f, uint32_t* v) { return std::fread(v, 4, 1, f) == 1; }

// Bounded read: a corrupted length field must stop replay at the bad
// record, not bad_alloc the restarting GCS (the length is validated
// against the bytes actually left in the file before resizing).
bool ReadBlob(FILE* f, std::string* s, uint64_t* remaining) {
  uint32_t n;
  if (*remaining < 4 || !ReadU32(f, &n)) return false;
  *remaining -= 4;
  if (n > *remaining) return false;  // truncated/corrupt tail
  s->resize(n);
  if (n != 0 && std::fread(&(*s)[0], n, 1, f) != 1) return false;
  *remaining -= n;
  return true;
}

uint64_t FileSize(FILE* f) {
  long cur = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long end = std::ftell(f);
  std::fseek(f, cur, SEEK_SET);
  return end > 0 ? static_cast<uint64_t>(end) : 0;
}

// Load snapshot + replay WAL. Truncated tails (crash mid-append) and
// corrupt length fields stop replay at the last complete record.
void LoadInto(GcsStore* g) {
  if (FILE* f = std::fopen(g->snap_path.c_str(), "rb")) {
    uint64_t rem = FileSize(f);
    std::string ns, key, val;
    while (ReadBlob(f, &ns, &rem) && ReadBlob(f, &key, &rem) &&
           ReadBlob(f, &val, &rem))
      g->tables[ns][key] = val;
    std::fclose(f);
  }
  if (FILE* f = std::fopen(g->wal_path.c_str(), "rb")) {
    uint64_t rem = FileSize(f);
    for (;;) {
      uint8_t op;
      if (rem < 1 || std::fread(&op, 1, 1, f) != 1) break;
      rem -= 1;
      std::string ns, key, val;
      if (!ReadBlob(f, &ns, &rem) || !ReadBlob(f, &key, &rem)) break;
      if (op == 1) {
        if (!ReadBlob(f, &val, &rem)) break;
        g->tables[ns][key] = val;
      } else {
        g->tables[ns].erase(key);
      }
    }
    std::fclose(f);
  }
}

bool AppendWal(GcsStore* g, uint8_t op, const char* ns, const char* key,
               const char* val, int val_len) {
  if (!g->wal) {
    g->wal = std::fopen(g->wal_path.c_str(), "ab");
    if (!g->wal) return false;
  }
  std::string nss(ns), keys(key);
  bool ok = std::fwrite(&op, 1, 1, g->wal) == 1 &&
            WriteBlob(g->wal, nss) && WriteBlob(g->wal, keys);
  if (ok && op == 1) {
    uint32_t n = static_cast<uint32_t>(val_len);
    ok = WriteU32(g->wal, n) &&
         (n == 0 || std::fwrite(val, n, 1, g->wal) == 1);
  }
  if (ok) {
    std::fflush(g->wal);
    g->wal_bytes += 9 + nss.size() + keys.size() + (op == 1 ? val_len : 0);
  }
  return ok;
}

}  // namespace

extern "C" {

// path_prefix: "<dir>/gcs_state" -> snapshot at <prefix>.snap, WAL at
// <prefix>.wal. Loads existing state on create.
void* gstore_create(const char* path_prefix) {
  auto* g = new GcsStore();
  g->snap_path = std::string(path_prefix) + ".snap";
  g->wal_path = std::string(path_prefix) + ".wal";
  LoadInto(g);
  return g;
}

void gstore_destroy(void* h) { delete static_cast<GcsStore*>(h); }

int gstore_put(void* h, const char* ns, const char* key,
               const char* val, int val_len) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  g->InvalidateScan();  // a cached iterator must not outlive mutation
  g->tables[ns][key] = std::string(val, val_len);
  return AppendWal(g, 1, ns, key, val, val_len) ? 0 : -1;
}

int gstore_del(void* h, const char* ns, const char* key) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  g->InvalidateScan();
  auto it = g->tables.find(ns);
  if (it != g->tables.end()) it->second.erase(key);
  return AppendWal(g, 2, ns, key, nullptr, 0) ? 0 : -1;
}

// Returns value length (>= 0) with up to out_len bytes copied, or -1
// if absent. Call with out_len 0 to size first.
int gstore_get(void* h, const char* ns, const char* key, char* out,
               int out_len) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  auto t = g->tables.find(ns);
  if (t == g->tables.end()) return -1;
  auto it = t->second.find(key);
  if (it == t->second.end()) return -1;
  int n = static_cast<int>(it->second.size());
  if (out != nullptr && out_len > 0)
    std::memcpy(out, it->second.data(),
                n < out_len ? n : out_len);
  return n;
}

int gstore_num_rows(void* h) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  int n = 0;
  for (const auto& [ns, t] : g->tables) n += static_cast<int>(t.size());
  return n;
}

uint64_t gstore_wal_bytes(void* h) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  return g->wal_bytes;
}

// fdatasync the WAL: every append is already fflush()ed (survives a GCS
// PROCESS crash — the kernel page cache holds it); this pushes it to
// stable storage for OS-crash/power-loss durability. Callers batch it
// (redis appendfsync-everysec semantics) rather than paying a sync per
// mutation.
int gstore_sync(void* h) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  if (!g->wal) return 0;
  if (std::fflush(g->wal) != 0) return -1;
  return fdatasync(fileno(g->wal)) == 0 ? 0 : -1;
}

// Iterate all rows of one namespace: repeatedly call with a cursor
// (start at 0); each call copies key into kout and value into vout and
// returns the value length, advancing *cursor. Returns -1 when done,
// -2 if a buffer is too small (cursor unchanged).
int gstore_scan(void* h, const char* ns, int* cursor, char* kout,
                int kout_len, char* vout, int vout_len) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  auto t = g->tables.find(ns);
  if (t == g->tables.end()) return -1;
  auto it = t->second.cbegin();
  if (g->scan_cursor == *cursor && g->scan_ns == ns) {
    it = g->scan_it;  // resume: sequential scans are O(n) total
  } else {
    std::advance(it, *cursor < static_cast<int>(t->second.size())
                         ? *cursor
                         : static_cast<int>(t->second.size()));
  }
  if (it == t->second.cend()) return -1;
  const auto& key = it->first;
  const auto& val = it->second;
  if (static_cast<int>(key.size()) + 1 > kout_len ||
      static_cast<int>(val.size()) > vout_len)
    return -2;
  std::memcpy(kout, key.data(), key.size());
  kout[key.size()] = '\0';
  if (!val.empty()) std::memcpy(vout, val.data(), val.size());
  (*cursor)++;
  g->scan_ns = ns;
  g->scan_cursor = *cursor;
  g->scan_it = std::next(it);
  return static_cast<int>(val.size());
}

// List namespaces, RS-joined into out. Returns count or -2 if small.
int gstore_namespaces(void* h, char* out, int out_len) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  int pos = 0, count = 0;
  for (const auto& [ns, t] : g->tables) {
    if (t.empty()) continue;
    int need = static_cast<int>(ns.size()) + (count ? 1 : 0);
    if (pos + need + 1 > out_len) return -2;
    if (count) out[pos++] = '\x1e';
    std::memcpy(out + pos, ns.data(), ns.size());
    pos += static_cast<int>(ns.size());
    count++;
  }
  out[pos] = '\0';
  return count;
}

// Rewrite the snapshot atomically from the in-memory tables and
// truncate the WAL. Returns 0, -1 on IO failure (state intact).
int gstore_compact(void* h) {
  auto* g = static_cast<GcsStore*>(h);
  std::lock_guard<std::mutex> lock(g->mu);
  std::string tmp = g->snap_path + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  bool ok = true;
  for (const auto& [ns, t] : g->tables)
    for (const auto& [key, val] : t)
      ok = ok && WriteBlob(f, ns) && WriteBlob(f, key) && WriteBlob(f, val);
  ok = std::fclose(f) == 0 && ok;
  if (!ok || std::rename(tmp.c_str(), g->snap_path.c_str()) != 0)
    return -1;
  if (g->wal) {
    std::fclose(g->wal);
    g->wal = nullptr;
  }
  std::remove(g->wal_path.c_str());
  g->wal_bytes = 0;
  return 0;
}

}  // extern "C"
