// gcs_service.cc — native (in-pump) GCS protocol handlers.
//
// An earlier step moved the daemons' IO plane onto the native frame pump
// (fastpath.cc); this moves the first slice of PROTOCOL LOGIC native
// too: the GCS's self-contained hot methods — the namespaced KV table
// (KVPut/KVGet/KVDel/KVKeys/KVExists) and pubsub (Subscribe/Publish +
// fanout) — execute entirely on the pump's epoll thread in C++:
// request parse, table mutation, WAL write-through, response pack,
// send.  Python never sees these frames; it keeps the complex residue
// (actor scheduling, PG 2PC, node lifecycle), mirroring how the
// reference's gcs_server dispatches InternalKVGcsService and
// InternalPubSubGcsService handlers on its C++ event loop
// (reference: src/ray/gcs/gcs_server/gcs_server.h:79,
// gcs_kv_manager.cc HandleInternalKVPut, pubsub_handler.cc).
//
// Durability contract (identical to the Python handlers'): a mutation
// hits the WAL (gcs_store.cc, fflush'd append) BEFORE the RPC reply is
// queued, so an acknowledged KVPut survives a GCS kill -9.  Row format
// is byte-compatible with the Python fallback — store key =
// hex(msgpack([ns, key])), value = msgpack(value) — so state written
// by either side restores under the other.
//
// Wiring: the service never links against fastpath/gcs_store; the
// caller passes the four entry points it needs as function pointers
// (ctypes hands over the addresses from the already-loaded libs), so
// each .so stays self-contained.
//
// Threading: gsvc_on_frame/gsvc_on_close run on the pump loop thread;
// gsvc_kv_load (restore), gsvc_fanout (Python-side internal publishes)
// and the stats getters run on Python threads — one mutex guards all
// state.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include "msgpack_lite.h"

namespace {

using mplite::View;

constexpr int kMsgRequest = 0;   // rpc.py MSG_REQUEST
constexpr int kMsgResponse = 1;  // rpc.py MSG_RESPONSE
constexpr int kMsgError = 2;     // rpc.py MSG_ERROR
constexpr int kMsgNotify = 3;    // rpc.py MSG_NOTIFY

typedef int (*SendFn)(void* pump, int64_t conn, const void* buf,
                      uint32_t len);
typedef int (*GPutFn)(void* store, const char* ns, const char* key,
                      const char* val, int val_len);
typedef int (*GDelFn)(void* store, const char* ns, const char* key);

struct GcsService {
  std::mutex mu;
  SendFn send = nullptr;
  void* pump = nullptr;
  GPutFn gput = nullptr;
  GDelFn gdel = nullptr;
  void* store = nullptr;  // may be null (no persistence configured)

  // kv: namespace -> (raw msgpack key encoding -> raw msgpack value
  // encoding).  Identity by raw encoding keeps str b"k" vs "k" distinct,
  // exactly like the Python dict the fallback handlers use.
  std::map<std::string, std::unordered_map<std::string, std::string>> kv;

  // pubsub: channel -> conn ids, plus the reverse index for close-time
  // cleanup.
  std::unordered_map<std::string, std::set<int64_t>> subs;
  std::unordered_map<int64_t, std::vector<std::string>> conn_channels;

  // Counters Python polls: handled frames (observability), WAL appends
  // (to schedule the batched fdatasync), WAL failures (disk full —
  // surfaced as a warning; the row is still served from memory),
  // protocol errors (malformed payloads answered with an error frame).
  uint64_t handled = 0;
  uint64_t wal_appends = 0;
  uint64_t wal_failures = 0;
  // Atomic: bumped by Malformed() both inside and outside mu.
  std::atomic<uint64_t> proto_errors{0};
};

const char kHexDigits[] = "0123456789abcdef";

void AppendHex(std::string& out, std::string_view raw) {
  out.reserve(out.size() + raw.size() * 2);
  for (unsigned char c : raw) {
    out.push_back(kHexDigits[c >> 4]);
    out.push_back(kHexDigits[c & 0xf]);
  }
}

// Canonicalize one str/bin key encoding: decode content + type, re-encode
// in msgpack-python's smallest form. Python's _pack_row re-packs the
// DECODED key, so any accepted wire encoding of the same logical key must
// map to the same canonical bytes — otherwise a valid-but-non-canonical
// client encoding (e.g. bin16 for a 1-byte key) yields a store row the
// Python fallback can never delete, and the row resurrects on restart.
// Returns false for non-str/bin keys (kept verbatim by the caller).
bool CanonicalKey(std::string_view key_raw, std::string* out) {
  if (key_raw.empty()) return false;
  View v{(const uint8_t*)key_raw.data(), key_raw.size(), 0};
  uint8_t tag = (uint8_t)key_raw[0];
  bool is_str = (tag & 0xe0) == 0xa0 || tag == 0xd9 || tag == 0xda ||
                tag == 0xdb;
  std::string_view content;
  if (!mplite::read_strbin(v, &content) || v.off != key_raw.size())
    return false;
  out->clear();
  if (is_str) mplite::w_str(*out, content);
  else mplite::w_bin(*out, content);
  return true;
}

// Store key for one kv row: hex(msgpack([ns, key])) — must byte-match
// rpc.pack([ns, k]).hex() in gcs.py _pack_row for the same logical key.
// `key_raw` is canonical by the time it gets here (gsvc_on_frame
// canonicalizes the parsed key before any table/WAL use).
std::string RowKeyHex(std::string_view ns, std::string_view key_raw) {
  std::string packed;
  mplite::w_array(packed, 2);
  mplite::w_str(packed, ns);
  mplite::w_raw(packed, key_raw);
  std::string hex;
  AppendHex(hex, packed);
  return hex;
}

void WalPut(GcsService* s, std::string_view ns, std::string_view key_raw,
            std::string_view val_raw) {
  if (!s->store) return;
  std::string key_hex = RowKeyHex(ns, key_raw);
  if (s->gput(s->store, "kv", key_hex.c_str(), val_raw.data(),
              (int)val_raw.size()) == 0) {
    s->wal_appends++;
  } else {
    s->wal_failures++;
  }
}

void WalDel(GcsService* s, std::string_view ns, std::string_view key_raw) {
  if (!s->store) return;
  std::string key_hex = RowKeyHex(ns, key_raw);
  if (s->gdel(s->store, "kv", key_hex.c_str()) == 0) {
    s->wal_appends++;
  } else {
    s->wal_failures++;
  }
}

void SendResponse(GcsService* s, int64_t conn_id, int64_t seq,
                  std::string_view method, const std::string& result) {
  std::string out;
  out.reserve(result.size() + method.size() + 16);
  mplite::w_array(out, 4);
  mplite::w_int(out, kMsgResponse);
  mplite::w_int(out, seq);
  mplite::w_str(out, method);
  mplite::w_raw(out, result);
  s->send(s->pump, conn_id, out.data(), (uint32_t)out.size());
}

// Fan one already-packed notify frame out to a channel's subscribers.
// Conns whose send fails (gone / backlogged past the cap) are dropped
// from the channel — the Python fallback does the same on notify
// failure.  Caller holds s->mu.
int FanoutLocked(GcsService* s, const std::string& channel,
                 const void* frame, uint32_t len) {
  auto it = s->subs.find(channel);
  if (it == s->subs.end()) return 0;
  int sent = 0;
  std::vector<int64_t> dead;
  for (int64_t cid : it->second) {
    if (s->send(s->pump, cid, frame, len) == 0) sent++;
    else dead.push_back(cid);
  }
  for (int64_t cid : dead) it->second.erase(cid);
  return sent;
}

// ---- payload field cursors ----
// Payloads are small maps with str keys; each handler scans once and
// captures the raw slices it needs.

struct Fields {
  std::string_view ns;          // "ns" (str), default ""
  std::string_view key_raw;     // "key" raw encoding
  bool have_key = false;
  std::string_view value_raw;   // "value" raw encoding
  bool have_value = false;
  bool overwrite = true;        // "overwrite"
  std::string_view prefix;      // "prefix" content bytes
  std::string_view channel;     // "channel" (str)
  bool have_channel = false;
  std::string_view message_raw; // "message" raw encoding
  bool have_message = false;
  std::vector<std::string_view> channels;  // "channels" (list of str)
  bool have_channels = false;
};

bool ParsePayload(View& v, Fields* f) {
  if (mplite::try_read_nil(v)) return true;  // payload=None
  uint32_t n;
  if (!mplite::read_map(v, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view k;
    if (!mplite::read_str(v, &k)) return false;
    if (k == "ns") {
      if (!mplite::read_str(v, &f->ns)) return false;
    } else if (k == "key") {
      if (!mplite::read_raw(v, &f->key_raw)) return false;
      f->have_key = true;
    } else if (k == "value") {
      if (!mplite::read_raw(v, &f->value_raw)) return false;
      f->have_value = true;
    } else if (k == "overwrite") {
      if (!mplite::read_bool(v, &f->overwrite)) return false;
    } else if (k == "prefix") {
      if (!mplite::read_strbin(v, &f->prefix)) return false;
    } else if (k == "channel") {
      if (!mplite::read_str(v, &f->channel)) return false;
      f->have_channel = true;
    } else if (k == "message") {
      if (!mplite::read_raw(v, &f->message_raw)) return false;
      f->have_message = true;
    } else if (k == "channels") {
      uint32_t cn;
      if (!mplite::read_array(v, &cn)) return false;
      f->have_channels = true;
      for (uint32_t j = 0; j < cn; j++) {
        std::string_view ch;
        if (!mplite::read_str(v, &ch)) return false;
        f->channels.push_back(ch);
      }
    } else {
      if (!mplite::skip(v)) return false;
    }
  }
  return true;
}

// ---- result builders ----

std::string MapBool(std::string_view key, bool val) {
  std::string r;
  mplite::w_map(r, 1);
  mplite::w_str(r, key);
  mplite::w_bool(r, val);
  return r;
}

// A malformed payload for a method the native service OWNS must be
// answered with an error frame, not passed to Python — the Python
// handlers would answer it from their (empty) tables and silently
// diverge from the native store.
int Malformed(GcsService* s, int64_t conn_id, int64_t msg_type, int64_t seq,
              std::string_view method) {
  s->proto_errors.fetch_add(1, std::memory_order_relaxed);
  if (msg_type == kMsgRequest) {
    std::string out;
    mplite::w_array(out, 4);
    mplite::w_int(out, kMsgError);
    mplite::w_int(out, seq);
    mplite::w_str(out, method);
    std::string msg = "native GCS service: malformed payload for ";
    msg.append(method);
    mplite::w_str(out, msg);
    s->send(s->pump, conn_id, out.data(), (uint32_t)out.size());
  }
  return 1;
}

}  // namespace

extern "C" {

void* gsvc_create(void* send_fn, void* pump, void* gput_fn, void* gdel_fn,
                  void* store) {
  auto* s = new GcsService();
  s->send = (SendFn)send_fn;
  s->pump = pump;
  s->gput = (GPutFn)gput_fn;
  s->gdel = (GDelFn)gdel_fn;
  s->store = store;
  return s;
}

void gsvc_destroy(void* h) { delete static_cast<GcsService*>(h); }

// Restore one kv row (restart path): key_raw/val_raw are the raw
// msgpack encodings (Python re-packs the decoded key; the store blob is
// already the packed value).
void gsvc_kv_load(void* h, const char* ns, int ns_len, const void* key_raw,
                  int key_len, const void* val_raw, int val_len) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->kv[std::string(ns, ns_len)][std::string((const char*)key_raw, key_len)] =
      std::string((const char*)val_raw, val_len);
}

// Internal publish from Python (actor/PG/node state changes, log
// batches): one ctypes call, N native sends.  `frame` is the complete
// packed notify envelope; returns the number of subscribers reached.
int gsvc_fanout(void* h, const char* channel, int ch_len, const void* frame,
                uint32_t len) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return FanoutLocked(s, std::string(channel, ch_len), frame, len);
}

// Subscriber count for one channel (lets Python skip packing the notify
// frame entirely when nobody listens — the common case for LOGS).
int gsvc_sub_count(void* h, const char* channel, int ch_len) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->subs.find(std::string(channel, ch_len));
  return it == s->subs.end() ? 0 : (int)it->second.size();
}

void gsvc_kv_stats(void* h, int64_t* n_ns, int64_t* n_rows) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *n_ns = (int64_t)s->kv.size();
  int64_t rows = 0;
  for (const auto& [ns, t] : s->kv) rows += (int64_t)t.size();
  *n_rows = rows;
}

void gsvc_counters(void* h, uint64_t* handled, uint64_t* wal_appends,
                   uint64_t* wal_failures) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *handled = s->handled;
  *wal_appends = s->wal_appends;
  *wal_failures = s->wal_failures;
}

uint64_t gsvc_proto_errors(void* h) {
  auto* s = static_cast<GcsService*>(h);
  return s->proto_errors.load(std::memory_order_relaxed);
}

void gsvc_on_close(void* h, int64_t conn_id) {
  auto* s = static_cast<GcsService*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->conn_channels.find(conn_id);
  if (it == s->conn_channels.end()) return;
  for (const std::string& ch : it->second) {
    auto sit = s->subs.find(ch);
    if (sit != s->subs.end()) sit->second.erase(conn_id);
  }
  s->conn_channels.erase(it);
}

// The pump's in-loop frame hook.  Returns 1 when the frame was handled
// natively (response already queued), 0 to pass it to Python.
int gsvc_on_frame(void* h, int64_t conn_id, const char* data, uint32_t len) {
  auto* s = static_cast<GcsService*>(h);
  View v{(const uint8_t*)data, len, 0};
  uint32_t alen;
  int64_t msg_type, seq;
  std::string_view method;
  if (!mplite::read_array(v, &alen) || alen != 4 ||
      !mplite::read_int(v, &msg_type) || !mplite::read_int(v, &seq) ||
      !mplite::read_str(v, &method))
    return 0;
  if (msg_type != kMsgRequest && msg_type != kMsgNotify) return 0;

  // Method gate before payload parse: unknown methods cost one header
  // decode, nothing more.
  enum Op { KV_PUT, KV_GET, KV_DEL, KV_KEYS, KV_EXISTS, SUB, PUB } op;
  if (method == "KVPut") op = KV_PUT;
  else if (method == "KVGet") op = KV_GET;
  else if (method == "KVDel") op = KV_DEL;
  else if (method == "KVKeys") op = KV_KEYS;
  else if (method == "KVExists") op = KV_EXISTS;
  else if (method == "Subscribe") op = SUB;
  else if (method == "Publish") op = PUB;
  else return 0;

  Fields f;
  if (!ParsePayload(v, &f))
    return Malformed(s, conn_id, msg_type, seq, method);

  // Key identity is the CANONICAL encoding: msgpack-python clients
  // always send smallest-form, but any accepted non-canonical encoding
  // of the same logical key must hit the same table slot and the same
  // store row as the canonical one (and as Python's re-packed row key).
  std::string canon_key;
  if (f.have_key && CanonicalKey(f.key_raw, &canon_key))
    f.key_raw = canon_key;

  std::string result;
  std::lock_guard<std::mutex> lock(s->mu);
  switch (op) {
    case KV_PUT: {
      if (!f.have_key || !f.have_value)
        return Malformed(s, conn_id, msg_type, seq, method);
      auto& table = s->kv[std::string(f.ns)];
      std::string key(f.key_raw);
      auto existing = table.find(key);
      if (!f.overwrite && existing != table.end()) {
        result = MapBool("added", false);
        break;
      }
      if (existing != table.end() && existing->second == f.value_raw) {
        // Idempotent re-put: same reply, no WAL append (matches the
        // Python write-through's hash-diff dedup).
        result = MapBool("added", true);
        break;
      }
      table[key] = std::string(f.value_raw);
      WalPut(s, f.ns, f.key_raw, f.value_raw);  // before the reply
      result = MapBool("added", true);
      break;
    }
    case KV_GET: {
      if (!f.have_key)
        return Malformed(s, conn_id, msg_type, seq, method);
      mplite::w_map(result, 1);
      mplite::w_str(result, "value");
      auto nsit = s->kv.find(std::string(f.ns));
      const std::string* val = nullptr;
      if (nsit != s->kv.end()) {
        auto it = nsit->second.find(std::string(f.key_raw));
        if (it != nsit->second.end()) val = &it->second;
      }
      if (val) mplite::w_raw(result, *val);
      else mplite::w_nil(result);
      break;
    }
    case KV_DEL: {
      if (!f.have_key)
        return Malformed(s, conn_id, msg_type, seq, method);
      bool existed = false;
      auto nsit = s->kv.find(std::string(f.ns));
      if (nsit != s->kv.end())
        existed = nsit->second.erase(std::string(f.key_raw)) > 0;
      if (existed) WalDel(s, f.ns, f.key_raw);
      result = MapBool("deleted", existed);
      break;
    }
    case KV_KEYS: {
      // Prefix-match on CONTENT bytes (str or bin keys), return the raw
      // encodings — unpack gives the caller back exactly what they put.
      std::vector<std::string_view> keys;
      auto nsit = s->kv.find(std::string(f.ns));
      if (nsit != s->kv.end()) {
        for (const auto& [key_raw, val] : nsit->second) {
          View kv_view{(const uint8_t*)key_raw.data(), key_raw.size(), 0};
          std::string_view content;
          if (!mplite::read_strbin(kv_view, &content)) continue;
          if (content.size() >= f.prefix.size() &&
              memcmp(content.data(), f.prefix.data(), f.prefix.size()) == 0)
            keys.push_back(key_raw);
        }
      }
      mplite::w_map(result, 1);
      mplite::w_str(result, "keys");
      mplite::w_array(result, (uint32_t)keys.size());
      for (auto k : keys) mplite::w_raw(result, k);
      break;
    }
    case KV_EXISTS: {
      if (!f.have_key)
        return Malformed(s, conn_id, msg_type, seq, method);
      auto nsit = s->kv.find(std::string(f.ns));
      bool exists = nsit != s->kv.end() &&
                    nsit->second.count(std::string(f.key_raw)) > 0;
      result = MapBool("exists", exists);
      break;
    }
    case SUB: {
      // Python parity: handle_subscribe KeyErrors on a missing
      // "channels" field (an empty list is fine).
      if (!f.have_channels)
        return Malformed(s, conn_id, msg_type, seq, method);
      for (auto ch : f.channels) {
        std::string chs(ch);
        if (s->subs[chs].insert(conn_id).second)
          s->conn_channels[conn_id].push_back(chs);
      }
      result = MapBool("ok", true);
      break;
    }
    case PUB: {
      // Python parity: handle_publish KeyErrors on a missing "channel"
      // OR "message" — a Publish without a channel must NOT fan out to
      // channel "" and report ok.
      if (!f.have_channel || !f.have_message)
        return Malformed(s, conn_id, msg_type, seq, method);
      // Re-wrap as the notify frame every subscriber expects:
      // [MSG_NOTIFY, 0, "Publish", {"channel": ch, "message": raw}].
      std::string frame;
      frame.reserve(f.message_raw.size() + f.channel.size() + 40);
      mplite::w_array(frame, 4);
      mplite::w_int(frame, kMsgNotify);
      mplite::w_int(frame, 0);
      mplite::w_str(frame, "Publish");
      mplite::w_map(frame, 2);
      mplite::w_str(frame, "channel");
      mplite::w_str(frame, f.channel);
      mplite::w_str(frame, "message");
      if (f.have_message) mplite::w_raw(frame, f.message_raw);
      else mplite::w_nil(frame);
      FanoutLocked(s, std::string(f.channel), frame.data(),
                   (uint32_t)frame.size());
      result = MapBool("ok", true);
      break;
    }
  }
  s->handled++;
  if (msg_type == kMsgRequest)
    SendResponse(s, conn_id, seq, method, result);
  return 1;
}

}  // extern "C"
