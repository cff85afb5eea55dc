// msgpack_lite.h — minimal msgpack codec for the native daemon services.
//
// The framework's wire protocol is msgpack end-to-end (rpc.py pack/unpack:
// msgpack.packb(use_bin_type=True) / unpackb(raw=False)).  The native
// in-pump services (gcs_service.cc) parse request envelopes and emit
// responses without crossing into Python, so they need a codec that is
// BYTE-COMPATIBLE with what msgpack-python produces for the subset the
// protocol uses: nil/bool/int/float64/str/bin/array/map (+ skip-through
// for ext types).  The encoder mirrors msgpack-python's smallest-form
// choices exactly — persistence row keys are hex(packed bytes), so a row
// written by the native service must hash/byte-match one written by the
// Python fallback for the same logical key.
//
// Reference analog: the reference's daemons parse protobuf in C++ on
// their gRPC event loops (src/ray/rpc/grpc_server.h); this is the
// msgpack equivalent for the tpu-native wire.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>

namespace mplite {

// ---------- decoder ----------
// A view with an offset; every read advances `off` on success and
// returns false (leaving the view usable for error paths) on type
// mismatch or truncation.

struct View {
  const uint8_t* p = nullptr;
  size_t n = 0;
  size_t off = 0;

  bool has(size_t k) const { return n - off >= k; }
  uint8_t peek() const { return p[off]; }
  uint16_t be16(size_t at) const {
    return (uint16_t)((p[at] << 8) | p[at + 1]);
  }
  uint32_t be32(size_t at) const {
    return ((uint32_t)p[at] << 24) | ((uint32_t)p[at + 1] << 16) |
           ((uint32_t)p[at + 2] << 8) | (uint32_t)p[at + 3];
  }
  uint64_t be64(size_t at) const {
    return ((uint64_t)be32(at) << 32) | be32(at + 4);
  }
};

inline bool read_uint_head(View& v, uint8_t tag, uint64_t* out) {
  switch (tag) {
    case 0xcc:
      if (!v.has(1)) return false;
      *out = v.p[v.off];
      v.off += 1;
      return true;
    case 0xcd:
      if (!v.has(2)) return false;
      *out = v.be16(v.off);
      v.off += 2;
      return true;
    case 0xce:
      if (!v.has(4)) return false;
      *out = v.be32(v.off);
      v.off += 4;
      return true;
    case 0xcf:
      if (!v.has(8)) return false;
      *out = v.be64(v.off);
      v.off += 8;
      return true;
  }
  return false;
}

inline bool read_int(View& v, int64_t* out) {
  if (!v.has(1)) return false;
  uint8_t t = v.p[v.off];
  if (t <= 0x7f) {  // positive fixint
    *out = t;
    v.off += 1;
    return true;
  }
  if (t >= 0xe0) {  // negative fixint
    *out = (int8_t)t;
    v.off += 1;
    return true;
  }
  v.off += 1;
  uint64_t u;
  if (read_uint_head(v, t, &u)) {
    *out = (int64_t)u;
    return true;
  }
  switch (t) {
    case 0xd0:
      if (!v.has(1)) return false;
      *out = (int8_t)v.p[v.off];
      v.off += 1;
      return true;
    case 0xd1:
      if (!v.has(2)) return false;
      *out = (int16_t)v.be16(v.off);
      v.off += 2;
      return true;
    case 0xd2:
      if (!v.has(4)) return false;
      *out = (int32_t)v.be32(v.off);
      v.off += 4;
      return true;
    case 0xd3:
      if (!v.has(8)) return false;
      *out = (int64_t)v.be64(v.off);
      v.off += 8;
      return true;
  }
  v.off -= 1;
  return false;
}

inline bool read_bool(View& v, bool* out) {
  if (!v.has(1)) return false;
  if (v.p[v.off] == 0xc2) *out = false;
  else if (v.p[v.off] == 0xc3) *out = true;
  else return false;
  v.off += 1;
  return true;
}

inline bool try_read_nil(View& v) {
  if (v.has(1) && v.p[v.off] == 0xc0) {
    v.off += 1;
    return true;
  }
  return false;
}

// str OR bin content (KV keys arrive as bin from internal_kv, but user
// code may use str keys — identity is the raw encoding, content is the
// byte payload).
inline bool read_strbin(View& v, std::string_view* out) {
  if (!v.has(1)) return false;
  uint8_t t = v.p[v.off];
  size_t len, hdr;
  if ((t & 0xe0) == 0xa0) {
    len = t & 0x1f;
    hdr = 1;
  } else if (t == 0xd9 || t == 0xc4) {
    if (!v.has(2)) return false;
    len = v.p[v.off + 1];
    hdr = 2;
  } else if (t == 0xda || t == 0xc5) {
    if (!v.has(3)) return false;
    len = v.be16(v.off + 1);
    hdr = 3;
  } else if (t == 0xdb || t == 0xc6) {
    if (!v.has(5)) return false;
    len = v.be32(v.off + 1);
    hdr = 5;
  } else {
    return false;
  }
  if (!v.has(hdr + len)) return false;
  *out = std::string_view((const char*)v.p + v.off + hdr, len);
  v.off += hdr + len;
  return true;
}

inline bool read_str(View& v, std::string_view* out) {
  if (!v.has(1)) return false;
  uint8_t t = v.p[v.off];
  if (!((t & 0xe0) == 0xa0 || t == 0xd9 || t == 0xda || t == 0xdb))
    return false;
  return read_strbin(v, out);
}

inline bool read_array(View& v, uint32_t* len) {
  if (!v.has(1)) return false;
  uint8_t t = v.p[v.off];
  if ((t & 0xf0) == 0x90) {
    *len = t & 0x0f;
    v.off += 1;
    return true;
  }
  if (t == 0xdc) {
    if (!v.has(3)) return false;
    *len = v.be16(v.off + 1);
    v.off += 3;
    return true;
  }
  if (t == 0xdd) {
    if (!v.has(5)) return false;
    *len = v.be32(v.off + 1);
    v.off += 5;
    return true;
  }
  return false;
}

inline bool read_map(View& v, uint32_t* len) {
  if (!v.has(1)) return false;
  uint8_t t = v.p[v.off];
  if ((t & 0xf0) == 0x80) {
    *len = t & 0x0f;
    v.off += 1;
    return true;
  }
  if (t == 0xde) {
    if (!v.has(3)) return false;
    *len = v.be16(v.off + 1);
    v.off += 3;
    return true;
  }
  if (t == 0xdf) {
    if (!v.has(5)) return false;
    *len = v.be32(v.off + 1);
    v.off += 5;
    return true;
  }
  return false;
}

// Skip one value of any type (bounded recursion on containers).
inline bool skip(View& v, int depth = 0) {
  if (depth > 64 || !v.has(1)) return false;
  uint8_t t = v.p[v.off];
  // int / bool / nil
  int64_t i;
  bool b;
  if (t <= 0x7f || t >= 0xe0 || (t >= 0xcc && t <= 0xd3))
    return read_int(v, &i);
  if (t == 0xc2 || t == 0xc3) return read_bool(v, &b);
  if (t == 0xc0) return try_read_nil(v);
  std::string_view sv;
  if ((t & 0xe0) == 0xa0 || t == 0xd9 || t == 0xda || t == 0xdb ||
      t == 0xc4 || t == 0xc5 || t == 0xc6)
    return read_strbin(v, &sv);
  if (t == 0xca) {  // float32
    if (!v.has(5)) return false;
    v.off += 5;
    return true;
  }
  if (t == 0xcb) {  // float64
    if (!v.has(9)) return false;
    v.off += 9;
    return true;
  }
  uint32_t len;
  if ((t & 0xf0) == 0x90 || t == 0xdc || t == 0xdd) {
    if (!read_array(v, &len)) return false;
    for (uint32_t k = 0; k < len; k++)
      if (!skip(v, depth + 1)) return false;
    return true;
  }
  if ((t & 0xf0) == 0x80 || t == 0xde || t == 0xdf) {
    if (!read_map(v, &len)) return false;
    for (uint32_t k = 0; k < 2 * len; k++)
      if (!skip(v, depth + 1)) return false;
    return true;
  }
  // ext types: fixext1/2/4/8/16, ext8/16/32
  if (t >= 0xd4 && t <= 0xd8) {
    size_t n = 2 + ((size_t)1 << (t - 0xd4));
    if (!v.has(n)) return false;
    v.off += n;
    return true;
  }
  if (t == 0xc7) {
    if (!v.has(3)) return false;
    size_t n = 3 + v.p[v.off + 1];
    if (!v.has(n)) return false;
    v.off += n;
    return true;
  }
  if (t == 0xc8) {
    if (!v.has(4)) return false;
    size_t n = 4 + v.be16(v.off + 1);
    if (!v.has(n)) return false;
    v.off += n;
    return true;
  }
  if (t == 0xc9) {
    if (!v.has(6)) return false;
    size_t n = 6 + v.be32(v.off + 1);
    if (!v.has(n)) return false;
    v.off += n;
    return true;
  }
  return false;
}

// Capture one value's raw encoded bytes (for verbatim re-embedding:
// KV values, pubsub messages — the service never needs their
// structure, only their extent).
inline bool read_raw(View& v, std::string_view* out) {
  size_t start = v.off;
  if (!skip(v)) return false;
  *out = std::string_view((const char*)v.p + start, v.off - start);
  return true;
}

// ---------- encoder ----------
// Appends to a std::string; forms match msgpack-python's packb.

inline void w_be16(std::string& o, uint16_t x) {
  o.push_back((char)(x >> 8));
  o.push_back((char)x);
}
inline void w_be32(std::string& o, uint32_t x) {
  o.push_back((char)(x >> 24));
  o.push_back((char)(x >> 16));
  o.push_back((char)(x >> 8));
  o.push_back((char)x);
}
inline void w_be64(std::string& o, uint64_t x) {
  w_be32(o, (uint32_t)(x >> 32));
  w_be32(o, (uint32_t)x);
}

inline void w_nil(std::string& o) { o.push_back((char)0xc0); }
inline void w_bool(std::string& o, bool b) {
  o.push_back((char)(b ? 0xc3 : 0xc2));
}

inline void w_int(std::string& o, int64_t v) {
  if (v >= 0) {
    if (v <= 0x7f) {
      o.push_back((char)v);
    } else if (v <= 0xff) {
      o.push_back((char)0xcc);
      o.push_back((char)v);
    } else if (v <= 0xffff) {
      o.push_back((char)0xcd);
      w_be16(o, (uint16_t)v);
    } else if (v <= 0xffffffffLL) {
      o.push_back((char)0xce);
      w_be32(o, (uint32_t)v);
    } else {
      o.push_back((char)0xcf);
      w_be64(o, (uint64_t)v);
    }
  } else {
    if (v >= -32) {
      o.push_back((char)(uint8_t)v);
    } else if (v >= -128) {
      o.push_back((char)0xd0);
      o.push_back((char)(uint8_t)v);
    } else if (v >= -32768) {
      o.push_back((char)0xd1);
      w_be16(o, (uint16_t)v);
    } else if (v >= -2147483648LL) {
      o.push_back((char)0xd2);
      w_be32(o, (uint32_t)v);
    } else {
      o.push_back((char)0xd3);
      w_be64(o, (uint64_t)v);
    }
  }
}

inline void w_str(std::string& o, std::string_view s) {
  size_t n = s.size();
  if (n <= 31) {
    o.push_back((char)(0xa0 | n));
  } else if (n <= 0xff) {
    o.push_back((char)0xd9);
    o.push_back((char)n);
  } else if (n <= 0xffff) {
    o.push_back((char)0xda);
    w_be16(o, (uint16_t)n);
  } else {
    o.push_back((char)0xdb);
    w_be32(o, (uint32_t)n);
  }
  o.append(s.data(), n);
}

inline void w_bin(std::string& o, std::string_view s) {
  size_t n = s.size();
  if (n <= 0xff) {
    o.push_back((char)0xc4);
    o.push_back((char)n);
  } else if (n <= 0xffff) {
    o.push_back((char)0xc5);
    w_be16(o, (uint16_t)n);
  } else {
    o.push_back((char)0xc6);
    w_be32(o, (uint32_t)n);
  }
  o.append(s.data(), n);
}

inline void w_array(std::string& o, uint32_t n) {
  if (n <= 15) {
    o.push_back((char)(0x90 | n));
  } else if (n <= 0xffff) {
    o.push_back((char)0xdc);
    w_be16(o, (uint16_t)n);
  } else {
    o.push_back((char)0xdd);
    w_be32(o, n);
  }
}

inline void w_map(std::string& o, uint32_t n) {
  if (n <= 15) {
    o.push_back((char)(0x80 | n));
  } else if (n <= 0xffff) {
    o.push_back((char)0xde);
    w_be16(o, (uint16_t)n);
  } else {
    o.push_back((char)0xdf);
    w_be32(o, n);
  }
}

inline void w_raw(std::string& o, std::string_view s) {
  o.append(s.data(), s.size());
}

}  // namespace mplite
