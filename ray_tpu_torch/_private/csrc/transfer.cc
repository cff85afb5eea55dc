// Native object-transfer plane: serves and fetches bulk objects directly
// between shared-memory stores over TCP, bypassing the Python daemons for
// data bytes (reference: src/ray/object_manager/ push/pull streaming over
// the ObjectManager gRPC service — here the framing is a fixed header and
// the payload is written straight from/into the shm arena).
//
// Wire protocol v2 — CHUNKED (one connection serves many sequential
// chunk requests; header u64s big-endian):
//   request : 20-byte object id | u64 offset | u64 max_len
//   response: u64 total_size | u64 meta_size | u64 chunk_len | chunk bytes
//             total_size == UINT64_MAX => object not found
// Chunking (8 MiB, reference: object_manager_default_chunk_size
// ray_config_def.h:355) enables (a) PARALLEL stripes: big objects pull
// over several connections — and several PEERS — at once
// (reference: pull_manager.h:52 / push_manager.h:30 chunk pipelining),
// and (b) pull ADMISSION CONTROL: a global in-flight byte budget bounds
// memory pressure from concurrent pulls (reference: pull admission).
//
// C ABI (ctypes from ray_tpu_torch/_private/raylet.py):
//   void* transfer_server_start(const char* store_path, int* out_port)
//   void  transfer_server_stop(void* h)
//   int   transfer_fetch(const char* store_path, const char* host, int port,
//                        const uint8_t* id)   // 0 ok, <0 error
//   int   transfer_fetch_multi(const char* store_path,
//                              const char* peers_csv,  // "host:port,..."
//                              const uint8_t* id)
//
// Builds into libtorchtransfer.so together with object_store.cc (the store
// ABI below), each process attaching its own mapping of the arena.

#include <arpa/inet.h>
#include <endian.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

// Store ABI (object_store.cc, linked into this .so).
extern "C" {
void* store_attach(const char* path);
void store_detach(void* handle);
void* store_base(void* handle);
int store_create(void* handle, const uint8_t* id, uint64_t data_size,
                 uint64_t meta_size, uint64_t* out_offset);
int store_seal(void* handle, const uint8_t* id);
int store_get(void* handle, const uint8_t* id, uint64_t* out_offset,
              uint64_t* out_size, uint64_t* out_meta_size);
int store_release(void* handle, const uint8_t* id);
int store_contains(void* handle, const uint8_t* id);
int store_abort(void* handle, const uint8_t* id);
}

namespace {

constexpr int kIdSize = 20;
constexpr uint64_t kNotFound = UINT64_MAX;
constexpr uint64_t kChunkSize = 8ull << 20;  // 8 MiB stripes
// Objects above this fan out over parallel connections.
constexpr uint64_t kParallelThreshold = 32ull << 20;
constexpr int kMaxStripes = 4;

// ---- pull admission control (reference: pull_manager.h:52) ----
// Bounds total bytes being pulled into this process's store at once; a
// single object larger than the budget is admitted alone.
constexpr uint64_t kAdmissionBudget = 256ull << 20;
std::mutex g_adm_mu;
std::condition_variable g_adm_cv;
uint64_t g_adm_inflight = 0;

struct Admission {
  uint64_t n;
  explicit Admission(uint64_t bytes) : n(bytes) {
    std::unique_lock<std::mutex> g(g_adm_mu);
    g_adm_cv.wait(g, [this] {
      return g_adm_inflight == 0 || g_adm_inflight + n <= kAdmissionBudget;
    });
    g_adm_inflight += n;
  }
  ~Admission() {
    {
      std::lock_guard<std::mutex> g(g_adm_mu);
      g_adm_inflight -= n;
    }
    g_adm_cv.notify_all();
  }
};

bool send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Server {
  void* store = nullptr;
  int listen_fd = -1;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  // Per-connection threads run DETACHED; shutdown shuts their sockets
  // down and waits for the live count to reach zero (joining blocked
  // threads would hang forever on silently-dead peers, and keeping
  // joinable thread objects around would leak a stack per connection).
  // The drain is a plain atomic poll, not a condition variable: the
  // exiting thread's LAST touch of this object must be a single
  // release-store so the stopper's acquire-load of zero proves nothing
  // still dereferences srv — a cv would put the notify (and libstdc++'s
  // timed wait goes through pthread_cond_clockwait, which TSan does not
  // model) between that point and thread exit.
  std::mutex conns_mu;
  std::set<int> conn_fds;
  std::atomic<int> live_conns{0};

  // Returns true when every connection thread has exited — only then is
  // it safe to free this object (a timed-out wait means wedged detached
  // threads still hold pointers into it; the caller must LEAK it).
  bool shutdown_and_drain() {
    stop.store(true);
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
    }
    if (accept_thread.joinable()) accept_thread.join();
    // Only after the join: the accept loop reads listen_fd concurrently.
    listen_fd = -1;
    {
      std::lock_guard<std::mutex> g(conns_mu);
      for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
    }
    for (int waited_ms = 0; waited_ms < 5000; waited_ms += 10) {
      if (live_conns.load(std::memory_order_acquire) == 0) return true;
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
    return live_conns.load(std::memory_order_acquire) == 0;
  }

  ~Server() {
    if (listen_fd >= 0) ::close(listen_fd);  // failed-start path
    if (store) store_detach(store);
  }
};

void tune_socket(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Large buffers: bulk streams on busy/single-core hosts otherwise spend
  // their time context-switching between the two copy loops.
  int buf = 4 << 20;
  ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
  // A silently-dead peer (partition, power loss — no RST) must not pin a
  // thread forever: recv/send give up after this long between bytes.
  struct timeval tv {60, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void serve_conn(Server* srv, int fd) {
  tune_socket(fd);
  uint8_t req[kIdSize + 16];
  while (!srv->stop.load() && recv_all(fd, req, sizeof(req))) {
    uint64_t want_off, want_len;
    std::memcpy(&want_off, req + kIdSize, 8);
    std::memcpy(&want_len, req + kIdSize + 8, 8);
    want_off = be64toh(want_off);
    want_len = be64toh(want_len);
    uint64_t off = 0, size = 0, meta = 0;
    int rc = store_get(srv->store, req, &off, &size, &meta);
    if (rc != 0) {
      // Header u64s go big-endian on the wire (like the RPC frame
      // length) so mixed-endian peers can't misread sizes.
      uint64_t hdr[3] = {htobe64(kNotFound), 0, 0};
      if (!send_all(fd, hdr, sizeof(hdr))) break;
      continue;
    }
    uint64_t clen = 0;
    if (want_off < size) {
      clen = size - want_off;
      if (clen > want_len) clen = want_len;
    }
    uint64_t hdr[3] = {htobe64(size), htobe64(meta), htobe64(clen)};
    bool ok = send_all(fd, hdr, sizeof(hdr)) &&
              (clen == 0 ||
               send_all(fd, static_cast<uint8_t*>(store_base(srv->store)) +
                                off + want_off,
                        clen));
    store_release(srv->store, req);
    if (!ok) break;
  }
  {
    // Erase BEFORE close: once closed, the fd number can be reused by a
    // concurrent accept, and the stopper's shutdown loop must never hit
    // a stranger's socket.
    std::lock_guard<std::mutex> g(srv->conns_mu);
    srv->conn_fds.erase(fd);
  }
  ::close(fd);
  // Release-store LAST: after this the stopper may free *srv.
  srv->live_conns.fetch_sub(1, std::memory_order_release);
}

// Fetch-side attach cache: one mapping per store path per process.
// Heap-allocated and never destroyed: a static map's exit-time destructor
// would free the nodes while orphaning the Store/PeerConn objects they
// point to (LeakSanitizer flags exactly that).
std::mutex g_attach_mu;
std::map<std::string, void*>& attach_cache() {
  static auto* m = new std::map<std::string, void*>();
  return *m;
}

void* attached_store(const char* path) {
  std::lock_guard<std::mutex> g(g_attach_mu);
  auto& cache = attach_cache();
  auto it = cache.find(path);
  if (it != cache.end()) return it->second;
  void* h = store_attach(path);
  if (h) cache[path] = h;
  return h;
}

int connect_to(const char* host, int port, int timeout_ms = 10000) {
  struct addrinfo hints {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (::getaddrinfo(host, port_s.c_str(), &hints, &res) != 0) return -1;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family,
                  ai->ai_socktype | SOCK_NONBLOCK, ai->ai_protocol);
    if (fd < 0) continue;
    int rc = ::connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc != 0 && errno == EINPROGRESS) {
      struct pollfd pfd {fd, POLLOUT, 0};
      int err = 0;
      socklen_t elen = sizeof(err);
      if (::poll(&pfd, 1, timeout_ms) == 1 &&
          ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) == 0 &&
          err == 0) {
        rc = 0;
      }
    }
    if (rc == 0) {
      // Back to blocking; per-op limits come from SO_RCV/SNDTIMEO.
      int flags = ::fcntl(fd, F_GETFL, 0);
      ::fcntl(fd, F_SETFL, flags & ~O_NONBLOCK);
      break;
    }
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd >= 0) tune_socket(fd);
  return fd;
}

}  // namespace

extern "C" {

void* transfer_server_start(const char* store_path, int* out_port) {
  Server* srv = new Server();
  srv->store = store_attach(store_path);
  if (!srv->store) {
    delete srv;
    return nullptr;
  }
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr {};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = 0;  // ephemeral
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(srv->listen_fd, 64) != 0) {
    delete srv;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  *out_port = ntohs(addr.sin_port);

  srv->accept_thread = std::thread([srv] {
    while (!srv->stop.load()) {
      int fd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (srv->stop.load()) return;
        // Persistent errors (EMFILE under fd pressure) must not busy-spin.
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
        continue;
      }
      {
        std::lock_guard<std::mutex> g(srv->conns_mu);
        srv->conn_fds.insert(fd);
      }
      srv->live_conns.fetch_add(1, std::memory_order_relaxed);
      std::thread(serve_conn, srv, fd).detach();
    }
  });
  return srv;
}

void transfer_server_stop(void* h) {
  Server* srv = reinterpret_cast<Server*>(h);
  if (srv->shutdown_and_drain()) {
    delete srv;
  }
  // else: a wedged connection thread still references srv — leaking one
  // Server beats a use-after-free in its lock/cv/store.
}

// Fetch-side connection cache: one persistent connection per peer (the
// wire protocol serves many sequential requests; reconnecting per object
// would pay connect latency on every pull). Guarded by one mutex — pulls
// to the same peer serialize, which matches the single-stream protocol.
struct PeerConn {
  std::mutex mu;
  int fd = -1;
};
std::mutex g_peers_mu;
std::map<std::string, PeerConn*>& peer_conns() {
  static auto* m = new std::map<std::string, PeerConn*>();  // see attach_cache
  return *m;
}

struct ChunkHdr {
  uint64_t total = 0, meta = 0, clen = 0;
};

// One chunk request/response on an open connection. dst == nullptr drains
// the chunk into a scratch buffer (keeps the stream aligned when the
// local create lost a race). Returns 0 ok, -2 not found, -4 io error.
int request_chunk(int fd, const uint8_t* id, uint64_t off, uint64_t len,
                  ChunkHdr* h, uint8_t* dst) {
  uint8_t req[kIdSize + 16];
  std::memcpy(req, id, kIdSize);
  uint64_t obe = htobe64(off), lbe = htobe64(len);
  std::memcpy(req + kIdSize, &obe, 8);
  std::memcpy(req + kIdSize + 8, &lbe, 8);
  if (!send_all(fd, req, sizeof(req))) return -4;
  uint64_t hdr[3];
  if (!recv_all(fd, hdr, sizeof(hdr))) return -4;
  h->total = be64toh(hdr[0]);
  if (h->total == kNotFound) return -2;
  h->meta = be64toh(hdr[1]);
  h->clen = be64toh(hdr[2]);
  if (h->clen > len) return -4;  // protocol violation
  if (h->clen == 0) return 0;
  if (dst != nullptr) {
    if (!recv_all(fd, dst, h->clen)) return -4;
    return 0;
  }
  std::vector<char> sink(h->clen < (1u << 20) ? h->clen : (1u << 20));
  uint64_t left = h->clen;
  while (left > 0) {
    size_t n = left < sink.size() ? left : sink.size();
    if (!recv_all(fd, sink.data(), n)) return -4;
    left -= n;
  }
  return 0;
}

struct Peer {
  std::string host;
  int port;
};

// Stripe worker: claims 8 MiB chunks off a shared cursor and pulls them
// over its own connection. A dead/object-less peer is not fatal — the
// worker fails over to the next peer in its rotation and only poisons
// the fetch when NO peer can serve a claimed chunk (the surviving
// copies absorb the dead peer's share).
void stripe_worker(const std::vector<Peer>& peers, size_t start,
                   const uint8_t* id, uint8_t* dst, uint64_t total,
                   std::atomic<uint64_t>* cursor,
                   std::atomic<bool>* failed) {
  int fd = -1;
  size_t pi = start % peers.size();
  while (!failed->load()) {
    uint64_t off = cursor->fetch_add(kChunkSize);
    if (off >= total) break;
    uint64_t len = total - off < kChunkSize ? total - off : kChunkSize;
    bool got = false;
    for (size_t tries = 0; tries < peers.size() && !got; ++tries) {
      if (fd < 0) {
        fd = connect_to(peers[pi].host.c_str(), peers[pi].port);
        if (fd < 0) {
          pi = (pi + 1) % peers.size();
          continue;
        }
      }
      ChunkHdr h;
      if (request_chunk(fd, id, off, len, &h, dst + off) == 0 &&
          h.clen == len) {
        got = true;
      } else {
        ::close(fd);
        fd = -1;
        pi = (pi + 1) % peers.size();
      }
    }
    if (!got) {
      failed->store(true);
      break;
    }
  }
  if (fd >= 0) ::close(fd);
}

// Small probe chunk: received into scratch then copied (object sizes are
// unknown before the first response); everything past it streams straight
// into shm, so the copy tax is capped at 256 KiB per fetch.
constexpr uint64_t kProbeLen = 256 << 10;

int fetch_chunked(void* store, int fd, const uint8_t* id,
                  const std::vector<Peer>& peers) {
  // Returns 0 ok, -2 not found on peer, -3 store full, -4 io/protocol
  // error (caller reconnects once on -4). A small first chunk doubles as
  // the size probe; the remainder stripes across parallel connections
  // for large objects.
  ChunkHdr h0;
  std::vector<uint8_t> first(kProbeLen);
  int rc = request_chunk(fd, id, 0, kProbeLen, &h0, first.data());
  if (rc != 0) return rc;
  uint64_t total = h0.total, meta = h0.meta;
  Admission adm(total);
  uint64_t off = 0;
  int crc = store_create(store, id, total, meta, &off);
  if (crc == -2 /*kErrExists*/) {
    // Concurrent create in flight; chunked requests are self-contained,
    // so no drain needed beyond the already-received first chunk.
    return store_contains(store, id) ? 0 : -2;
  }
  if (crc != 0) return -3;
  uint8_t* dst = static_cast<uint8_t*>(store_base(store)) + off;
  std::memcpy(dst, first.data(), h0.clen);
  uint64_t got = h0.clen;
  bool ok = true;
  if (got < total) {
    uint64_t remaining = total - got;
    int nworkers = 1;
    if (remaining >= kParallelThreshold) {
      nworkers = static_cast<int>(remaining / kParallelThreshold) + 1;
      int cap = kMaxStripes > static_cast<int>(peers.size()) * 2
                    ? static_cast<int>(peers.size()) * 2
                    : kMaxStripes;
      if (nworkers > cap) nworkers = cap;
    }
    if (nworkers == 1) {
      // Mid-size object: sequential chunks on the already-open probe
      // connection (no extra connect); an IO error returns -4 and the
      // caller's per-peer retry takes over.
      while (got < total) {
        uint64_t len = total - got < kChunkSize ? total - got : kChunkSize;
        ChunkHdr h;
        if (request_chunk(fd, id, got, len, &h, dst + got) != 0 ||
            h.clen != len) {
          ok = false;
          break;
        }
        got += len;
      }
    } else {
      std::atomic<uint64_t> cursor{got};
      std::atomic<bool> failed{false};
      std::vector<std::thread> extra;
      for (int w = 1; w < nworkers; ++w) {
        extra.emplace_back(stripe_worker, std::cref(peers),
                           static_cast<size_t>(w), id, dst, total, &cursor,
                           &failed);
      }
      // This thread stripes too, with the same peer-failover rotation
      // (worker index 0); the probe connection stays cached for the
      // next fetch on this peer.
      stripe_worker(peers, 0, id, dst, total, &cursor, &failed);
      for (auto& t : extra) t.join();
      ok = !failed.load();
    }
  }
  if (!ok) {
    store_abort(store, id);
    return -4;
  }
  store_seal(store, id);
  return 0;
}

// Pull one object from peers' transfer servers straight into the local
// store, striping large objects across parallel connections and peers.
// Returns 0 on success (or already present), -1 connect error,
// -2 not found on any peer, -3 local store full, -4 protocol error.
static int fetch_from_peers(const char* store_path,
                            const std::vector<Peer>& peers,
                            const uint8_t* id) {
  void* store = attached_store(store_path);
  if (!store || peers.empty()) return -4;
  if (store_contains(store, id)) return 0;
  int last = -1;
  for (size_t i = 0; i < peers.size(); ++i) {
    const Peer& p = peers[i];
    std::string key = p.host + ":" + std::to_string(p.port);
    PeerConn* pc;
    {
      std::lock_guard<std::mutex> g(g_peers_mu);
      auto& m = peer_conns();
      auto it = m.find(key);
      if (it == m.end()) it = m.emplace(key, new PeerConn()).first;
      pc = it->second;
    }
    std::lock_guard<std::mutex> g(pc->mu);
    // Peers that answer stripe to ALL peers; rotation only changes who
    // serves the size probe.
    std::vector<Peer> rotated(peers.begin() + i, peers.end());
    rotated.insert(rotated.end(), peers.begin(), peers.begin() + i);
    for (int attempt = 0; attempt < 2; ++attempt) {
      if (pc->fd < 0) {
        pc->fd = connect_to(p.host.c_str(), p.port);
        if (pc->fd < 0) {
          last = -1;
          break;  // next peer
        }
      }
      int rc = fetch_chunked(store, pc->fd, id, rotated);
      if (rc == 0) return 0;
      if (rc != -4) {
        last = rc;
        break;  // not-found / store-full: try next peer (or give up)
      }
      last = -4;
      // IO error — possibly a server-side idle-expired cached
      // connection: drop it and retry once on a fresh one.
      ::close(pc->fd);
      pc->fd = -1;
    }
    if (last == -3) return -3;  // local store full: no peer will help
  }
  return last;
}

int transfer_fetch(const char* store_path, const char* host, int port,
                   const uint8_t* id) {
  return fetch_from_peers(store_path, {{host, port}}, id);
}

// peers_csv: "host:port,host:port,...". Stripes chunks of one object
// across every listed peer in parallel (reference: pull_manager requests
// chunks from multiple object copies).
int transfer_fetch_multi(const char* store_path, const char* peers_csv,
                         const uint8_t* id) {
  std::vector<Peer> peers;
  std::string s(peers_csv ? peers_csv : "");
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    std::string item = s.substr(pos, comma == std::string::npos
                                         ? std::string::npos
                                         : comma - pos);
    size_t colon = item.rfind(':');
    if (colon != std::string::npos) {
      peers.push_back({item.substr(0, colon),
                       std::atoi(item.c_str() + colon + 1)});
    }
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  return fetch_from_peers(store_path, peers, id);
}

}  // extern "C"
