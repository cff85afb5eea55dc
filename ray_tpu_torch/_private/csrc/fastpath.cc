// fastpath.cc — native event loop + frame pump for the RPC hot path.
//
// The reference's daemon hot loops are C++ end-to-end (gRPC server +
// boost::asio event loops: src/ray/rpc/grpc_server.h, core_worker.cc:1878
// SubmitTask, node_manager.cc:1778 HandleRequestWorkerLease, raylet worker
// task loop _raylet.pyx:3044).  This module is the tpu-native equivalent
// of that IO plane: one epoll thread per process owns every fastpath
// socket — accept, connect, 4-byte-BE-length msgpack framing, write
// coalescing (writev), read buffering — so the steady-state task cycle
// (PushTaskBatch → execute → TaskDone) crosses ONLY this loop, never
// Python asyncio.  Python stays above the loop: it packs/unpacks msgpack
// payloads (C-extension speed) and runs protocol logic; every syscall,
// buffer copy, and wakeup on the hot path is native.
//
// Concurrency model:
//   - one epoll thread (started by fpump_create) owns all sockets
//   - any thread may fpump_send(); frames queue per-conn under a mutex and
//     the loop is woken by eventfd
//   - consumers receive events (frames / accepts / closes / injected
//     local work) from a single FIFO via fpump_next() — a blocking call
//     (ctypes releases the GIL) — or poll after the recv eventfd becomes
//     readable (driver asyncio loops add_reader() it)
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <time.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMaxFrame = 1u << 31;          // matches rpc.py _MAX_FRAME
constexpr size_t kMaxConnBacklog = 1u << 30;      // per-conn queued send bytes

enum EventKind : int {
  EV_FRAME = 1,
  EV_ACCEPT = 2,
  EV_CLOSE = 3,
  EV_INJECT = 4,
};

struct Event {
  int64_t conn_id;
  int kind;
  std::string data;   // frame body (EV_FRAME) or inject payload (EV_INJECT)
};

struct Conn {
  int fd = -1;
  int64_t id = 0;
  bool closed = false;
  // ---- read state ----
  std::string rbuf;         // accumulated unparsed bytes
  // ---- write state (under pump send_mu) ----
  std::deque<std::string> out;
  size_t out_bytes = 0;
  size_t out_off = 0;       // offset into out.front() already written
  bool want_write = false;  // EPOLLOUT currently armed
};

// In-pump native service: a handler called ON THE LOOP THREAD for every
// parsed frame before it is queued toward Python.  Returning nonzero
// consumes the frame (the service answered it natively via fpump_send);
// zero passes it through unchanged.  This is how daemon protocol logic
// moves into C++ one method at a time (gcs_service.cc) while Python
// keeps the rest — the reference's daemons dispatch protobuf handlers on
// their C++ event loops the same way (gcs_server.h:79 service tables).
typedef int (*service_frame_fn)(void* ctx, int64_t conn_id,
                                const char* data, uint32_t len);
typedef void (*service_close_fn)(void* ctx, int64_t conn_id);

struct FPump {
  int epfd = -1;
  int wake_efd = -1;        // producers -> loop
  int recv_efd = -1;        // loop -> consumers (level-ish via counter)
  int listen_fd = -1;
  int listen_port = 0;
  // Set before listen() (no lock: writes happen-before any frame).
  service_frame_fn svc_frame = nullptr;
  service_close_fn svc_close = nullptr;
  void* svc_ctx = nullptr;
  std::thread loop_thread;
  std::atomic<bool> stopping{false};

  std::mutex conn_mu;       // guards conns map + per-conn out queues
  std::unordered_map<int64_t, Conn*> conns;
  std::atomic<int64_t> next_id{1};

  std::mutex recv_mu;
  std::condition_variable recv_cv;
  std::deque<Event> recv_q;
  // When armed, every push bumps recv_efd so an asyncio add_reader fires;
  // worker exec threads consume via the condvar and leave it unarmed,
  // saving one 8-byte write() syscall per event.
  std::atomic<bool> efd_armed{false};

  void push_event(Event&& ev) {
    {
      std::lock_guard<std::mutex> g(recv_mu);
      recv_q.emplace_back(std::move(ev));
    }
    recv_cv.notify_one();
    if (efd_armed.load(std::memory_order_relaxed)) {
      uint64_t one = 1;
      ssize_t r = write(recv_efd, &one, 8);
      (void)r;
    }
  }
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

void arm(FPump* p, Conn* c, bool writable) {
  epoll_event ev{};
  ev.events = EPOLLIN | (writable ? EPOLLOUT : 0);
  ev.data.u64 = (uint64_t)c->id;
  epoll_ctl(p->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  c->want_write = writable;
}

// Close + deregister a conn (loop thread only) and notify consumers.
void drop_conn(FPump* p, Conn* c) {
  if (c->closed) return;
  c->closed = true;
  epoll_ctl(p->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  {
    std::lock_guard<std::mutex> g(p->conn_mu);
    p->conns.erase(c->id);
  }
  if (p->svc_close) p->svc_close(p->svc_ctx, c->id);
  p->push_event(Event{c->id, EV_CLOSE, {}});
  delete c;
}

// Parse length-prefixed frames out of c->rbuf into the recv queue.
bool parse_frames(FPump* p, Conn* c) {
  size_t off = 0;
  const std::string& b = c->rbuf;
  while (b.size() - off >= 4) {
    uint32_t len = ((uint8_t)b[off] << 24) | ((uint8_t)b[off + 1] << 16) |
                   ((uint8_t)b[off + 2] << 8) | (uint8_t)b[off + 3];
    if (len > kMaxFrame) return false;  // protocol violation: drop conn
    if (b.size() - off - 4 < len) break;
    if (p->svc_frame == nullptr ||
        p->svc_frame(p->svc_ctx, c->id, b.data() + off + 4, len) == 0) {
      p->push_event(Event{c->id, EV_FRAME, b.substr(off + 4, len)});
    }
    off += 4 + (size_t)len;
  }
  if (off) c->rbuf.erase(0, off);
  return true;
}

void handle_readable(FPump* p, Conn* c) {
  char buf[1 << 16];
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c->rbuf.append(buf, (size_t)n);
      if ((size_t)n < sizeof(buf)) break;  // drained
    } else if (n == 0) {
      drop_conn(p, c);
      return;
    } else {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      drop_conn(p, c);
      return;
    }
  }
  if (!parse_frames(p, c)) drop_conn(p, c);
}

void handle_writable(FPump* p, Conn* c) {
  std::lock_guard<std::mutex> g(p->conn_mu);
  while (!c->out.empty()) {
    // writev up to 16 queued frames in one syscall.
    iovec iov[16];
    int iovcnt = 0;
    size_t off = c->out_off;
    for (auto it = c->out.begin(); it != c->out.end() && iovcnt < 16; ++it) {
      iov[iovcnt].iov_base = (void*)(it->data() + off);
      iov[iovcnt].iov_len = it->size() - off;
      off = 0;
      iovcnt++;
    }
    ssize_t n = writev(c->fd, iov, iovcnt);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      // Real error: the read side will observe it; stop writing.
      c->out.clear();
      c->out_bytes = 0;
      c->out_off = 0;
      break;
    }
    size_t left = (size_t)n;
    c->out_bytes -= left;
    while (left > 0 && !c->out.empty()) {
      size_t avail = c->out.front().size() - c->out_off;
      if (left >= avail) {
        left -= avail;
        c->out.pop_front();
        c->out_off = 0;
      } else {
        c->out_off += left;
        left = 0;
      }
    }
  }
  if (c->out.empty() && c->want_write) arm(p, c, false);
  else if (!c->out.empty() && !c->want_write) arm(p, c, true);
}

void loop_main(FPump* p) {
  epoll_event evs[64];
  while (!p->stopping.load(std::memory_order_relaxed)) {
    int n = epoll_wait(p->epfd, evs, 64, 200);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; i++) {
      uint64_t tag = evs[i].data.u64;
      if (tag == UINT64_MAX) {  // wake eventfd: flush pending sends
        uint64_t cnt;
        ssize_t r = read(p->wake_efd, &cnt, 8);
        (void)r;
        std::vector<Conn*> want;
        {
          std::lock_guard<std::mutex> g(p->conn_mu);
          for (auto& kv : p->conns)
            if (!kv.second->out.empty() && !kv.second->want_write)
              want.push_back(kv.second);
        }
        for (Conn* c : want) handle_writable(p, c);
        continue;
      }
      if (tag == UINT64_MAX - 1) {  // listening socket
        for (;;) {
          int fd = accept4(p->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          set_nodelay(fd);
          Conn* c = new Conn();
          c->fd = fd;
          c->id = p->next_id.fetch_add(1);
          {
            std::lock_guard<std::mutex> g(p->conn_mu);
            p->conns[c->id] = c;
          }
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = (uint64_t)c->id;
          epoll_ctl(p->epfd, EPOLL_CTL_ADD, fd, &ev);
          p->push_event(Event{c->id, EV_ACCEPT, {}});
        }
        continue;
      }
      Conn* c;
      {
        std::lock_guard<std::mutex> g(p->conn_mu);
        auto it = p->conns.find((int64_t)tag);
        if (it == p->conns.end()) continue;
        c = it->second;
      }
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // Flush remaining readable bytes first (peer may have sent
        // frames then closed).
        handle_readable(p, c);
        continue;
      }
      if (evs[i].events & EPOLLIN) {
        handle_readable(p, c);
        // conn may be gone now
        std::lock_guard<std::mutex> g(p->conn_mu);
        if (p->conns.find((int64_t)tag) == p->conns.end()) continue;
      }
      if (evs[i].events & EPOLLOUT) handle_writable(p, c);
    }
  }
}

}  // namespace

// Weak LSan hook: present under ASan/LSan builds, null otherwise. The
// FPump struct is deliberately kept alive across fpump_destroy (see
// there); mark it ignored so leak checking stays meaningful for
// everything else.
extern "C" void __lsan_ignore_object(const void*) __attribute__((weak));

extern "C" {

FPump* fpump_create() {
  FPump* p = new FPump();
  p->epfd = epoll_create1(EPOLL_CLOEXEC);
  p->wake_efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  // Plain counter semantics: the asyncio reader read()s it to zero at
  // callback entry, then drains the queue until empty; a push that races
  // the drain re-bumps the counter, so the level-triggered reader
  // re-fires — no event is ever stranded.
  p->recv_efd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->wake_efd, &ev);
  p->loop_thread = std::thread(loop_main, p);
  if (&__lsan_ignore_object) __lsan_ignore_object(p);
  return p;
}

// Stops the loop thread, closes every fd, wakes blocked consumers and
// drops queued events.  The FPump struct itself is deliberately LEAKED
// (a few KB, no threads): a consumer that was blocked inside fpump_next
// at destroy time still touches the mutex/condvar on its way out, and a
// freed handle there would be a use-after-free.  Pumps are created once
// per CoreWorker lifetime, so the leak is bounded by init/shutdown
// cycles, not by traffic.
void fpump_destroy(FPump* p) {
  if (!p) return;
  p->stopping.store(true);
  uint64_t one = 1;
  ssize_t r = write(p->wake_efd, &one, 8);
  (void)r;
  if (p->loop_thread.joinable()) p->loop_thread.join();
  {
    std::lock_guard<std::mutex> g(p->conn_mu);
    for (auto& kv : p->conns) {
      close(kv.second->fd);
      delete kv.second;
    }
    p->conns.clear();
  }
  if (p->listen_fd >= 0) close(p->listen_fd);
  close(p->epfd);
  close(p->wake_efd);
  close(p->recv_efd);
  {
    std::lock_guard<std::mutex> g(p->recv_mu);
    p->recv_q.clear();
  }
  p->recv_cv.notify_all();
}

// Bind+listen; returns the bound port or -1.  Call once, before any
// connects land (loop thread registration is done here, which is safe
// because the listen fd is added via epoll_ctl from this thread).
int fpump_listen(FPump* p, const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);  // 0 = ephemeral; fixed for
                                          // GCS restart-on-same-port
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 || listen(fd, 512) < 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  p->listen_fd = fd;
  p->listen_port = ntohs(addr.sin_port);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = UINT64_MAX - 1;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, fd, &ev);
  return p->listen_port;
}

// Blocking connect (bounded by the kernel's SYN timeout; callers connect
// to local daemons where this resolves immediately).  Returns conn_id.
int64_t fpump_connect(FPump* p, const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  set_nonblock(fd);
  set_nodelay(fd);
  Conn* c = new Conn();
  c->fd = fd;
  c->id = p->next_id.fetch_add(1);
  {
    std::lock_guard<std::mutex> g(p->conn_mu);
    p->conns[c->id] = c;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = (uint64_t)c->id;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, fd, &ev);
  return c->id;
}

void fpump_close_conn(FPump* p, int64_t conn_id) {
  std::lock_guard<std::mutex> g(p->conn_mu);
  auto it = p->conns.find(conn_id);
  if (it == p->conns.end()) return;
  // Let the loop thread notice EOF-like state: shutdown() triggers
  // EPOLLIN/HUP there, which runs the full drop path safely.
  shutdown(it->second->fd, SHUT_RDWR);
}

// Queue one frame (body only; the 4-byte BE length prefix is added here).
// Returns 0 on success, -1 if the conn is gone or its backlog is full.
int fpump_send(FPump* p, int64_t conn_id, const void* buf, uint32_t len) {
  std::string frame;
  frame.reserve(len + 4);
  frame.push_back((char)(len >> 24));
  frame.push_back((char)(len >> 16));
  frame.push_back((char)(len >> 8));
  frame.push_back((char)len);
  frame.append((const char*)buf, len);
  bool need_wake;
  {
    std::lock_guard<std::mutex> g(p->conn_mu);
    auto it = p->conns.find(conn_id);
    if (it == p->conns.end()) return -1;
    Conn* c = it->second;
    if (c->out_bytes + frame.size() > kMaxConnBacklog) return -1;
    need_wake = c->out.empty() && !c->want_write;
    c->out_bytes += frame.size();
    c->out.emplace_back(std::move(frame));
  }
  if (need_wake) {
    uint64_t one = 1;
    ssize_t r = write(p->wake_efd, &one, 8);
    (void)r;
  }
  return 0;
}

// Local work injection: surfaces in the same FIFO as frames (kind=4) so a
// worker exec thread has ONE blocking wait for both network tasks and
// loop-side handoffs.
void fpump_inject(FPump* p, int64_t token, const void* buf, uint32_t len) {
  p->push_event(Event{token, EV_INJECT,
                      std::string((const char*)buf, buf ? len : 0)});
}

// Register the in-pump native service.  Must be called BEFORE
// fpump_listen/fpump_connect so the loop thread's reads of the three
// fields are ordered by the listen/connect synchronization.
void fpump_set_service(FPump* p, void* frame_fn, void* close_fn, void* ctx) {
  p->svc_frame = (service_frame_fn)frame_fn;
  p->svc_close = (service_close_fn)close_fn;
  p->svc_ctx = ctx;
}

int fpump_recv_eventfd(FPump* p) { return p->recv_efd; }
int fpump_port(FPump* p) { return p->listen_port; }

// Dequeue the next event.  Blocks up to timeout_ms (-1 = forever).
// Returns 1 with *kind/*conn_id set and the payload copied into out
// (caller supplies capacity; if the payload exceeds *len, returns -2 with
// *len set to the needed size and the event stays queued), 0 on timeout.
int fpump_next(FPump* p, int64_t* conn_id, int* kind, void* out,
               uint32_t* len, int timeout_ms) {
  std::unique_lock<std::mutex> lk(p->recv_mu);
  if (p->recv_q.empty()) {
    if (timeout_ms == 0) return 0;
    auto pred = [p] { return !p->recv_q.empty() || p->stopping.load(); };
    if (timeout_ms < 0) {
      p->recv_cv.wait(lk, pred);
    } else {
      // Timed wait through the native handles: libstdc++'s wait_for
      // lowers to pthread_cond_clockwait (CLOCK_MONOTONIC), which TSan
      // does not intercept — the unlock/relock inside the wait becomes
      // invisible and every recv_mu-guarded access then reports as a
      // race. pthread_cond_timedwait IS intercepted; a REALTIME clock
      // jump only skews waits of tens of ms, which callers already
      // tolerate (0 just means "poll again").
      struct timespec ts;
      clock_gettime(CLOCK_REALTIME, &ts);
      ts.tv_sec += timeout_ms / 1000;
      ts.tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
      if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec++;
        ts.tv_nsec -= 1000000000L;
      }
      while (!pred()) {
        if (pthread_cond_timedwait(p->recv_cv.native_handle(),
                                   p->recv_mu.native_handle(),
                                   &ts) == ETIMEDOUT)
          break;
      }
      if (!pred()) return 0;
    }
    if (p->recv_q.empty()) return 0;  // stopping
  }
  Event& ev = p->recv_q.front();
  if (ev.data.size() > *len) {
    *len = (uint32_t)ev.data.size();
    return -2;
  }
  *conn_id = ev.conn_id;
  *kind = ev.kind;
  *len = (uint32_t)ev.data.size();
  if (!ev.data.empty()) memcpy(out, ev.data.data(), ev.data.size());
  p->recv_q.pop_front();
  return 1;
}

void fpump_arm_eventfd(FPump* p, int armed) {
  p->efd_armed.store(armed != 0, std::memory_order_relaxed);
}

// Batch dequeue: pack up to max_events events into out as repeated
// [int64 conn_id][int32 kind][uint32 len][payload] records.  Never
// blocks.  Returns the number packed; an event that does not fit in the
// remaining space stays queued (first-event-too-big: returns 0 with
// *needed set so the caller can regrow).
int fpump_drain(FPump* p, void* out, uint32_t cap, int max_events,
                uint32_t* needed) {
  std::lock_guard<std::mutex> g(p->recv_mu);
  char* w = (char*)out;
  uint32_t off = 0;
  int count = 0;
  while (count < max_events && !p->recv_q.empty()) {
    Event& ev = p->recv_q.front();
    uint32_t rec = 16 + (uint32_t)ev.data.size();
    if (off + rec > cap) {
      if (count == 0 && needed) *needed = rec;
      break;
    }
    memcpy(w + off, &ev.conn_id, 8);
    int32_t k = ev.kind;
    memcpy(w + off + 8, &k, 4);
    uint32_t dlen = (uint32_t)ev.data.size();
    memcpy(w + off + 12, &dlen, 4);
    if (dlen) memcpy(w + off + 16, ev.data.data(), dlen);
    off += rec;
    count++;
    p->recv_q.pop_front();
  }
  if (needed && count > 0) *needed = off;
  return count;
}

}  // extern "C"
