"""ctypes binding for the native fastpath frame pump (csrc/fastpath.cc).

The RPC hot path in C++: one epoll thread per pump owns accept/connect,
msgpack framing, read buffering, and writev-coalesced sends, so the
steady-state task cycle (PushTaskBatch → execute → TaskDone) never
touches Python asyncio (reference analog: the gRPC/asio event loops of
core_worker.cc and node_manager.cc — the daemons' hot loops are native
end-to-end).

Two consumption styles over the same FIFO:
  - `next(timeout)` — blocking dequeue (GIL released inside ctypes);
    worker exec threads live here.
  - `eventfd` — plain eventfd counter bumped per queued event (when
    armed); a driver asyncio loop `add_reader()`s it, read()s it to
    zero at callback entry, then drains until empty — a push racing the
    drain re-bumps it, so the level-triggered reader re-fires.
"""

from __future__ import annotations

import ctypes
import threading

from ray_tpu_torch._private.native_build import ensure_built

# Event kinds (csrc/fastpath.cc EventKind).
EV_FRAME = 1
EV_ACCEPT = 2
EV_CLOSE = 3
EV_INJECT = 4

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = ensure_built("fastpath.cc", "libtorchfastpath.so",
                            extra_flags=("-lpthread",))
        lib = ctypes.CDLL(path)
        lib.fpump_create.restype = ctypes.c_void_p
        lib.fpump_destroy.argtypes = [ctypes.c_void_p]
        lib.fpump_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.fpump_listen.restype = ctypes.c_int
        lib.fpump_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.fpump_connect.restype = ctypes.c_int64
        lib.fpump_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fpump_send.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_uint32]
        lib.fpump_send.restype = ctypes.c_int
        lib.fpump_inject.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_uint32]
        lib.fpump_recv_eventfd.argtypes = [ctypes.c_void_p]
        lib.fpump_recv_eventfd.restype = ctypes.c_int
        lib.fpump_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
        lib.fpump_next.restype = ctypes.c_int
        lib.fpump_arm_eventfd.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fpump_set_service.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.fpump_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.fpump_drain.restype = ctypes.c_int
        _lib = lib
        return lib


class FastPump:
    """One native frame pump (epoll thread + event FIFO)."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.fpump_create()
        if not self._h:
            raise OSError("fpump_create failed")
        # Reusable receive buffer per consumer thread (events are copied
        # out of C; 256 KiB covers every control frame — data frames of a
        # push batch can exceed it and trigger a one-shot regrow).
        self._buf_tls = threading.local()
        self._closed = False

    # ---- endpoints ----

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        got = self._lib.fpump_listen(self._h, host.encode(), port)
        if got < 0:
            raise OSError(f"fpump_listen failed (host={host} port={port})")
        return got

    def connect(self, host: str, port: int) -> int:
        cid = self._lib.fpump_connect(self._h, host.encode(), port)
        if cid < 0:
            raise OSError(f"fastpath connect to {host}:{port} failed")
        return cid

    def close_conn(self, conn_id: int) -> None:
        if not self._closed:
            self._lib.fpump_close_conn(self._h, conn_id)

    # ---- IO ----

    def set_service(self, frame_fn_addr: int, close_fn_addr: int,
                    ctx: int) -> None:
        """Install an in-pump native service (loop-thread frame handler).
        Must be called before listen()/connect() — the loop thread reads
        the hook fields without a lock."""
        self._lib.fpump_set_service(self._h, frame_fn_addr, close_fn_addr,
                                    ctx)

    def send(self, conn_id: int, payload: bytes) -> bool:
        """Queue one frame body; returns False if the conn is gone."""
        if self._closed:
            return False
        return self._lib.fpump_send(self._h, conn_id, payload,
                                    len(payload)) == 0

    def inject(self, token: int, payload: bytes = b"") -> None:
        """Queue a local work item into the event FIFO (kind=EV_INJECT)."""
        if not self._closed:
            self._lib.fpump_inject(self._h, token, payload, len(payload))

    @property
    def eventfd(self) -> int:
        return self._lib.fpump_recv_eventfd(self._h)

    def next(self, timeout: float | None):
        """Dequeue the next event: (kind, conn_id, payload_bytes) or None
        on timeout. Blocking (GIL released) when timeout > 0 / None."""
        if self._closed:
            return None
        tls = self._buf_tls
        buf = getattr(tls, "buf", None)
        if buf is None:
            buf = tls.buf = ctypes.create_string_buffer(1 << 18)
        conn_id = ctypes.c_int64()
        kind = ctypes.c_int()
        n = ctypes.c_uint32(len(buf))
        tmo = -1 if timeout is None else int(timeout * 1000)
        r = self._lib.fpump_next(self._h, ctypes.byref(conn_id),
                                 ctypes.byref(kind), buf, ctypes.byref(n),
                                 tmo)
        if r == -2:  # payload larger than the buffer: regrow and retry
            buf = tls.buf = ctypes.create_string_buffer(int(n.value))
            n = ctypes.c_uint32(len(buf))
            r = self._lib.fpump_next(self._h, ctypes.byref(conn_id),
                                     ctypes.byref(kind), buf,
                                     ctypes.byref(n), tmo)
        if r != 1:
            return None
        return kind.value, conn_id.value, buf.raw[:n.value]

    def arm_eventfd(self, armed: bool = True) -> None:
        """Enable recv-eventfd bumps (driver asyncio consumers only)."""
        if not self._closed:
            self._lib.fpump_arm_eventfd(self._h, 1 if armed else 0)

    def drain(self, max_events: int = 512):
        """Non-blocking batch dequeue: one ctypes call returns up to
        max_events events as a list of (kind, conn_id, payload_bytes)."""
        if self._closed:
            return []
        tls = self._buf_tls
        buf = getattr(tls, "dbuf", None)
        if buf is None:
            buf = tls.dbuf = ctypes.create_string_buffer(1 << 20)
        needed = ctypes.c_uint32(0)
        out = []
        while True:
            needed.value = 0
            n = self._lib.fpump_drain(self._h, buf, len(buf), max_events,
                                      ctypes.byref(needed))
            if n == 0:
                if needed.value > len(buf):  # single oversized event
                    buf = tls.dbuf = ctypes.create_string_buffer(
                        int(needed.value))
                    continue
                # Queue genuinely empty — the ONLY exit without a
                # follow-up call: a short batch may mean buffer-full or
                # the per-call cap, and stopping there would strand
                # events behind an already-zeroed eventfd.
                return out
            raw = ctypes.string_at(buf, int(needed.value))  # used bytes only
            off = 0
            for _ in range(n):
                conn_id = int.from_bytes(raw[off:off + 8], "little",
                                         signed=True)
                kind = int.from_bytes(raw[off + 8:off + 12], "little")
                dlen = int.from_bytes(raw[off + 12:off + 16], "little")
                out.append((kind, conn_id, raw[off + 16:off + 16 + dlen]))
                off += 16 + dlen
            if len(out) >= max_events:
                return out

    # ---- lifecycle ----

    def close(self) -> None:
        """Destroy the pump. Caller contract: every thread that may be
        blocked in next() must have been stopped/joined first (the C side
        wakes them on stop, but destroy then frees the handle)."""
        if self._closed:
            return
        self._closed = True
        self._lib.fpump_destroy(self._h)
        self._h = None
