"""Symmetric msgpack-framed RPC over asyncio TCP.

Re-design of the reference's gRPC layer (reference: src/ray/rpc/grpc_server.h,
grpc_client.h, client_call.h). The reference generates typed stubs from 24
proto files; here a single symmetric `Connection` carries length-prefixed
msgpack frames and either side can issue calls — which is exactly what the
worker↔raylet and owner↔worker channels need (the reference gets the same
effect with paired gRPC services on both ends).

Frame: 4-byte big-endian length + msgpack [msg_type, seq, method, payload].
msg_type: 0=request, 1=response-ok, 2=response-error, 3=one-way notify.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import traceback
import uuid
from collections import OrderedDict
from typing import Awaitable, Callable

from ray_tpu_torch._vendor import msgpack

from ray_tpu_torch._private.common import RetryPolicy, supervised_task

logger = logging.getLogger(__name__)

MSG_REQUEST = 0
MSG_RESPONSE = 1
MSG_ERROR = 2
MSG_NOTIFY = 3

_MAX_FRAME = 1 << 31


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


# ---------------------------------------------------------------------------
# Resilient sessions (graftlint rule R6: everything outside this module
# connects through dial()/connect_session(), never raw connect()).
#
# A ResilientConnection is a stable session over reconnecting sockets:
# mutating calls are stamped with (session_id, rseq) and replayed across
# socket death; the server side keeps a per-session reply cache so a
# replayed request that already executed gets its cached reply instead
# of a second side effect (at-most-once). The reference gets the same
# property from gRPC channel reconnection + GCS client retries
# (gcs_rpc_client.h retryable operations).
# ---------------------------------------------------------------------------

# Reserved payload keys carrying the session stamp. Stripped by the
# server dispatchers before the handler sees the payload.
_SID_KEY = "_session"
_RSEQ_KEY = "_rseq"
_ACK_KEY = "_acked"
# Restart-handshake stamp (issue 19). Servers advertise their
# incarnation epoch inside stamped dict replies; clients echo the last
# learned epoch on REPLAYED sends only. A replay stamped with a dead
# incarnation's epoch whose (sid, rseq) has no cache entry is rejected
# deterministically (the cache it would dedup against died with the old
# server), instead of silently re-executing a mutating request.
_EPOCH_KEY = "_epoch"

# Deterministic rejection text for a cross-incarnation replay. The
# native SessionManager path (src/gcs_actor.cc, src/raylet_lease.cc)
# emits the SAME bytes — the differential replay test pins them equal.
STALE_EPOCH_ERROR = ("stale session epoch: request may have executed "
                     "before a server restart and its reply was lost; "
                     "re-issue")


def _new_epoch() -> int:
    """Nonzero u63 unique per server incarnation (uniqueness is the only
    requirement — mismatch detection, not ordering)."""
    return ((int(time.time()) << 20) | (os.getpid() & 0xFFFFF)) \
        & 0x7FFFFFFFFFFFFFFF or 1

# A reconnected socket must survive this long before the session trusts
# it: a connection that dies younger CONTINUES the previous redial
# cycle's backoff schedule and grace deadline instead of resetting them
# (an accept-then-close peer — half-up proxy, LB with no healthy
# backend — would otherwise spin the redial loop at connect speed,
# forever).
_MIN_STABLE_S = 1.0

# Methods never stamped: handled inside the native C++ pump
# (src/gcs_service.cc) where the Python dispatcher — and therefore the
# reply cache — never sees them. All are idempotent (KV writes are
# last-write-wins, Subscribe is a set-add), so blind replay is safe.
SESSION_EXEMPT_METHODS = frozenset({
    "KVPut", "KVGet", "KVDel", "KVExists", "KVKeys",
    "Subscribe", "Publish",
})

# Audited idempotence registry: method -> why a blind replay (no reply
# cache) is safe. Every SESSION_EXEMPT method MUST appear here with a
# justification, and every entry here must still be exempt — graftwire
# W4 cross-checks both directions, so exempting a method from stamping
# without writing down WHY (or leaving a stale audit entry behind after
# un-exempting one) fails the lint gate. This is the replay-class column
# of docs/wire_contract.md and part of the native-server spec
# (ROADMAP item 1): a C++ SessionManager must cache replies for every
# method NOT in this table.
REPLAY_IDEMPOTENT = {
    "KVPut": "last-write-wins: replaying the same (key, value) is a no-op",
    "KVGet": "pure read",
    "KVDel": "deleting an already-deleted key is a no-op",
    "KVExists": "pure read",
    "KVKeys": "pure read",
    "Subscribe": "set-add: re-subscribing the same conn/channel is a no-op",
    "Publish": "fanout is at-most-once per live subscriber by design; "
               "duplicate delivery is the documented pubsub contract",
}

_session_stats = {
    "reconnects_total": 0,          # successful socket re-establishes
    "replayed_requests_total": 0,   # requests re-sent after a reconnect
    "deduped_requests_total": 0,    # server-side replay cache hits
    "stale_epoch_rejections_total": 0,  # cross-incarnation replays refused
    "sessions_opened": 0,
    "sessions_failed": 0,           # grace window exhausted
}


def session_stats() -> dict:
    """Per-process resilient-session counters (client AND server side)."""
    out = dict(_session_stats)
    out["server_sessions"] = len(_server_sessions._sessions)
    return out


class SessionManager:
    """Server-side (session_id, rseq) -> reply cache.

    begin() returns True when the handler should execute; False when the
    request is a replay (the cached reply — or the in-flight execution's
    eventual reply — is routed to `reply_fn`). finish() caches the
    outcome and answers any duplicate arrivals that raced the first
    execution. ack() prunes entries the client confirmed receiving.
    """

    def __init__(self, max_replies_per_session: int = 512,
                 session_ttl_s: float = 900.0):
        self.max_replies = max_replies_per_session
        self.session_ttl_s = session_ttl_s
        # Incarnation epoch, advertised in stamped replies and compared
        # against the _epoch stamp of replayed requests (issue 19).
        # Overridable for tests; the native planes are installed with
        # this SAME value so both caches agree about incarnations.
        self.epoch = _new_epoch()
        self._sessions: dict[str, dict] = {}
        self._last_sweep = 0.0

    def has(self, sid: str, rseq: int) -> bool:
        sess = self._sessions.get(sid)
        return sess is not None and rseq in sess["replies"]

    def begin(self, sid: str, rseq: int, reply_fn) -> bool:
        now = time.monotonic()
        self._maybe_sweep(now)
        sess = self._sessions.setdefault(
            sid, {"replies": OrderedDict(), "last_seen": now})
        sess["last_seen"] = now
        replies: OrderedDict = sess["replies"]
        entry = replies.get(rseq)
        if entry is None:
            replies[rseq] = {"state": "pending", "waiters": []}
            while len(replies) > self.max_replies:
                # Evict oldest DONE entry; a pending head means the
                # cache is full of in-flight work — stop, don't break
                # at-most-once for it.
                oldest = next(iter(replies))
                if replies[oldest]["state"] != "done":
                    break
                replies.pop(oldest)
            return True
        _session_stats["deduped_requests_total"] += 1
        if entry["state"] == "pending":
            entry["waiters"].append(reply_fn)
        else:
            reply_fn(entry["kind"], entry["value"])
        return False

    def finish(self, sid: str, rseq: int, kind: int, value) -> None:
        sess = self._sessions.get(sid)
        if sess is None:
            return
        entry = sess["replies"].get(rseq)
        if entry is None:
            return
        waiters, entry["waiters"] = entry["waiters"], []
        entry.update(state="done", kind=kind, value=value)
        for fn in waiters:
            try:
                fn(kind, value)
            except Exception:
                logger.exception("session %s: duplicate reply failed", sid)

    def ack(self, sid: str, upto: int) -> None:
        sess = self._sessions.get(sid)
        if sess is None:
            return
        replies = sess["replies"]
        for rseq in [r for r in replies
                     if r <= upto and replies[r]["state"] == "done"]:
            replies.pop(rseq)

    def _maybe_sweep(self, now: float) -> None:
        if now - self._last_sweep < 60.0:
            return
        self._last_sweep = now
        stale = [sid for sid, s in self._sessions.items()
                 if now - s["last_seen"] > self.session_ttl_s]
        for sid in stale:
            del self._sessions[sid]


# One reply cache per process: every server (asyncio or native pump) in
# this process shares it, so a client that reconnects to a restarted
# listener on the same daemon still hits its session.
_server_sessions = SessionManager()


def _session_intercept(payload, seq, reply_fn):
    """Strip session keys from a request payload and consult the reply
    cache. Returns (execute, record_fn, payload): when execute is False
    the request was a replay and has been answered (or attached to the
    in-flight execution); when record_fn is not None the dispatcher must
    call record_fn(kind, value) with the handler outcome."""
    sid = payload.pop(_SID_KEY)
    rseq = payload.pop(_RSEQ_KEY, None)
    acked = payload.pop(_ACK_KEY, None)
    frame_epoch = payload.pop(_EPOCH_KEY, None)
    if acked is not None:
        _server_sessions.ack(sid, acked)
    if rseq is None or seq is None:
        return True, None, payload   # notify / unstamped: no dedup
    if frame_epoch and frame_epoch != _server_sessions.epoch \
            and not _server_sessions.has(sid, rseq):
        # A replay stamped with a DEAD incarnation's epoch and no cache
        # entry left: the original send may have executed before the
        # restart. Stamped methods are all cached-class (exempt ones are
        # never stamped), so the only deterministic answer is rejection
        # — never a silent re-execution against a lost cache.
        _session_stats["stale_epoch_rejections_total"] += 1
        reply_fn(MSG_ERROR, STALE_EPOCH_ERROR)
        return False, None, payload
    if not _server_sessions.begin(sid, rseq, reply_fn):
        return False, None, payload
    return True, (lambda kind, value:
                  _server_sessions.finish(sid, rseq, kind, value)), payload


def _stamp_reply(result):
    """Advertise the server's incarnation epoch inside a stamped dict
    reply (the client learns it from here and echoes it on replays).
    Non-dict (opaque) results pass through unstamped."""
    if isinstance(result, dict) and _EPOCH_KEY not in result:
        return {**result, _EPOCH_KEY: _server_sessions.epoch}
    return result


def pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class Connection:
    """One bidirectional RPC channel. Both peers may call() and serve handlers."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 handlers: dict[str, Callable] | None = None, name: str = "conn",
                 stats=None):
        self.reader = reader
        self.writer = writer
        self.handlers = handlers or {}
        self.name = name
        # EventLoopStats of the owning RpcServer (None on client conns):
        # per-handler dispatch latency, same surface as the native pump
        # server (fast_rpc.FastRpcServer.stats).
        self._stats = stats
        self._seq = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self._close_callbacks: list[Callable[[], None]] = []
        self._recv_task: asyncio.Task | None = None
        self._send_lock = asyncio.Lock()

    def start(self) -> None:
        self._recv_task = supervised_task(self._recv_loop(),
                                          name=f"recv-{self.name}")

    def on_close(self, cb: Callable[[], None]) -> None:
        self._close_callbacks.append(cb)

    @property
    def closed(self) -> bool:
        return self._closed

    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None

    async def _send(self, frame: list) -> None:
        data = pack(frame)
        # Small frames: one buffer, one write — separate header/body writes
        # double the syscalls on the hot path (every task push/response is
        # a frame). Large frames (object-transfer chunks) keep two writes:
        # concatenation would memcpy the whole body. write() is synchronous
        # and ordered on the loop, so no lock is needed; drain() (a
        # scheduler hop per frame) only when the transport is actually
        # backed up past the high-water mark.
        header = len(data).to_bytes(4, "big")
        if len(data) < (64 << 10):
            self.writer.write(header + data)
        else:
            self.writer.write(header)
            self.writer.write(data)
        transport = self.writer.transport
        if transport is not None and \
                transport.get_write_buffer_size() > (1 << 20):
            async with self._send_lock:
                await self.writer.drain()

    async def call(self, method: str, payload=None, timeout: float | None = None):
        if self._closed:
            raise ConnectionLost(f"{self.name}: connection closed")
        self._seq += 1
        seq = self._seq
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        try:
            await self._send([MSG_REQUEST, seq, method, payload])
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(seq, None)

    async def notify(self, method: str, payload=None) -> None:
        if self._closed:
            raise ConnectionLost(f"{self.name}: connection closed")
        await self._send([MSG_NOTIFY, 0, method, payload])

    async def _recv_loop(self) -> None:
        try:
            while True:
                header = await self.reader.readexactly(4)
                length = int.from_bytes(header, "big")
                if length > _MAX_FRAME:
                    raise RpcError(f"frame too large: {length}")
                body = await self.reader.readexactly(length)
                msg_type, seq, method, payload = unpack(body)
                if msg_type == MSG_REQUEST:
                    supervised_task(self._dispatch(seq, method, payload))
                elif msg_type == MSG_NOTIFY:
                    supervised_task(self._dispatch(None, method, payload))
                elif msg_type in (MSG_RESPONSE, MSG_ERROR):
                    fut = self._pending.get(seq)
                    if fut is not None and not fut.done():
                        if msg_type == MSG_RESPONSE:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(RpcError(payload))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("%s: recv loop error", self.name)
        finally:
            # Synchronous on purpose: this finally also runs when the
            # coroutine is closed by GC after its loop is gone (process
            # teardown) — an `await` here would raise "Event loop is
            # closed" as an unraisable exception.
            self._shutdown()

    async def _dispatch(self, seq, method: str, payload) -> None:
        handler = self.handlers.get(method)
        t0 = time.perf_counter() if self._stats is not None else 0.0
        record = None
        if isinstance(payload, dict) and _SID_KEY in payload:
            def _dup_reply(kind, value, _seq=seq, _method=method):
                supervised_task(
                    self._send([kind, _seq, _method, value]),
                    name=f"dup-reply-{_method}", ignore=(Exception,))

            execute, record, payload = _session_intercept(
                payload, seq, _dup_reply)
            if not execute:
                return
        try:
            if handler is None:
                raise RpcError(f"no handler for {method!r}")
            result = handler(self, payload)
            if isinstance(result, Awaitable):
                result = await result
            if self._stats is not None:
                self._stats.record_handler(method, time.perf_counter() - t0)
            if record is not None:
                result = _stamp_reply(result)
                record(MSG_RESPONSE, result)
            if seq is not None:
                await self._send([MSG_RESPONSE, seq, method, result])
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if self._stats is not None:
                self._stats.record_handler(method, time.perf_counter() - t0,
                                           error=True)
            err = f"{e}\n{traceback.format_exc()}"
            if record is not None:
                record(MSG_ERROR, err)
            if seq is not None:
                try:
                    await self._send([MSG_ERROR, seq, method, err])
                except Exception:
                    pass
            else:
                logger.exception("%s: error in notify handler %s", self.name, method)

    def _shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                try:
                    fut.set_exception(
                        ConnectionLost(f"{self.name}: connection lost"))
                except RuntimeError:
                    pass  # future's event loop already closed (teardown)
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        for cb in self._close_callbacks:
            try:
                cb()
            except Exception:
                logger.exception("close callback failed")

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
        self._shutdown()


class RpcServer:
    """Accepts connections; each gets the shared handler table."""

    def __init__(self, handlers: dict[str, Callable], name: str = "server",
                 on_connect: Callable[[Connection], None] | None = None):
        from ray_tpu_torch._private.event_stats import EventLoopStats

        self.handlers = handlers
        self.name = name
        self.on_connect = on_connect
        self._server: asyncio.AbstractServer | None = None
        self.connections: set[Connection] = set()
        self.port: int | None = None
        self.host: str | None = None
        # Same per-handler dispatch stats surface as FastRpcServer, so
        # GetEventLoopStats answers on the asyncio fallback too.
        self.stats = EventLoopStats(name)

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._server = await asyncio.start_server(self._accept, host, port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def _accept(self, reader, writer):
        conn = Connection(reader, writer, self.handlers,
                          name=f"{self.name}-peer", stats=self.stats)
        self.connections.add(conn)
        conn.on_close(lambda: self.connections.discard(conn))
        conn.start()
        if self.on_connect:
            self.on_connect(conn)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
        for conn in list(self.connections):
            await conn.close()


async def connect(host: str, port: int, handlers: dict[str, Callable] | None = None,
                  name: str = "client", timeout: float = 10.0) -> Connection:
    reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
    conn = Connection(reader, writer, handlers or {}, name=name)
    conn.start()
    return conn


async def dial(host: str, port: int, handlers=None, name: str = "client",
               timeout: float = 10.0,
               policy: RetryPolicy | None = None) -> Connection:
    """Session-layer one-shot connect with jittered-backoff retry.

    The sanctioned way (graftlint R6) to open an EPHEMERAL connection —
    peer raylets, object owners, state sweeps — where connection death
    is itself a liveness signal the caller consumes, so transparent
    reconnection (connect_session) would be wrong. Retries transient
    failures under `policy` until `timeout`; non-transient OSErrors
    (EMFILE, EACCES, ...) raise immediately instead of being swallowed
    as bring-up races.
    """
    if policy is None:
        policy = RetryPolicy(deadline_s=timeout)
    return await policy.run(
        lambda: connect(host, port, handlers, name,
                        timeout=min(2.0, timeout)),
        name=f"dial-{name}")


async def connect_retry(host: str, port: int, handlers=None, name: str = "client",
                        timeout: float = 10.0) -> Connection:
    """Retry connect until `timeout` — used during daemon bring-up races.

    Session-layer internal (graftlint R6): call sites use dial() or
    connect_session(). Now RetryPolicy-backed — jittered exponential
    backoff instead of the old busy-loop, and non-transient OSErrors
    propagate instead of masquerading as bring-up races.
    """
    return await dial(host, port, handlers, name, timeout)


class ResilientConnection:
    """A stable RPC session over reconnecting sockets.

    Drop-in for the subset of Connection the long-lived daemon channels
    use (call/notify/on_close/closed/handlers/peername/close). On socket
    death, calls block while the session redials under a jittered
    RetryPolicy; once the socket (and the caller's `on_reconnect`
    handshake) is back, un-answered stamped requests are replayed. The
    server-side reply cache makes the replay at-most-once. on_close
    callbacks fire only when the session FAILS (grace window exhausted
    or handshake permanently rejected) — a socket flap is not a close.
    close() is a deliberate teardown and does not fire them.
    """

    def __init__(self, host: str, port: int, *, handlers=None,
                 name: str = "session", grace_s: float = 30.0,
                 connect_timeout_s: float = 10.0,
                 on_reconnect=None, policy: RetryPolicy | None = None):
        self.host, self.port = host, port
        self.name = name
        self.handlers = handlers or {}
        self.session_id = uuid.uuid4().hex
        self.grace_s = grace_s
        self.connect_timeout_s = connect_timeout_s
        self.reconnects = 0
        self._on_reconnect = on_reconnect
        self._policy = policy or RetryPolicy(
            max_delay_s=1.0, deadline_s=float("inf"),
            also_transient=(ConnectionLost,))
        self._conn: Connection | None = None
        self._lock = asyncio.Lock()
        self._closed = False
        self._close_callbacks: list[Callable[[], None]] = []
        self._rseq = 0
        self._outstanding: set[int] = set()
        self._server_epoch = 0       # learned from stamped replies
        self._established_at = 0.0   # loop.time() of the last connect
        self._flap_attempts = 0      # backoff carried across quick deaths
        self._flap_started = 0.0     # grace anchor for a quick-death streak
        _session_stats["sessions_opened"] += 1

    # -- Connection-compatible surface --

    @property
    def closed(self) -> bool:
        return self._closed

    def on_close(self, cb: Callable[[], None]) -> None:
        self._close_callbacks.append(cb)

    def peername(self):
        conn = self._conn
        return conn.peername() if conn is not None else None

    async def close(self) -> None:
        """Deliberate session end: no close callbacks, no reconnect."""
        self._closed = True
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()

    # -- internals --

    def _fail(self, why: str) -> None:
        if self._closed:
            return
        self._closed = True
        _session_stats["sessions_failed"] += 1
        logger.error("%s: session failed (%s)", self.name, why)
        for cb in self._close_callbacks:
            try:
                cb()
            except Exception:
                logger.exception("%s: close callback failed", self.name)

    def _note_conn_down(self) -> None:
        # Eager redial keeps server->client pushes (Publish, CreateActor)
        # flowing even when this side has no call in flight; a failed
        # session fires the close callbacks from inside _ensure_connected.
        if not self._closed:
            supervised_task(self._ensure_connected(),
                            name=f"redial-{self.name}",
                            ignore=(ConnectionLost,))

    async def _ensure_connected(self) -> Connection:
        while True:
            conn = self._conn
            if conn is not None and not conn.closed:
                return conn
            if self._closed:
                raise ConnectionLost(f"{self.name}: session closed")
            async with self._lock:
                conn = self._conn
                if conn is not None and not conn.closed:
                    return conn
                if self._closed:
                    raise ConnectionLost(f"{self.name}: session closed")
                first = self._conn is None
                budget = self.connect_timeout_s if first else self.grace_s
                await self._redial(first, budget)

    async def _redial(self, first: bool, budget: float) -> None:
        """One reconnect cycle (lock held): dial + handshake under the
        grace budget, or fail the session."""
        loop = asyncio.get_running_loop()
        # Accept-then-close detection: if the connection this cycle is
        # replacing died younger than _MIN_STABLE_S, the "successful"
        # reconnects aren't real — keep backing off (and keep the grace
        # clock running) across cycles instead of resetting per cycle.
        if self._established_at and \
                loop.time() - self._established_at < _MIN_STABLE_S:
            if not self._flap_attempts:
                self._flap_started = loop.time()
            self._flap_attempts += 1
        else:
            self._flap_attempts = 0
        attempt = self._flap_attempts
        deadline = (self._flap_started if attempt else loop.time()) + budget
        # One quick death is a normal restart race; a STREAK of them is
        # the accept-then-close pattern — only then pre-delay the dial.
        if attempt >= 2:
            d = self._policy.delay(attempt - 1)
            if loop.time() + d > deadline:
                self._fail(f"flapping (accept-then-close) for {budget:.0f}s")
                raise ConnectionLost(
                    f"{self.name}: reconnect window exhausted")
            await asyncio.sleep(d)
        while True:
            try:
                conn = await connect(
                    self.host, self.port, self.handlers, name=self.name,
                    timeout=min(2.0, max(0.1, deadline - loop.time())))
                try:
                    if not first and self._on_reconnect is not None:
                        await self._on_reconnect(conn)
                except BaseException:
                    await conn.close()
                    raise
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if not self._policy.is_transient(e) \
                        and not isinstance(e, asyncio.TimeoutError):
                    # Permanent rejection (e.g. re-registration refused):
                    # the peer answered and said no. Fail fast.
                    self._fail(f"handshake rejected: {e}")
                    raise ConnectionLost(
                        f"{self.name}: session rejected: {e}") from e
                d = self._policy.delay(attempt)
                attempt += 1
                self._flap_attempts = attempt
                if loop.time() + d > deadline:
                    self._fail(f"unreachable for {budget:.0f}s: {e}")
                    raise ConnectionLost(
                        f"{self.name}: reconnect window exhausted") from e
                await asyncio.sleep(d)
                continue
            self._conn = conn
            self._established_at = loop.time()
            conn.on_close(self._note_conn_down)
            if not first:
                self.reconnects += 1
                _session_stats["reconnects_total"] += 1
                logger.info("%s: session re-established (reconnect #%d)",
                            self.name, self.reconnects)
            return

    def _acked_watermark(self) -> int:
        # Highest rseq below which every request saw its reply: safe for
        # the server to prune. The current call's own rseq is still in
        # _outstanding, so the watermark never acks an open request.
        if self._outstanding:
            return min(self._outstanding) - 1
        return self._rseq

    async def call(self, method: str, payload=None,
                   timeout: float | None = None):
        if self._closed:
            raise ConnectionLost(f"{self.name}: session closed")
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        stamped = None
        rseq = 0
        if method not in SESSION_EXEMPT_METHODS \
                and (payload is None or isinstance(payload, dict)):
            self._rseq += 1
            rseq = self._rseq
            stamped = dict(payload or {})
            stamped[_SID_KEY] = self.session_id
            stamped[_RSEQ_KEY] = rseq
            self._outstanding.add(rseq)
        sent_once = False
        try:
            while True:
                conn = await self._ensure_connected()
                if stamped is not None:
                    stamped[_ACK_KEY] = self._acked_watermark()
                    if sent_once and self._server_epoch:
                        # Replay: echo the incarnation the ORIGINAL send
                        # may have executed under, so a restarted server
                        # (lost reply cache) rejects deterministically
                        # instead of re-executing. Fresh sends stay
                        # unstamped — new work is always welcome.
                        stamped[_EPOCH_KEY] = self._server_epoch
                if sent_once:
                    _session_stats["replayed_requests_total"] += 1
                sent_once = True
                try:
                    att = None if deadline is None \
                        else max(0.01, deadline - loop.time())
                    result = await conn.call(
                        method, stamped if stamped is not None else payload,
                        timeout=att)
                    if isinstance(result, dict) and _EPOCH_KEY in result:
                        self._server_epoch = result.pop(_EPOCH_KEY)
                    return result
                except ConnectionLost:
                    if self._closed:
                        raise
                    # Exempt methods are replay-safe by construction
                    # (idempotent native KV / pubsub), stamped methods by
                    # the reply cache — loop and replay either way.
                    continue
        finally:
            if stamped is not None:
                self._outstanding.discard(rseq)

    async def notify(self, method: str, payload=None) -> None:
        conn = await self._ensure_connected()
        await conn.notify(method, payload)


async def connect_session(host: str, port: int, *, handlers=None,
                          name: str = "session", grace_s: float = 30.0,
                          connect_timeout_s: float = 10.0,
                          on_reconnect=None,
                          policy: RetryPolicy | None = None
                          ) -> ResilientConnection:
    """Open a ResilientConnection and perform the initial dial.

    The sanctioned way (graftlint R6) to hold a LONG-LIVED daemon
    channel (raylet->GCS, worker->GCS, monitor->GCS): socket death is
    retried for `grace_s` per outage before the session — and only then
    the caller's on_close — gives up. `on_reconnect(conn)` runs on every
    re-established socket BEFORE queued calls resume, so re-registration
    and re-subscription happen ahead of any replayed request. grace_s=0
    keeps the old semantics: first socket death closes the session.
    """
    sess = ResilientConnection(
        host, port, handlers=handlers, name=name, grace_s=grace_s,
        connect_timeout_s=connect_timeout_s, on_reconnect=on_reconnect,
        policy=policy)
    await sess._ensure_connected()
    return sess
