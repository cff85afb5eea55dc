"""Daemon-side RPC server over the native fastpath pump.

Drop-in replacement for rpc.RpcServer (same wire protocol, same handler
signature `handler(conn, payload)`) whose IO plane is csrc/fastpath.cc:
accept, 4-byte-BE msgpack framing, read buffering, and writev-coalesced
sends all happen on one native epoll thread. The asyncio loop touches the
path once per *batch* (eventfd add_reader → fpump_drain), not once per
frame, and responses go out with a single non-blocking fpump_send — no
StreamWriter, no per-frame drain() hop.

This is the step of moving the daemons (raylet, GCS) onto the
native pump (reference analog: gcs_server.h:79 and node_manager.cc:1778
run on C++ gRPC/asio event loops end-to-end). Python keeps the protocol
logic; every syscall on the lease/return/pin and GCS-table paths is
native.

Sync handlers (plain functions) complete inline in the drain callback —
no task spawn per request. Async handlers are scheduled exactly like
rpc.Connection._dispatch would.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import traceback
from typing import Awaitable, Callable

from ray_tpu_torch._private import native_policy, rpc
from ray_tpu_torch._private.common import supervised_task
from ray_tpu_torch._private.event_stats import EventLoopStats
from ray_tpu_torch._private.native_fastpath import (EV_ACCEPT, EV_CLOSE, EV_FRAME,
                                              EV_INJECT)
from ray_tpu_torch._private.rpc import (MSG_ERROR, MSG_NOTIFY, MSG_REQUEST,
                                  MSG_RESPONSE, ConnectionLost, RpcError,
                                  pack, unpack)

logger = logging.getLogger(__name__)


class FastConn:
    """Server side of one accepted pump connection.

    Interface-compatible with the subset of rpc.Connection the daemons
    use on accepted conns: call/notify/on_close/closed/handlers/peername.
    """

    def __init__(self, server: "FastRpcServer", conn_id: int):
        self._server = server
        self._conn_id = conn_id
        self.handlers = server.handlers  # shared, like RpcServer accepts
        self.name = f"{server.name}-peer{conn_id}"
        self._seq = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self._close_callbacks: list[Callable[[], None]] = []

    @property
    def closed(self) -> bool:
        return self._closed

    def peername(self):
        return None  # the pump doesn't surface peer addresses

    def on_close(self, cb: Callable[[], None]) -> None:
        self._close_callbacks.append(cb)

    def _send_frame(self, frame: list) -> bool:
        return self._server._send(self._conn_id, frame)

    async def call(self, method: str, payload=None,
                   timeout: float | None = None):
        if self._closed:
            raise ConnectionLost(f"{self.name}: connection closed")
        self._seq += 1
        seq = self._seq
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        try:
            if not self._send_frame([MSG_REQUEST, seq, method, payload]):
                raise ConnectionLost(f"{self.name}: send failed")
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(seq, None)

    async def notify(self, method: str, payload=None) -> None:
        if self._closed:
            raise ConnectionLost(f"{self.name}: connection closed")
        if not self._send_frame([MSG_NOTIFY, 0, method, payload]):
            raise ConnectionLost(f"{self.name}: send failed")

    async def close(self) -> None:
        self._server._close_conn(self._conn_id)

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
                    pass
        self._pending.clear()
        for cb in self._close_callbacks:
            try:
                cb()
            except Exception:
                logger.exception("close callback failed")


class FastRpcServer:
    """RpcServer-compatible daemon server on the native frame pump."""

    def __init__(self, handlers: dict[str, Callable], name: str = "server",
                 on_connect: Callable | None = None):
        self.handlers = handlers
        self.name = name
        self.on_connect = on_connect
        self.connections: set[FastConn] = set()
        self.port: int | None = None
        self.host: str | None = None
        # Optional in-pump native service (daemon protocol logic in C++,
        # e.g. the GCS KV/pubsub handlers — csrc/gcs_service.cc): a
        # callable(pump) -> service|None installed by the daemon BEFORE
        # start(); it runs between pump creation and listen() so the
        # loop thread sees the hook before any frame arrives.
        self.service_factory = None
        self.native_service = None
        # EV_INJECT consumer: callable(token, body) for events a native
        # service pushes into the pump FIFO (fpump_inject) to mirror
        # natively-handled control decisions back into Python state.
        self.inject_handler = None
        # Per-handler dispatch latency + drain batch stats (analogue of
        # the reference's event_stats.h around its asio loop posts).
        self.stats = EventLoopStats(name)
        self._pump = None
        self._conns: dict[int, FastConn] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stopped = False
        self._inflight: set = set()  # strong refs to in-flight dispatches

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch._private import native_fastpath

        pump = native_fastpath.FastPump()
        if self.service_factory is not None:
            try:
                self.native_service = self.service_factory(pump)
            except BaseException:
                # The factory closed what it made; the pump never
                # listened, so nothing can have reached it.
                pump.close()
                raise
        # port=0 picks an ephemeral port; a fixed port (GCS
        # restart-on-same-port) binds with SO_REUSEADDR.
        self.port = pump.listen(host, port)
        self.host = host
        self._pump = pump
        self._loop = asyncio.get_running_loop()
        pump.arm_eventfd(True)
        self._loop.add_reader(pump.eventfd, self._on_events)
        return self.host, self.port

    # ---- event plumbing ----

    def _on_events(self) -> None:
        try:
            os.read(self._pump.eventfd, 8)
        except (OSError, ValueError):
            pass
        # A push racing this drain re-bumps the eventfd, so the reader
        # re-fires — but FastPump.drain() stops at max_events with the
        # rest STRANDED behind the already-zeroed fd (nothing re-bumps on
        # pop), so keep draining until a short batch proves the queue is
        # empty.
        while True:
            events = self._pump.drain(max_events=512)
            if events:
                self.stats.record_drain(len(events))
            for ev in events:
                self._handle_event(ev)
            if len(events) < 512:
                return

    def _handle_event(self, ev) -> None:
        kind, conn_id, body = ev
        if kind == EV_FRAME:
            conn = self._conns.get(conn_id)
            if conn is not None:
                self._on_frame(conn, body)
        elif kind == EV_ACCEPT:
            conn = FastConn(self, conn_id)
            self._conns[conn_id] = conn
            self.connections.add(conn)
            if self.on_connect:
                try:
                    self.on_connect(conn)
                except Exception:
                    logger.exception("%s: on_connect failed", self.name)
        elif kind == EV_CLOSE:
            conn = self._conns.pop(conn_id, None)
            if conn is not None:
                self.connections.discard(conn)
                conn._shutdown()
        elif kind == EV_INJECT:
            # conn_id slot carries the inject token, not a connection.
            if self.inject_handler is not None:
                try:
                    self.inject_handler(conn_id, body)
                except Exception:
                    logger.exception("%s: inject handler failed",
                                     self.name)

    def _on_frame(self, conn: FastConn, body: bytes) -> None:
        try:
            msg_type, seq, method, payload = unpack(body)
        except Exception:
            logger.exception("%s: bad frame", self.name)
            return
        if msg_type == MSG_REQUEST:
            self._dispatch(conn, seq, method, payload)
        elif msg_type == MSG_NOTIFY:
            self._dispatch(conn, None, method, payload)
        elif msg_type in (MSG_RESPONSE, MSG_ERROR):
            fut = conn._pending.get(seq)
            if fut is not None and not fut.done():
                if msg_type == MSG_RESPONSE:
                    fut.set_result(payload)
                else:
                    fut.set_exception(RpcError(payload))

    def _dispatch(self, conn: FastConn, seq, method: str, payload) -> None:
        handler = conn.handlers.get(method)
        t0 = time.perf_counter()
        record = None
        if isinstance(payload, dict) and rpc._SID_KEY in payload:
            # Session-stamped request: consult the shared reply cache so
            # a replayed mutating RPC answers from cache instead of
            # executing twice (see rpc.SessionManager).
            def _dup_reply(kind, value, _cid=conn._conn_id, _seq=seq,
                           _method=method):
                self._send(_cid, [kind, _seq, _method, value])

            execute, record, payload = rpc._session_intercept(
                payload, seq, _dup_reply)
            if not execute:
                return
        try:
            if handler is None:
                raise RpcError(f"no handler for {method!r}")
            result = handler(conn, payload)
        except Exception as e:
            self.stats.record_handler(method, time.perf_counter() - t0,
                                      error=True)
            self._reply_error(conn, seq, method, e, record)
            return
        if isinstance(result, Awaitable):
            # supervised_task holds the strong ref in _inflight (raw
            # create_task keeps only a weak one) and logs any exception
            # that escapes _finish's own handling.
            supervised_task(
                self._finish(conn, seq, method, result, t0, record),
                name=f"dispatch-{method}", tasks=self._inflight)
            self.stats.set_queue_depth(len(self._inflight))
        else:
            self.stats.record_handler(method, time.perf_counter() - t0)
            if record is not None:
                result = rpc._stamp_reply(result)
                record(MSG_RESPONSE, result)
            if seq is not None:
                self._send(conn._conn_id,
                           [MSG_RESPONSE, seq, method, result])

    async def _finish(self, conn: FastConn, seq, method: str, coro,
                      t0: float, record=None) -> None:
        try:
            result = await coro
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.stats.record_handler(method, time.perf_counter() - t0,
                                      error=True)
            self._reply_error(conn, seq, method, e, record)
            return
        finally:
            self.stats.set_queue_depth(max(0, len(self._inflight) - 1))
        self.stats.record_handler(method, time.perf_counter() - t0)
        if record is not None:
            result = rpc._stamp_reply(result)
            record(MSG_RESPONSE, result)
        if seq is not None:
            self._send(conn._conn_id, [MSG_RESPONSE, seq, method, result])

    def _reply_error(self, conn: FastConn, seq, method: str, e: Exception,
                     record=None):
        err = f"{e}\n{traceback.format_exc()}"
        if record is not None:
            record(MSG_ERROR, err)
        if seq is not None:
            self._send(conn._conn_id, [MSG_ERROR, seq, method, err])
        else:
            logger.error("%s: error in notify handler %s: %s",
                         self.name, method, e)

    def _send(self, conn_id: int, frame: list) -> bool:
        if self._pump is None:
            return False
        return self._pump.send(conn_id, pack(frame))

    def _close_conn(self, conn_id: int) -> None:
        conn = self._conns.pop(conn_id, None)
        if conn is not None:
            self.connections.discard(conn)
            conn._shutdown()
        if self._pump is not None:
            self._pump.close_conn(conn_id)

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._loop is not None and self._pump is not None:
            try:
                self._loop.remove_reader(self._pump.eventfd)
            except Exception:
                pass
        # In-flight async dispatches would otherwise keep running against
        # torn-down state and surface as pending-task noise at loop close.
        for task in list(self._inflight):
            task.cancel()
        if self._inflight:
            await asyncio.wait(list(self._inflight), timeout=2)
        self._inflight.clear()
        for conn in list(self.connections):
            conn._shutdown()
        self.connections.clear()
        self._conns.clear()
        if self._pump is not None:
            self._pump.close()
            self._pump = None
        # Destroy the native service only after the pump loop thread is
        # joined (close() above) — it must never run the frame hook
        # against a freed service.
        if self.native_service is not None:
            self.native_service.close()
            self.native_service = None


def make_server(handlers: dict[str, Callable], name: str = "server",
                on_connect: Callable | None = None):
    """Return a FastRpcServer, or the asyncio RpcServer when
    RAY_TPU_TORCH_NATIVE_CONTROL is off — daemons call this and stay
    agnostic. A pump that does not build raises at start()."""
    if native_policy.native_control_on():
        return FastRpcServer(handlers, name=name, on_connect=on_connect)
    return rpc.RpcServer(handlers, name=name, on_connect=on_connect)
