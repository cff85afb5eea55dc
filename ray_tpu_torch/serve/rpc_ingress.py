"""Binary (msgpack-RPC) Serve ingress, the second protocol beside HTTP.
Port of ray_tpu/serve/rpc_ingress.py (reference: the proxy serves HTTP
and gRPC on every node, serve/_private/proxy.py:13-38). The binary
protocol is the runtime's own length-prefixed msgpack RPC framing
(_private/rpc.py, over the port's vendored msgpack).

Wire protocol (all msgpack):
  request  "ServeCall"   {"deployment": str | None, "route": str | None,
                          "payload": value, "stream_id": str | None}
  reply                  {"ok": True, "result": value}            (unary)
                         {"ok": True, "stream": id}           (streaming)
                         {"ok": False, "error": str}
  notifies (streaming)   "ServeStreamChunk" {"stream": id, "chunk": v}
                         "ServeStreamEnd"   {"stream": id}
                         "ServeStreamError" {"stream": id, "error": str}
  request  "ServeStreamClose" {"stream": id}   - client stops early

Routing matches the HTTP proxy: an explicit deployment name, else the
longest matching route prefix from the controller's route table.
"""

from __future__ import annotations

import asyncio
import logging
import threading

from ray_tpu_torch._private import rpc

logger = logging.getLogger(__name__)


class RpcIngress:
    """One binary ingress server (runs beside the HTTP proxy)."""

    def __init__(self):
        self._server = rpc.RpcServer({
            "ServeCall": self._call,
            "ServeStreamClose": self._stream_close,
            "Ping": lambda conn, p: {"ok": True},
        }, name="serve-rpc")
        self._loop: asyncio.AbstractEventLoop | None = None
        self._streams: dict[str, object] = {}  # id -> replica generator
        self.port: int | None = None

    def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        started = threading.Event()

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def go():
                _, self.port = await self._server.start(host, port)
                started.set()

            self._loop.run_until_complete(go())
            self._loop.run_forever()

        threading.Thread(target=run, daemon=True,
                         name="serve-rpc-ingress").start()
        if not started.wait(10.0) or self.port is None:
            raise RuntimeError("serve rpc ingress failed to start")
        return self.port

    def _resolve(self, payload):
        from ray_tpu_torch.serve import _ProxyHandler, get_deployment_handle

        name = payload.get("deployment")
        if not name:
            route = payload.get("route") or "/"
            best_len = -1
            for prefix, dep in _ProxyHandler._route_table().items():
                if (route == prefix
                        or route.startswith(prefix.rstrip("/") + "/")
                        or prefix == "/") and len(prefix) > best_len:
                    name, best_len = dep, len(prefix)
            if name is None:
                name = route.strip("/").split("/")[0]
        handle = _ProxyHandler.handles.get(name)
        if handle is None:
            handle = _ProxyHandler.handles[name] = get_deployment_handle(name)
        return handle

    async def _call(self, conn, payload):
        try:
            handle = await asyncio.to_thread(self._resolve, payload)
        except Exception as e:  # unknown deployment etc.
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        body = payload.get("payload")
        stream_id = payload.get("stream_id")
        if stream_id:
            loop = asyncio.get_running_loop()

            def pump():
                gen = None
                try:
                    gen = handle.options(stream=True).remote(body)
                    self._streams[stream_id] = gen
                    for chunk in gen:
                        if stream_id not in self._streams or conn.closed:
                            gen.cancel()
                            return
                        asyncio.run_coroutine_threadsafe(
                            conn.notify("ServeStreamChunk",
                                        {"stream": stream_id,
                                         "chunk": chunk}), loop).result(30)
                    asyncio.run_coroutine_threadsafe(
                        conn.notify("ServeStreamEnd", {"stream": stream_id}),
                        loop).result(30)
                except Exception as e:  # noqa: BLE001
                    try:
                        asyncio.run_coroutine_threadsafe(
                            conn.notify("ServeStreamError",
                                        {"stream": stream_id,
                                         "error": f"{e}"}), loop).result(30)
                    except Exception:
                        pass
                    if gen is not None:
                        try:
                            gen.cancel()
                        except Exception:
                            pass
                finally:
                    self._streams.pop(stream_id, None)

            threading.Thread(target=pump, daemon=True,
                             name=f"serve-rpc-stream-{stream_id[:8]}").start()
            return {"ok": True, "stream": stream_id}
        try:
            result = await asyncio.to_thread(
                lambda: handle.remote(body).result(timeout=60))
            return {"ok": True, "result": result}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    async def _stream_close(self, conn, payload):
        gen = self._streams.pop(payload.get("stream"), None)
        if gen is not None:
            try:
                gen.cancel()
            except Exception:
                pass
        return {"ok": True}

    def stop(self):
        if self._loop is not None:
            try:
                asyncio.run_coroutine_threadsafe(
                    self._server.stop(), self._loop).result(10.0)
            except Exception:
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop = None


class RpcIngressClient:
    """A minimal client of the binary ingress, for callers that do not
    speak HTTP."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        import queue as _queue
        import uuid as _uuid

        self._uuid = _uuid
        self._queue_mod = _queue
        self._streams: dict[str, _queue.Queue] = {}
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True, name="serve-rpc-client")
        self._thread.start()
        self._conn = asyncio.run_coroutine_threadsafe(
            rpc.dial(host, port, handlers={
                "ServeStreamChunk": self._on_stream,
                "ServeStreamEnd": self._on_stream,
                "ServeStreamError": self._on_stream,
            }, name="serve-rpc-client", timeout=timeout),
            self._loop).result(timeout + 5)

    async def _on_stream(self, conn, payload):
        q = self._streams.get(payload["stream"])
        if q is None:
            return
        if "chunk" in payload:
            q.put(("chunk", payload["chunk"]))
        elif "error" in payload:
            q.put(("error", payload["error"]))
        else:
            q.put(("end", None))

    def _rpc(self, method, payload, timeout=70.0):
        return asyncio.run_coroutine_threadsafe(
            self._conn.call(method, payload, timeout=timeout),
            self._loop).result(timeout + 5)

    def call(self, payload, *, deployment: str | None = None,
             route: str | None = None, timeout: float = 70.0):
        resp = self._rpc("ServeCall", {"deployment": deployment,
                                       "route": route, "payload": payload},
                         timeout=timeout)
        if not resp["ok"]:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def stream(self, payload, *, deployment: str | None = None,
               route: str | None = None):
        """Yield chunks from a streaming deployment call."""
        stream_id = self._uuid.uuid4().hex[:16]
        self.last_stream_id = stream_id
        q = self._queue_mod.Queue()
        self._streams[stream_id] = q
        resp = self._rpc("ServeCall", {"deployment": deployment,
                                       "route": route, "payload": payload,
                                       "stream_id": stream_id})
        if not resp.get("ok"):
            self._streams.pop(stream_id, None)
            raise RuntimeError(resp.get("error", "stream start failed"))
        try:
            while True:
                kind, val = q.get(timeout=120)
                if kind == "chunk":
                    yield val
                elif kind == "end":
                    return
                else:
                    raise RuntimeError(val)
        finally:
            self._streams.pop(stream_id, None)

    def close_stream(self, stream_id: str):
        try:
            self._rpc("ServeStreamClose", {"stream": stream_id}, timeout=10)
        except Exception:
            pass

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(
                self._conn.close(), self._loop).result(5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(5)
