"""The port's FastRpcServer (daemon RPC over the native pump), by the
reference's own tests (tests/test_fast_rpc.py).

The daemons exercise this end-to-end constantly; these tests pin the
module's own contracts — wire compatibility with rpc.Connection
clients, sync/async handler dispatch, error frames, server->client
calls, close semantics, and the >512-events-per-wake drain (where
events could strand: fpump_drain caps a batch and nothing re-bumps
the eventfd for the remainder)."""

import asyncio

import pytest

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.fast_rpc import FastRpcServer, make_server


def run(coro):
    return asyncio.run(coro)


def test_sync_and_async_handlers_roundtrip():
    async def main():
        calls = []

        def sync_echo(conn, payload):
            calls.append("sync")
            return {"echo": payload["x"]}

        async def async_add(conn, payload):
            await asyncio.sleep(0.01)
            return payload["a"] + payload["b"]

        server = FastRpcServer({"Echo": sync_echo, "Add": async_add},
                               name="t")
        host, port = await server.start()
        try:
            conn = await rpc.connect(host, port)
            assert await conn.call("Echo", {"x": 7}) == {"echo": 7}
            assert await conn.call("Add", {"a": 2, "b": 3}) == 5
            assert calls == ["sync"]
            with pytest.raises(rpc.RpcError, match="no handler"):
                await conn.call("Nope", {})
            await conn.close()
        finally:
            await server.stop()

    run(main())


def test_handler_exception_becomes_error_frame():
    async def main():
        def boom(conn, payload):
            raise ValueError("kapow")

        server = FastRpcServer({"Boom": boom}, name="t")
        host, port = await server.start()
        try:
            conn = await rpc.connect(host, port)
            with pytest.raises(rpc.RpcError, match="kapow"):
                await conn.call("Boom", {})
            # The connection survives an error frame.
            with pytest.raises(rpc.RpcError, match="kapow"):
                await conn.call("Boom", {})
            await conn.close()
        finally:
            await server.stop()

    run(main())


def test_server_initiated_call_to_client():
    async def main():
        accepted = []
        server = FastRpcServer({}, name="t",
                               on_connect=accepted.append)
        host, port = await server.start()
        try:
            conn = await rpc.connect(
                host, port, handlers={"Ping": lambda c, p: {"pong": p}})
            # Wait for the accept event to surface server-side.
            for _ in range(100):
                if accepted:
                    break
                await asyncio.sleep(0.01)
            sconn = accepted[0]
            out = await sconn.call("Ping", 42, timeout=5)
            assert out == {"pong": 42}
            await conn.close()
        finally:
            await server.stop()

    run(main())


def test_burst_beyond_drain_cap():
    """>512 notifies in one burst: every one must dispatch even though
    fpump_drain caps a batch at 512 and pops do not re-bump the eventfd
    (the strand)."""
    async def main():
        seen = []

        def note(conn, payload):
            seen.append(payload)

        server = FastRpcServer({"N": note}, name="t")
        host, port = await server.start()
        try:
            conn = await rpc.connect(host, port)
            n = 1500
            for i in range(n):
                await conn.notify("N", i)
            deadline = asyncio.get_running_loop().time() + 15
            while len(seen) < n and \
                    asyncio.get_running_loop().time() < deadline:
                await asyncio.sleep(0.02)
            assert len(seen) == n, f"stranded events: {len(seen)}/{n}"
            assert seen == list(range(n))  # FIFO preserved
            await conn.close()
        finally:
            await server.stop()

    run(main())


def test_close_fails_pending_calls():
    async def main():
        async def hang(conn, payload):
            await asyncio.sleep(30)

        server = FastRpcServer({"Hang": hang}, name="t")
        host, port = await server.start()
        conn = await rpc.connect(host, port)
        fut = asyncio.ensure_future(conn.call("Hang", {}, timeout=20))
        await asyncio.sleep(0.1)
        await server.stop()  # cancels in-flight dispatch, drops conns
        with pytest.raises((rpc.ConnectionLost, rpc.RpcError,
                            asyncio.TimeoutError)):
            await asyncio.wait_for(fut, 5)
        await conn.close()

    run(main())


def test_make_server_defaults_to_native_pump(monkeypatch):
    """The daemons' server is the native pump, and the workers' task loop
    too, unless RAY_TPU_TORCH_NATIVE_CONTROL=0 asks for the Python
    control path: that one switch turns both off."""
    from ray_tpu_torch._private.config import Config

    monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL", raising=False)
    assert isinstance(make_server({}, name="t"), FastRpcServer)
    assert Config().fastpath
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "0")
    assert type(make_server({}, name="t")) is rpc.RpcServer
    assert not Config().fastpath


# What loads each native library (a constructor, or the loader where the
# object needs a pump first).
_BUILDS = {
    "native_fastpath": lambda m, tmp: m.FastPump(),
    "native_scheduler": lambda m, tmp: m.ClusterScheduler(),
    "native_raylet_core": lambda m, tmp: m.RayletResourceCore({"CPU": 1}),
    "native_gcs_store": lambda m, tmp: m.GcsTableStore(str(tmp / "wal")),
    "native_gcs_service": lambda m, tmp: m._load(),
    "native_actor_plane": lambda m, tmp: m._load(),
    "native_lease_plane": lambda m, tmp: m._load(),
    "native_transfer": lambda m, tmp: m.TransferServer(str(tmp / "store")),
}


@pytest.mark.parametrize("module", sorted(_BUILDS))
def test_failed_build_raises(module, tmp_path, monkeypatch):
    """A native piece that does not build (CXX=false on a fresh build
    directory) raises where it is loaded: nothing runs Python in its
    place."""
    import importlib

    from ray_tpu_torch._private import native_build

    mod = importlib.import_module(f"ray_tpu_torch._private.{module}")
    monkeypatch.setattr(native_build, "LIB_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        _BUILDS[module](mod, tmp_path)


def test_failed_build_fails_daemon_server_start(tmp_path, monkeypatch):
    """The default daemon server is the native pump; when its library
    does not build, start() raises instead of serving on asyncio."""
    from ray_tpu_torch._private import native_build, native_fastpath

    monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL", raising=False)
    monkeypatch.setattr(native_build, "LIB_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native_fastpath, "_lib", None)
    monkeypatch.setenv("CXX", "false")

    async def main():
        server = make_server({}, name="t")
        with pytest.raises(RuntimeError, match="libtorchfastpath.so"):
            await server.start()

    run(main())
