"""The port's native in-pump GCS service
(ray_tpu_torch/_private/csrc/gcs_service.cc), by the reference's own e2e
tests (tests/test_native_gcs_service.py).

The service executes the GCS's KV and pubsub protocol entirely on the
fastpath pump's C++ loop thread; these tests drive it through REAL
rpc.Connection clients against a REAL GcsServer, asserting (a) the
semantics match the Python handlers exactly, (b) the frames were in
fact handled natively (service counters), and (c) rows persist across
restarts in both directions — native-written state restores under the
Python path (RAY_TPU_TORCH_NATIVE_CONTROL=0) and vice versa (the row format is byte-compatible by
construction: hex(msgpack([ns, key])) -> msgpack(value)).

Reference analog: gcs_kv_manager.cc HandleInternalKVPut and
pubsub_handler.cc dispatched on the gcs_server C++ event loop
(gcs_server.h:79).
"""

import asyncio

import pytest

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.gcs import GcsServer


def run(coro):
    return asyncio.run(coro)


async def _start_gcs(tmp_path=None):
    gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state")
                    if tmp_path else None)
    host, port = await gcs.start()
    return gcs, host, port


def test_kv_semantics_native(tmp_path):
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            assert gcs._native_svc is not None, \
                "native service should be active under the pump server"
            conn = await rpc.connect(host, port)

            r = await conn.call("KVPut", {"ns": "fn", "key": b"k1",
                                          "value": b"v1"})
            assert r == {"added": True}
            r = await conn.call("KVPut", {"ns": "fn", "key": b"k1",
                                          "value": b"zz",
                                          "overwrite": False})
            assert r == {"added": False}
            r = await conn.call("KVGet", {"ns": "fn", "key": b"k1"})
            assert r == {"value": b"v1"}
            r = await conn.call("KVGet", {"ns": "fn", "key": b"nope"})
            assert r == {"value": None}
            r = await conn.call("KVExists", {"ns": "fn", "key": b"k1"})
            assert r == {"exists": True}
            await conn.call("KVPut", {"ns": "fn", "key": b"k2",
                                      "value": b"v2"})
            await conn.call("KVPut", {"ns": "other", "key": b"k3",
                                      "value": b"v3"})
            r = await conn.call("KVKeys", {"ns": "fn", "prefix": b"k"})
            assert sorted(r["keys"]) == [b"k1", b"k2"]
            r = await conn.call("KVKeys", {"ns": "fn", "prefix": b"zzz"})
            assert r["keys"] == []
            r = await conn.call("KVDel", {"ns": "fn", "key": b"k1"})
            assert r == {"deleted": True}
            r = await conn.call("KVDel", {"ns": "fn", "key": b"k1"})
            assert r == {"deleted": False}
            r = await conn.call("KVGet", {"ns": "fn", "key": b"k1"})
            assert r == {"value": None}

            # All of the above were handled in C++ — Python never saw
            # the frames, and self.kv stayed empty.
            handled, appends, fails = gcs._native_svc.counters()
            assert handled >= 10
            assert appends >= 4   # 3 puts + 1 effective delete
            assert fails == 0
            assert gcs.kv == {}
            n_ns, n_rows = gcs._native_svc.kv_stats()
            assert (n_ns, n_rows) == (2, 2)   # fn:k2, other:k3
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def test_pubsub_native_fanout(tmp_path):
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            sub1 = await rpc.connect(host, port)
            sub2 = await rpc.connect(host, port)
            pub = await rpc.connect(host, port)
            got1, got2 = [], []
            ev1, ev2 = asyncio.Event(), asyncio.Event()

            def on_pub(sink, ev):
                def h(conn, payload):
                    sink.append(payload)
                    ev.set()
                return h

            sub1.handlers["Publish"] = on_pub(got1, ev1)
            sub2.handlers["Publish"] = on_pub(got2, ev2)
            assert (await sub1.call("Subscribe",
                                    {"channels": ["X"]}))["ok"]
            assert (await sub2.call("Subscribe",
                                    {"channels": ["X", "Y"]}))["ok"]
            assert gcs._native_svc.sub_count("X") == 2
            assert gcs._native_svc.sub_count("Y") == 1

            # External publish RPC: native fanout to both.
            r = await pub.call("Publish", {"channel": "X",
                                           "message": {"n": 1}})
            assert r == {"ok": True}
            await asyncio.wait_for(ev1.wait(), 5)
            await asyncio.wait_for(ev2.wait(), 5)
            assert got1 == [{"channel": "X", "message": {"n": 1}}]
            assert got2 == [{"channel": "X", "message": {"n": 1}}]

            # Internal publish (the path actor/node/PG state changes
            # use): routed through the native fanout too.
            ev2.clear()
            await gcs.publish("Y", {"n": 2})
            await asyncio.wait_for(ev2.wait(), 5)
            assert got2[-1] == {"channel": "Y", "message": {"n": 2}}
            # Python-side subscriber table stayed empty: the
            # subscriptions live in the native service.
            assert not any(gcs.subscribers.values())

            # Disconnect cleans native subscriber state.
            await sub2.close()
            for _ in range(100):
                if gcs._native_svc.sub_count("X") == 1:
                    break
                await asyncio.sleep(0.02)
            assert gcs._native_svc.sub_count("X") == 1
            assert gcs._native_svc.sub_count("Y") == 0
            await sub1.close()
            await pub.close()
        finally:
            await gcs.stop()

    run(main())


def test_restart_restores_native_rows(tmp_path):
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        conn = await rpc.connect(host, port)
        await conn.call("KVPut", {"ns": "fn", "key": b"pk",
                                  "value": b"pv"})
        await conn.call("KVPut", {"ns": "", "key": b"root",
                                  "value": b"rv"})
        await conn.close()
        await gcs.stop()

        gcs2, host2, port2 = await _start_gcs(tmp_path)
        try:
            assert gcs2._native_svc is not None
            assert gcs2._native_svc.kv_stats()[1] == 2
            conn2 = await rpc.connect(host2, port2)
            assert (await conn2.call("KVGet", {"ns": "fn",
                                               "key": b"pk"}))["value"] \
                == b"pv"
            assert (await conn2.call("KVGet",
                                     {"key": b"root"}))["value"] == b"rv"
            await conn2.close()
        finally:
            await gcs2.stop()

    run(main())


def test_cross_compat_python_and_native_rows(tmp_path, monkeypatch):
    """Rows written by the Python fallback restore under the native
    service and vice versa — the store format is shared."""
    async def write_python_side():
        monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "0")
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            assert gcs._native_svc is None
            conn = await rpc.connect(host, port)
            await conn.call("KVPut", {"ns": "compat", "key": b"from-py",
                                      "value": b"py-val"})
            await conn.close()
        finally:
            await gcs.stop()
        monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL")

    async def native_reads_then_writes():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            assert gcs._native_svc is not None
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "compat",
                          "key": b"from-py"}))["value"] == b"py-val"
            await conn.call("KVPut", {"ns": "compat", "key": b"from-c",
                                      "value": b"c-val"})
            await conn.close()
        finally:
            await gcs.stop()

    async def python_reads_native_row():
        monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "0")
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "compat",
                          "key": b"from-c"}))["value"] == b"c-val"
            assert (await conn.call(
                "KVGet", {"ns": "compat",
                          "key": b"from-py"}))["value"] == b"py-val"
            await conn.close()
        finally:
            await gcs.stop()
        monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL")

    run(write_python_side())
    run(native_reads_then_writes())
    run(python_reads_native_row())


def test_malformed_known_method_errors_not_passthrough(tmp_path):
    """A malformed payload for a method the native service owns must
    come back as an RpcError — passing it to Python would answer from
    the (empty) Python tables and silently diverge."""
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            await conn.call("KVPut", {"ns": "x", "key": b"k",
                                      "value": b"v"})
            with pytest.raises(rpc.RpcError, match="malformed"):
                await conn.call("KVGet", {"ns": "x"})   # no "key"
            assert gcs._native_svc.proto_errors() == 1
            # The well-formed path still works afterwards.
            assert (await conn.call(
                "KVGet", {"ns": "x", "key": b"k"}))["value"] == b"v"
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def test_idempotent_reput_skips_wal(tmp_path):
    """Re-putting an identical value must not append to the WAL
    (parity with the Python write-through's hash-diff dedup)."""
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            await conn.call("KVPut", {"ns": "x", "key": b"k",
                                      "value": b"v"})
            appends_before = gcs._native_svc.counters()[1]
            for _ in range(5):
                r = await conn.call("KVPut", {"ns": "x", "key": b"k",
                                              "value": b"v"})
                assert r == {"added": True}
            assert gcs._native_svc.counters()[1] == appends_before
            # A changed value DOES append.
            await conn.call("KVPut", {"ns": "x", "key": b"k",
                                      "value": b"v2"})
            assert gcs._native_svc.counters()[1] == appends_before + 1
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def test_str_and_bytes_keys_are_distinct(tmp_path):
    """Key identity is the raw msgpack encoding: "a" (str) and b"a"
    (bin) are different keys, matching the Python dict fallback."""
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            await conn.call("KVPut", {"ns": "t", "key": "a",
                                      "value": b"str-key"})
            await conn.call("KVPut", {"ns": "t", "key": b"a",
                                      "value": b"bin-key"})
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": "a"}))["value"] == b"str-key"
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": b"a"}))["value"] == b"bin-key"
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def test_publish_missing_channel_malformed(tmp_path):
    """a Publish without "channel" (or without "message")
    must be rejected as malformed — the Python handler KeyErrors — not
    fanned out to channel "" with ok:true."""
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            with pytest.raises(rpc.RpcError, match="malformed"):
                await conn.call("Publish", {"message": {"x": 1}})
            with pytest.raises(rpc.RpcError, match="malformed"):
                await conn.call("Publish", {"channel": "X"})
            # Well-formed publish still works.
            assert (await conn.call(
                "Publish", {"channel": "X", "message": {"x": 1}}))["ok"]
            assert gcs._native_svc.proto_errors() == 2
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def test_subscribe_missing_channels_malformed(tmp_path):
    """Subscribe without a "channels" list must error like
    the Python handler (KeyError), not return ok:true."""
    async def main():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            with pytest.raises(rpc.RpcError, match="malformed"):
                await conn.call("Subscribe", {})
            # An EMPTY channels list is well-formed (subscribes to
            # nothing), matching the Python for-loop semantics.
            assert (await conn.call("Subscribe", {"channels": []}))["ok"]
            await conn.close()
        finally:
            await gcs.stop()

    run(main())


def _raw_kvput_frame(seq: int) -> bytes:
    """A KVPut request whose key uses a VALID but NON-CANONICAL msgpack
    encoding (bin16 for a 1-byte key — msgpack-python would emit bin8).
    Hand-built: pack() always produces canonical forms."""
    body = bytes([0x94])                    # [msg_type, seq, method, payload]
    body += bytes([0x00])                   # MSG_REQUEST
    body += bytes([seq])                    # seq (fixint)
    body += bytes([0xa5]) + b"KVPut"
    body += bytes([0x83])                   # map3
    body += bytes([0xa2]) + b"ns" + bytes([0xa1]) + b"t"
    body += bytes([0xa3]) + b"key" + bytes([0xc5, 0x00, 0x01]) + b"a"
    body += bytes([0xa5]) + b"value" + bytes([0xc4, 0x01]) + b"v"
    return len(body).to_bytes(4, "big") + body


def test_noncanonical_key_encoding_canonicalizes(tmp_path, monkeypatch):
    """RowKeyHex must canonicalize the key encoding so native
    and Python compute identical store row keys for any accepted wire
    encoding. A bin16-encoded b"a" written natively must (a) be the same
    logical row as canonical b"a", and (b) stay deleted after a
    Python-fallback delete + restart (no resurrecting rows)."""
    import asyncio as aio

    async def native_write_noncanonical():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            reader, writer = await aio.open_connection(host, port)
            writer.write(_raw_kvput_frame(1))
            await writer.drain()
            header = await reader.readexactly(4)
            resp = rpc.unpack(
                await reader.readexactly(int.from_bytes(header, "big")))
            assert resp[0] == rpc.MSG_RESPONSE and resp[3] == {"added": True}
            writer.close()
            # Canonical-key reads find the row (identity canonicalized).
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": b"a"}))["value"] == b"v"
            await conn.close()
        finally:
            await gcs.stop()

    async def python_deletes():
        monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "0")
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": b"a"}))["value"] == b"v"
            assert (await conn.call(
                "KVDel", {"ns": "t", "key": b"a"}))["deleted"]
            await conn.close()
        finally:
            await gcs.stop()
        monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL")

    async def stays_deleted():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": b"a"}))["value"] is None
            assert gcs._native_svc.kv_stats()[1] == 0
            await conn.close()
        finally:
            await gcs.stop()

    run(native_write_noncanonical())
    run(python_deletes())
    run(stays_deleted())


def test_str_key_restores_under_python_fallback(tmp_path, monkeypatch):
    """_restore_kv_row must preserve the decoded key TYPE —
    a str-keyed row written natively must answer a str-keyed KVGet
    after a fallback restart (the old .encode() coercion broke it)."""
    async def native_writes_str_key():
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            conn = await rpc.connect(host, port)
            await conn.call("KVPut", {"ns": "t", "key": "skey",
                                      "value": b"sval"})
            await conn.close()
        finally:
            await gcs.stop()

    async def python_restores_str_key():
        monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "0")
        gcs, host, port = await _start_gcs(tmp_path)
        try:
            assert gcs._native_svc is None
            conn = await rpc.connect(host, port)
            assert (await conn.call(
                "KVGet", {"ns": "t", "key": "skey"}))["value"] == b"sval"
            await conn.close()
        finally:
            await gcs.stop()
        monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_CONTROL")

    run(native_writes_str_key())
    run(python_restores_str_key())


def test_native_factory_failure_closes_handle(tmp_path, monkeypatch):
    """If install fails after gsvc_create, the partially constructed
    native handle is closed, not leaked — and the GCS does not start on
    the Python handlers instead: the port has no silent fallback."""
    from ray_tpu_torch._private import native_gcs_service

    closed = []
    orig_close = native_gcs_service.GcsNativeService.close

    def tracking_close(self):
        closed.append(True)
        orig_close(self)

    def broken_install(self):
        raise RuntimeError("injected install failure")

    monkeypatch.setattr(native_gcs_service.GcsNativeService, "close",
                        tracking_close)
    monkeypatch.setattr(native_gcs_service.GcsNativeService, "install",
                        broken_install)

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        try:
            with pytest.raises(RuntimeError, match="injected install"):
                await gcs.start()
            assert gcs._native_svc is None
            assert closed, "leaked native service handle"
            assert gcs._server.port is None  # never listened
        finally:
            await gcs.stop()

    run(main())
