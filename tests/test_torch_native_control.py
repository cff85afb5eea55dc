"""The port's native control plane, by the reference's own e2e tests
(tests/test_native_control.py, all but the NetChaos flap).

Under RAY_TPU_TORCH_NATIVE_CONTROL=1 (the default) the GCS installs the
actor plane (csrc/gcs_actor.cc) and every raylet installs the lease
plane (csrc/raylet_lease.cc) into their fastpath pumps: the hot actor-creation
ladder (RegisterActor -> CreateActor -> ActorReady) and the hot lease
grant/return execute on the C++ loop threads, while Python stays the
policy/IO shell — named actors, placement groups, empty worker pools
and every other complex shape fall through per-method to the Python
handlers.

These tests drive a REAL GcsServer (pump transport) with real
rpc.connect_session clients acting as driver and raylet, then the full
stack through ray_tpu_torch.init, asserting (a) the ladder end-state
matches the Python path (actor ALIVE, address mirrored), (b) the frames
really were handled natively (plane counters, stats surface), and (c) the
fallthrough shapes still work. The full-stack cluster also holds GPU
leases on a faked two-card node: a GPU demand routes to Python (the
worker must learn its cards before the grant), and concurrent leases get
distinct cards from the native core's free list.
"""

import asyncio
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.gcs import ACTOR_ALIVE, GcsServer


def run(coro):
    return asyncio.run(coro)


async def _wait_for(predicate, timeout=10.0, what="condition"):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        if predicate():
            return
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


NODE_ID = "aa" * 16


async def _fake_raylet(host, port):
    """A connect_session client that registers a node and answers the
    plane's CreateActor ladder: reply ok, then (once the test releases
    it) call ActorReady — the exact raylet-side protocol."""
    created = asyncio.Event()
    create_payloads = []
    sess_box = {}

    def on_create(conn, payload):
        create_payloads.append(payload)
        created.set()
        return {"ok": True}

    sess = await rpc.connect_session(host, port,
                                     handlers={"CreateActor": on_create},
                                     name="fake-raylet")
    sess_box["sess"] = sess
    r = await sess.call("RegisterNode", {
        "host": "127.0.0.1", "node_id": NODE_ID, "raylet_port": 47001,
        "total_resources": {"CPU": 4.0}})
    assert r["ok"]
    return sess, created, create_payloads


def test_actor_ladder_native(tmp_path, monkeypatch):
    """RegisterActor for a simple (nameless) actor runs the native
    ladder: driver acked from C++, CreateActor reaches the raylet with
    the spec bytes intact, ActorReady flips the Python mirror to ALIVE
    — and the Python RegisterActor handler never runs."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            assert gcs._actor_plane is not None, \
                "actor plane should install under RAY_TPU_TORCH_NATIVE_CONTROL=1"
            raylet, created, create_payloads = await _fake_raylet(host, port)

            driver = await rpc.connect_session(host, port, name="driver")
            r = await driver.call("RegisterActor", {
                "actor_id": "nat-a1", "spec": b"\x01spec-bytes",
                "max_restarts": 0, "class_name": "Counter",
                "job_id": "job-1"})
            assert r["ok"]

            await asyncio.wait_for(created.wait(), 10)
            assert create_payloads[0]["actor_id"] == "nat-a1"
            assert create_payloads[0]["spec"] == b"\x01spec-bytes"

            # Python mirrored the registration off the inject events.
            await _wait_for(lambda: "nat-a1" in gcs.actors,
                            what="actor mirror")
            assert gcs.actors["nat-a1"]["native"] is True

            # ActorReady completes the ladder natively.
            await raylet.call("ActorReady", {
                "actor_id": "nat-a1", "address": ["127.0.0.1", 47002]})
            await _wait_for(
                lambda: gcs.actors["nat-a1"]["state"] == ACTOR_ALIVE,
                what="actor ALIVE")
            a = gcs.actors["nat-a1"]
            assert a["node_id"] == NODE_ID
            assert a["address"] == ["127.0.0.1", 47002]

            # The frames were handled in C++ (RegisterActor + ActorReady
            # at minimum) and surfaced through GetClusterStatus.
            handled, fallthrough, deduped = gcs._actor_plane.counters()
            assert handled >= 2
            assert gcs._actor_plane.proto_errors() == 0
            status = await driver.call("GetClusterStatus", {})
            nc = status["native_control"]
            assert nc["handled_total"] >= 2
            assert "native_fallthrough_total" in nc
            assert nc["actors"] >= 1

            # GetActorInfo (a Python handler) answers from the mirror.
            info = await driver.call("GetActorInfo",
                                     {"actor_id": "nat-a1"})
            assert info["state"] == ACTOR_ALIVE

            await driver.close()
            await raylet.close()
        finally:
            await gcs.stop()

    run(main())


def test_named_actor_falls_through_to_python(tmp_path, monkeypatch):
    """A NAMED actor is a complex shape the plane does not own: the
    frame must fall through (counted) and the Python handler must still
    complete the registration."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            raylet, created, create_payloads = await _fake_raylet(host, port)
            driver = await rpc.connect_session(host, port, name="driver")

            _, fb_before, _ = gcs._actor_plane.counters()
            r = await driver.call("RegisterActor", {
                "actor_id": "named-b1", "spec": b"\x02spec",
                "max_restarts": 0, "class_name": "Named",
                "name": "bob", "namespace": "default", "job_id": "job-1"})
            assert r["ok"]
            _, fb_after, _ = gcs._actor_plane.counters()
            assert fb_after > fb_before, \
                "named RegisterActor should fall through to Python"
            # The PYTHON path registered it (no native flag).
            await _wait_for(lambda: "named-b1" in gcs.actors,
                            what="python-side registration")
            assert not gcs.actors["named-b1"].get("native")

            await driver.close()
            await raylet.close()
        finally:
            await gcs.stop()

    run(main())


def test_malformed_register_actor_errors_natively(tmp_path, monkeypatch):
    """A RegisterActor missing a generated-validator required field
    ("spec") must come back as a Malformed RpcError from C++ — not
    crash the plane, not silently pass through."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            raylet, _, _ = await _fake_raylet(host, port)
            driver = await rpc.connect_session(host, port, name="driver")
            with pytest.raises(rpc.RpcError, match="malformed"):
                await driver.call("RegisterActor", {"actor_id": "no-spec"})
            assert gcs._actor_plane.proto_errors() == 1
            # The plane still works afterwards.
            r = await driver.call("RegisterActor", {
                "actor_id": "ok-after", "spec": b"\x03s",
                "max_restarts": 0})
            assert r["ok"]
            await driver.close()
            await raylet.close()
        finally:
            await gcs.stop()

    run(main())


def test_replay_dedup_across_session(tmp_path, monkeypatch):
    """The same (sid, rseq) RegisterActor replayed over a FRESH socket
    (session rebind, what a reconnect does) must be answered from the
    native reply cache — at-most-once across rebinds."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            raylet, created, _ = await _fake_raylet(host, port)
            driver = await rpc.connect_session(host, port, name="driver")
            assert (await driver.call("RegisterActor", {
                "actor_id": "dup-a1", "spec": b"\x04s",
                "max_restarts": 0}))["ok"]
            await asyncio.wait_for(created.wait(), 10)

            # Kill the driver's socket; the session layer replays over a
            # new connection on the next call after reconnecting — but
            # here we replay the SAME stamped request by hand to pin the
            # server side: same sid, same rseq, fresh socket.
            sid = driver.session_id
            frame = rpc.pack([rpc.MSG_REQUEST, 99, "RegisterActor", {
                "actor_id": "dup-a1", "spec": b"\x04s", "max_restarts": 0,
                "_session": sid, "_rseq": 1, "_acked": 0}])
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(len(frame).to_bytes(4, "big") + frame)
            await writer.drain()
            hdr = await asyncio.wait_for(reader.readexactly(4), 10)
            resp = rpc.unpack(await asyncio.wait_for(
                reader.readexactly(int.from_bytes(hdr, "big")), 10))
            assert resp[0] == rpc.MSG_RESPONSE and resp[3]["ok"]
            writer.close()

            handled, _, deduped = gcs._actor_plane.counters()
            assert deduped >= 1, "replay must hit the native reply cache"
            # Exactly one CreateActor ever reached the raylet.
            await asyncio.sleep(0.2)
            assert gcs._actor_plane.actor_count() == 1

            await driver.close()
            await raylet.close()
        finally:
            await gcs.stop()

    run(main())


async def _fake_raylet_ex(host, port, node_id, on_create=None,
                          handlers=None, reconnect_register=False):
    """Configurable fake raylet: custom CreateActor behavior, extra
    handlers (e.g. Drain), and optional re-registration on session
    reconnect (what the real raylet's _gcs_handshake does)."""
    created = asyncio.Event()
    create_payloads = []

    def default_create(conn, payload):
        create_payloads.append(payload)
        created.set()
        return {"ok": True}

    table = {"CreateActor": on_create or default_create}
    table.update(handlers or {})
    reg_payload = {
        "host": "127.0.0.1", "node_id": node_id, "raylet_port": 47001,
        "total_resources": {"CPU": 4.0}}

    async def _handshake(conn):
        r = await conn.call("RegisterNode", reg_payload, timeout=10)
        assert r["ok"]

    sess = await rpc.connect_session(
        host, port, handlers=table, name=f"fake-raylet-{node_id[:4]}",
        on_reconnect=_handshake if reconnect_register else None)
    r = await sess.call("RegisterNode", reg_payload)
    assert r["ok"]
    return sess, created, create_payloads


# The reference's NetChaos flap across a native CreateActor
# (tests/test_native_control.py:297) waits for the port's
# test_utils.NetChaos (ROADMAP queue A item 3).


def test_node_killed_mid_ladder_fails_over(tmp_path, monkeypatch):
    """The CreateActor target dies mid-ladder (no reply ever): on the
    death certificate the plane fails the create over to the surviving
    node — one restart consumed, no fork, no lost actor."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")
    node_a, node_b = "bb" * 16, "cc" * 16

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            a_creates, b_creates = [], []
            got_create = asyncio.Event()

            async def a_create(conn, payload):
                a_creates.append(payload)
                got_create.set()
                await asyncio.Event().wait()  # never replies: dies first

            def b_create(conn, payload):
                b_creates.append(payload)
                got_create.set()
                return {"ok": True}

            ra, _, _ = await _fake_raylet_ex(host, port, node_a,
                                             on_create=a_create)
            rb, _, _ = await _fake_raylet_ex(host, port, node_b,
                                             on_create=b_create)
            driver = await rpc.connect_session(host, port, name="driver")
            r = await driver.call("RegisterActor", {
                "actor_id": "kill-a1", "spec": b"\x06s",
                "max_restarts": 1, "class_name": "Kill"})
            assert r["ok"]
            await asyncio.wait_for(got_create.wait(), 10)
            first = node_a if a_creates else node_b
            survivor_sess = rb if first == node_a else ra
            survivor_creates = b_creates if first == node_a else a_creates
            got_create.clear()

            # Death certificate for the in-flight target: the plane
            # fails over (restart bookkeeping) and re-drives the ladder
            # at the survivor.
            await driver.call("NotifyNodeDead", {"node_id": first})
            await asyncio.wait_for(got_create.wait(), 10)
            assert len(survivor_creates) == 1
            assert survivor_creates[0]["actor_id"] == "kill-a1"

            await survivor_sess.call("ActorReady", {
                "actor_id": "kill-a1",
                "address": ["127.0.0.1", 47003]})
            await _wait_for(
                lambda: gcs.actors["kill-a1"]["state"] == ACTOR_ALIVE,
                what="actor ALIVE on survivor")
            assert gcs.actors["kill-a1"]["node_id"] != first
            assert gcs.actors["kill-a1"]["restarts"] == 1
            assert gcs._actor_plane.actor_count() == 1

            await driver.close()
            for s in (ra, rb):
                try:
                    await s.close()
                except Exception:
                    pass
        finally:
            await gcs.stop()

    run(main())


def test_draining_node_excluded_from_native_picks(tmp_path, monkeypatch):
    """Satellite of tests/test_drain.py drain-rejection: once a node is
    DRAINING, the native ladder must stop picking it — every new native
    create lands on the other node."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")
    node_a, node_b = "dd" * 16, "ee" * 16

    async def main():
        gcs = GcsServer(persistence_path=str(tmp_path / "gcs_state"))
        host, port = await gcs.start()
        try:
            a_creates, b_creates = [], []

            def mk_create(sink):
                def h(conn, payload):
                    sink.append(payload)
                    return {"ok": True}
                return h

            def drain_ok(conn, payload):
                return {"ok": True}

            ra, _, _ = await _fake_raylet_ex(
                host, port, node_a, on_create=mk_create(a_creates),
                handlers={"Drain": drain_ok})
            rb, _, _ = await _fake_raylet_ex(
                host, port, node_b, on_create=mk_create(b_creates),
                handlers={"Drain": drain_ok})
            driver = await rpc.connect_session(host, port, name="driver")

            r = await driver.call("DrainNode", {
                "node_id": node_a, "reason": "manual",
                "deadline_s": 30.0})
            assert r["ok"], r

            for i in range(4):
                r = await driver.call("RegisterActor", {
                    "actor_id": f"drain-a{i}", "spec": b"\x07s",
                    "max_restarts": 0, "class_name": "D"})
                assert r["ok"]
            await _wait_for(lambda: len(b_creates) == 4, timeout=10,
                            what="creates on the non-draining node")
            assert not a_creates, \
                "native ladder picked a DRAINING node"

            await driver.close()
            await ra.close()
            await rb.close()
        finally:
            await gcs.stop()

    run(main())


def test_gcs_restart_rehydrates_native_plane(tmp_path, monkeypatch):
    """Crash rehydration: a restarted GCS replays the persisted node
    and actor tables into a fresh native plane — the ALIVE actor is
    ALIVE natively, the in-flight PENDING one is re-driven (exactly one
    CreateActor) when its node re-registers."""
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_CONTROL", "1")
    path = str(tmp_path / "gcs_state")

    async def phase1():
        gcs = GcsServer(persistence_path=path)
        host, port = await gcs.start()
        try:
            raylet, created, payloads = await _fake_raylet(host, port)
            driver = await rpc.connect_session(host, port, name="driver")
            assert (await driver.call("RegisterActor", {
                "actor_id": "re-alive", "spec": b"\x08alive",
                "max_restarts": 0}))["ok"]
            await asyncio.wait_for(created.wait(), 10)
            await raylet.call("ActorReady", {
                "actor_id": "re-alive", "address": ["127.0.0.1", 47002]})
            await _wait_for(
                lambda: gcs.actors["re-alive"]["state"] == ACTOR_ALIVE,
                what="actor ALIVE pre-restart")
            # Second actor: created at the raylet but NEVER ActorReady —
            # in-flight at "crash" time, restored as PENDING.
            assert (await driver.call("RegisterActor", {
                "actor_id": "re-pending", "spec": b"\x09pend",
                "max_restarts": 0}))["ok"]
            await _wait_for(lambda: len(payloads) >= 2,
                            what="second CreateActor")
            await driver.close()
            await raylet.close()
        finally:
            await gcs.stop()  # final flush + compact

    async def phase2():
        gcs = GcsServer(persistence_path=path)
        host, port = await gcs.start()
        try:
            plane = gcs._actor_plane
            assert plane is not None
            # Rehydrated straight from the snapshot, before any node
            # re-registered.
            assert plane.actor_state("re-alive") == "ALIVE"
            assert plane.actor_state("re-pending") == "PENDING"
            assert plane.actor_count() == 2

            raylet, created, payloads = await _fake_raylet(host, port)
            # Node re-registration re-drives ONLY the pending ladder.
            await asyncio.wait_for(created.wait(), 10)
            await asyncio.sleep(0.3)
            assert [p["actor_id"] for p in payloads] == ["re-pending"]
            assert payloads[0]["spec"] == b"\x09pend"
            await raylet.call("ActorReady", {
                "actor_id": "re-pending",
                "address": ["127.0.0.1", 47005]})
            await _wait_for(
                lambda: gcs.actors["re-pending"]["state"] == ACTOR_ALIVE,
                what="re-driven actor ALIVE")
            assert gcs.actors["re-alive"]["state"] == ACTOR_ALIVE
            await raylet.close()
        finally:
            await gcs.stop()

    run(phase1())
    run(phase2())


@pytest.fixture(scope="module")
def native_cluster():
    """One cluster for the full-stack tests, on a faked two-card node
    (CUDA_VISIBLE_DEVICES=0,1 in the driver's environment: the raylet
    counts two cards and nothing touches CUDA)."""
    from ray_tpu_torch._private.config import Config

    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.num_heartbeats_timeout = 5
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    saved = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES",
                                            "RAY_TPU_TORCH_NATIVE_CONTROL")}
    os.environ["CUDA_VISIBLE_DEVICES"] = "0,1"
    os.environ["RAY_TPU_TORCH_NATIVE_CONTROL"] = "1"
    try:
        ray_tpu_torch.init(num_cpus=4, config=cfg)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _raylet_native_control():
    cw = ray_tpu_torch._private.api_internal.get_core_worker()
    return cw._run(cw.raylet.call("GetState", {}))["native_control"]


def test_full_stack_native_control(native_cluster):
    """ray_tpu_torch.init under RAY_TPU_TORCH_NATIVE_CONTROL=1: tasks and
    actors (plain + named) behave exactly as under the Python control
    plane, and both daemons report an installed plane that saw the
    traffic."""
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    assert ray_tpu_torch.get([double.remote(i) for i in range(8)]) == \
        [i * 2 for i in range(8)]

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    assert ray_tpu_torch.get(c.inc.remote()) == 2

    named = Counter.options(name="nc-named").remote()
    assert ray_tpu_torch.get(named.inc.remote()) == 1

    # More plain tasks after workers exist: the idle-worker pool is
    # populated, so the lease plane gets grantable shapes.
    assert ray_tpu_torch.get([double.remote(i) for i in range(8)]) == \
        [i * 2 for i in range(8)]

    cw = ray_tpu_torch._private.api_internal.get_core_worker()
    status = cw._run(cw.gcs.call("GetClusterStatus", {}))
    nc = status["native_control"]
    assert nc is not None, "GCS actor plane not installed"
    # Two RegisterActors flowed through the plane's frame hook —
    # handled natively or routed, never invisible.
    assert nc["handled_total"] + nc["native_fallthrough_total"] >= 2
    assert nc["proto_errors"] == 0

    rnc = _raylet_native_control()
    assert rnc is not None, "raylet lease plane not installed"
    assert rnc["handled_total"] + rnc["native_fallthrough_total"] >= 1
    assert rnc["proto_errors"] == 0


def test_cpu_lease_granted_natively(native_cluster):
    """A CPU task submitted once its worker is back in the idle pool is
    granted on the pump thread (the plane's handled count moves)."""
    r = native_cluster

    @r.remote
    def one(x):
        return x + 1

    before = _raylet_native_control()["methods"]["RequestWorkerLease"]
    for i in range(4):
        assert r.get(one.remote(i)) == i + 1
        time.sleep(0.6)  # the lease goes back after idle_worker_keep_s
    after = _raylet_native_control()
    assert after["methods"]["RequestWorkerLease"]["handled"] > \
        before["handled"]
    assert after["native_degraded_total"] == 0
    assert after["divergence_trips_total"] == 0


def test_fast_result_not_held_behind_slow_batch_mate(native_cluster):
    """Two tasks of one shape submitted while a lease of theirs is idle go
    to its worker as one batch. The fast one's result comes back while
    its slow batch-mate still runs (the native task loop sends held
    completions once the next task passes FP_HOLD_S), not when the batch
    ends."""
    r = native_cluster

    @r.remote
    def nap(s):
        import time

        time.sleep(s)
        return s

    assert r.get(nap.remote(0.0)) == 0.0  # its lease stays idle 0.2 s
    t0 = time.monotonic()
    fast, slow = nap.remote(0.0), nap.remote(3.0)
    assert r.get(fast, timeout=60) == 0.0
    fast_s = time.monotonic() - t0
    ready, _ = r.wait([slow], num_returns=1, timeout=0)
    assert fast_s < 1.5 and not ready, fast_s
    assert r.get(slow, timeout=60) == 3.0


def test_long_native_lease_keeps_the_breaker_closed(native_cluster):
    """A lease the plane granted and a task holds across several audit
    sweeps (one a second) is counted on both sides: the plane's ledger
    and the Python mirror agree (native lease ids are the node id's first
    8 characters, then "-n"), so the breaker stays closed."""
    r = native_cluster

    @r.remote
    def hold(s):
        import time

        time.sleep(s)
        return s

    assert r.get(hold.remote(0.0)) == 0.0
    # The next task must ask for a lease: wait until the driver has given
    # its lease back (after idle_worker_keep_s) and a worker is pooled.
    cw = ray_tpu_torch._private.api_internal.get_core_worker()
    deadline = time.monotonic() + 10
    while ((any(cw._leases.values())
            or _raylet_native_control()["idle_mirror"] < 1)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    before = _raylet_native_control()["methods"]["RequestWorkerLease"]
    assert r.get(hold.remote(2.5), timeout=60) == 2.5
    after = _raylet_native_control()
    assert after["methods"]["RequestWorkerLease"]["handled"] > \
        before["handled"]
    assert after["divergence_trips_total"] == 0, after["degraded_reason"]
    assert after["native_degraded_total"] == 0


def test_gpu_leases_route_to_python_with_distinct_cards(native_cluster):
    """GPU leases under the native planes: each routes to Python (the
    worker learns its cards before the grant), counted as routed, and two
    concurrent leases get distinct cards from the native core's free
    list; every card is back once they end."""
    r = native_cluster
    assert r.cluster_resources()["GPU"] == 2.0

    @r.remote(num_cpus=0)
    class Meet:
        """Two GPU tasks wait here for each other, so their leases are
        held at once (tasks of one shape may otherwise share a lease)."""

        def __init__(self):
            self.n = 0

        def arrive(self):
            self.n += 1

        def count(self):
            return self.n

    @r.remote(num_gpus=1)
    def one_card(meet):
        import os
        import time

        r.get(meet.arrive.remote())
        deadline = time.monotonic() + 20
        while r.get(meet.count.remote()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        return os.environ["CUDA_VISIBLE_DEVICES"]

    @r.remote(num_gpus=0.25)
    def share():
        import os

        return os.environ["CUDA_VISIBLE_DEVICES"]

    before = _raylet_native_control()["methods"]["RequestWorkerLease"]
    meet = Meet.remote()
    assert sorted(r.get([one_card.remote(meet), one_card.remote(meet)],
                        timeout=60)) == ["0", "1"]
    assert r.get(share.remote(), timeout=60) in ("0", "1")
    after = _raylet_native_control()
    routed = after["methods"]["RequestWorkerLease"]["routed"]
    assert routed >= before["routed"] + 3
    assert after["native_degraded_total"] == 0
    r.kill(meet)
    deadline = time.monotonic() + 10
    while r.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline
        time.sleep(0.1)
