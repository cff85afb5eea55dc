"""The port's device object plane (ray_tpu_torch/_private/device_objects.py)
against the reference's, on the CPU: the cases of
tests/test_device_objects.py that need no card.

One cluster per runtime for the file (4 CPUs each; the port's with no
card). Each program runs on both runtimes, with jax arrays on the
reference and torch tensors on the port, and returns what it saw and the
counter deltas of the processes involved; the two must agree. The
route counters both runtimes have are compared (the port adds `ipc` and
`ipc_out`, which no CPU program reaches).
"""

import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu._private.config import Config as RefConfig  # noqa: E402
from ray_tpu_torch._private import device_objects  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402

SHARED = ("total_pinned", "in_process", "collective", "collective_out",
          "host_fallback", "host_out", "lost", "released")


def _fast(cfg):
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, config=_fast(RefConfig()))
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ray_tpu_torch.init(num_cpus=4, config=_fast(PortConfig()))
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _kit(pkg):
    """arange, the runtime's device_objects, and a sum, for code that runs
    in the runtime's workers: closures, so they pickle by value and a
    port worker never imports this module (or jax)."""

    def arange(n, scale=1.0):
        if pkg == "ray_tpu":
            import jax.numpy as jnp

            return jnp.arange(n, dtype=jnp.float32) * scale
        import torch

        return torch.arange(n, dtype=torch.float32) * scale

    def dev():
        import importlib

        return importlib.import_module(pkg + "._private.device_objects")

    def total(x):
        import numpy as np

        return float(np.asarray(x).sum())

    return arange, dev, total


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in SHARED}


def _holder(r, pkg):
    arange, dev, total = _kit(pkg)

    @r.remote
    class Holder:
        def make(self):
            self._made = arange(64).reshape(8, 8)
            return self._made

        def consume(self, arr):
            return {"identity": arr is self._made, "sum": total(arr)}

        def counters(self):
            return dev().counters()

        def pinned(self):
            """Whether this holder's tensor is pinned here (the process
            may hold pins of earlier tasks whose release is under way)."""
            reg = dev().registry()
            with reg._lock:
                return any(e[0] is self._made
                           for e in reg._entries.values())

    return Holder.remote()


def prog_in_process_handover(r, pkg):
    h = _holder(r, pkg)
    before = r.get(h.counters.remote())
    ref = h.make.options(tensor_transport="device").remote()
    out = r.get(h.consume.remote(ref))
    out["ref_class"] = type(ref).__name__
    out["holder"] = _delta(before, r.get(h.counters.remote()))
    r.kill(h)
    return out


def prog_host_route(r, pkg):
    _, dev, total = _kit(pkg)
    h = _holder(r, pkg)
    ref = h.make.options(tensor_transport="device").remote()
    before, hb = dev().counters(), r.get(h.counters.remote())
    val = r.get(ref, timeout=30)
    out = {"sum": total(val), "driver": _delta(before, dev().counters()),
           "holder": _delta(hb, r.get(h.counters.remote()))}
    r.kill(h)
    return out


def prog_task_transport_and_nested_stubs(r, pkg):
    """A task's device return holding a tuple, a list and an ObjectRef
    beside its tensors: the tensors come back, the inner object stays
    alive after the driver drops its own ref."""
    arange, dev, total = _kit(pkg)
    inner = r.put({"inner": 41})

    @r.remote(tensor_transport="device")
    def produce(box):
        return {"pair": (arange(4), arange(2, 2.0)),
                "many": [arange(3, float(i)) for i in range(3)],
                "ref": box[0], "note": "kept"}

    @r.remote
    def check_cls(box):
        return type(box[0]).__name__

    before = dev().counters()
    ref = produce.remote([inner])
    out = r.get(ref, timeout=30)
    del inner
    time.sleep(0.3)
    return {"sums": [total(out["pair"][0]), total(out["pair"][1])]
            + [total(x) for x in out["many"]],
            "note": out["note"], "inner": r.get(out["ref"], timeout=30),
            "ref_class": type(ref).__name__,
            # A DeviceObjectRef nested in a container stays one.
            "nested_class": r.get(check_cls.remote([ref]), timeout=30),
            "driver": _delta(before, dev().counters())}


def prog_device_put(r, pkg):
    arange, dev, total = _kit(pkg)
    params = {"w": arange(16).reshape(4, 4), "b": (arange(4, 0.0),
                                                   arange(2, 2.0))}
    before = dev().counters()
    ref = dev().device_put(params)
    local = r.get(ref)
    out = {"identity": [local["w"] is params["w"],
                        local["b"][1] is params["b"][1]],
           "ref_class": type(ref).__name__}

    @r.remote
    def consume(p):
        return total(p["w"]), total(p["b"][1])

    out["consumed"] = r.get(consume.remote(ref), timeout=30)
    out["pinned"] = dev().registry().stats()["pinned_objects"]
    del ref, local
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline \
            and dev().registry().stats()["pinned_objects"]:
        time.sleep(0.1)
    out["pinned_after"] = dev().registry().stats()["pinned_objects"]
    out["driver"] = _delta(before, dev().counters())
    return out


def prog_refcount_release(r, pkg):
    h = _holder(r, pkg)
    ref = h.make.options(tensor_transport="device").remote()
    r.get(h.consume.remote(ref))
    out = {"pinned": r.get(h.pinned.remote())}
    del ref
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and r.get(h.pinned.remote()):
        time.sleep(0.1)
    out["pinned_after"] = r.get(h.pinned.remote())
    r.kill(h)
    return out


def prog_node_device_objects(r, pkg):
    """The raylet's per-node fan-out over its workers' registries."""
    from importlib import import_module

    h = _holder(r, pkg)
    ref = h.make.options(tensor_transport="device").remote()
    r.get(h.consume.remote(ref))
    cw = import_module(pkg + "._private.api_internal").get_core_worker()
    resp = cw._run(cw.raylet.call("NodeDeviceObjects", {}))
    pins = sum(w.get("pinned_objects", 0) for w in resp["workers"]
               if "error" not in w)
    del ref
    r.kill(h)
    # Other pins of earlier programs may still be in release.
    return {"pinned_on_node": pins >= 1}


def prog_killed_pin_reconstructs(r, pkg):
    arange, dev, total = _kit(pkg)

    @r.remote(tensor_transport="device", num_returns=2, max_retries=2)
    def produce():
        import os

        return os.getpid(), arange(128, 3.0)

    pid_ref, arr_ref = produce.remote()
    pid = r.get(pid_ref)
    before = dev().counters()
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
            time.sleep(0.05)
        except ProcessLookupError:
            break
    val = r.get(arr_ref, timeout=60)
    d = _delta(before, dev().counters())
    return {"sum": total(val), "lost": d["lost"] >= 1,
            "routed": d["host_fallback"] + d["collective"] >= 1}


PROGRAMS = [prog_in_process_handover, prog_host_route,
            prog_task_transport_and_nested_stubs, prog_device_put,
            prog_refcount_release, prog_node_device_objects,
            prog_killed_pin_reconstructs]


_PORT_OUTCOMES: dict = {}


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__[5:])
def test_program_matches_the_reference(program, runtimes):
    got = program(runtimes["ray_tpu_torch"], "ray_tpu_torch")
    _PORT_OUTCOMES[program.__name__] = got
    want = program(runtimes["ray_tpu"], "ray_tpu")
    assert got == want


def test_programs_see_the_routes_they_claim(runtimes):
    """What the reference's own tests assert of each program, on the
    port's outcomes above."""
    if len(_PORT_OUTCOMES) < len(PROGRAMS):
        pytest.skip("runs after the parity programs")
    out = _PORT_OUTCOMES["prog_in_process_handover"]
    assert out["identity"] is True and out["ref_class"] == "DeviceObjectRef"
    assert (out["holder"]["in_process"], out["holder"]["host_fallback"],
            out["holder"]["total_pinned"]) == (1, 0, 1)
    out = _PORT_OUTCOMES["prog_host_route"]
    assert (out["driver"]["host_fallback"], out["holder"]["host_out"]) \
        == (1, 1)
    out = _PORT_OUTCOMES["prog_task_transport_and_nested_stubs"]
    assert out["sums"] == [6.0, 2.0, 0.0, 3.0, 6.0]
    assert (out["inner"], out["nested_class"]) == ({"inner": 41},
                                                   "DeviceObjectRef")
    assert out["driver"]["host_fallback"] == 5
    out = _PORT_OUTCOMES["prog_device_put"]
    assert out["identity"] == [True, True]
    assert out["consumed"] == (120.0, 2.0)
    assert (out["pinned"], out["pinned_after"]) == (3, 0)
    assert out["driver"]["released"] == 3
    out = _PORT_OUTCOMES["prog_refcount_release"]
    assert (out["pinned"], out["pinned_after"]) == (True, False)
    assert _PORT_OUTCOMES["prog_node_device_objects"]["pinned_on_node"]
    out = _PORT_OUTCOMES["prog_killed_pin_reconstructs"]
    assert out == {"sum": float(np.arange(128).sum() * 3.0), "lost": True,
                   "routed": True}


def test_local_handoff_is_identity_and_unpins():
    kv = [(torch.ones(2, 8, 4), torch.zeros(2, 8, 4)) for _ in range(3)]
    before = device_objects.counters()
    out = device_objects.local_handoff("test-kv", kv)
    after = device_objects.counters()
    assert all(a is b and c is d for (a, c), (b, d) in zip(out, kv))
    assert after["in_process"] - before["in_process"] == 6
    assert after["released"] - before["released"] == 6
    assert not any(e["key"].startswith("test-kv")
                   for e in device_objects.registry().entries())


def test_llm_engine_kv_handoff_uses_plane():
    """Serve consumer: a dense-mode prefill routes its KV through the
    device plane (in_process handover), and generation is unchanged."""
    import dataclasses

    from ray_tpu_torch.models import TINY, init_params
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams

    cfg = dataclasses.replace(TINY, vocab_size=64, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=64, max_seq_len=64)
    params = init_params(cfg, seed=0, device="cpu")
    toks = {}
    for plane in (True, False):
        before = device_objects.counters()
        eng = LLMEngine(cfg, params, max_batch=2, max_len=48,
                        use_device_plane=plane, device="cpu")
        try:
            toks[plane] = eng.generate([1, 2, 3],
                                       SamplingParams(max_new_tokens=4))
        finally:
            eng.shutdown()
        after = device_objects.counters()
        moved = {k: after[k] - before[k] for k in ("in_process", "released")}
        if plane:
            # One prefill: n_layers * (k, v) handovers, all unpinned.
            assert moved["in_process"] >= 2 * cfg.n_layers, moved
            assert moved["released"] >= 2 * cfg.n_layers, moved
        else:
            assert moved == {"in_process": 0, "released": 0}, moved
    assert len(toks[True]) >= 1
    assert toks[True] == toks[False]


def test_route_table_without_a_card():
    def meta(platform, node="n1", uuid=""):
        return device_objects.DeviceObjectMeta(
            key="k", shape=[1], dtype="float32", nbytes=4,
            owner_addr=["h", 1, "w", node], platform=platform,
            device_ids=[0] if platform == "cuda" else [], sharding="",
            card_uuid=uuid)

    cw = type("CW", (), {"node_id": "n1"})()
    assert device_objects.choose_route(meta("cpu"), cw) == "host"
    if not torch.cuda.is_available():
        # A CUDA tensor's descriptor, and this process sees no card.
        assert device_objects.choose_route(meta("cuda", uuid="GPU-x"),
                                           cw) == "host"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "uint8"])
def test_host_wire_round_trip_is_bitwise(dtype):
    t = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * 1.37
         ).to(getattr(torch, dtype))
    got = device_objects._from_wire(*device_objects._to_wire(t),
                                    on_card=False)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got.view(-1).view(torch.uint8),
                       t.contiguous().view(-1).view(torch.uint8))


def test_pulls_split_by_platform_and_chunk_the_host_route(monkeypatch):
    """A worker's card tensors and CPU tensors go in separate pulls (a
    pull takes one route), and the host route's in calls of at most
    HOST_CHUNK_BYTES: an RPC frame is capped at 2 GiB."""
    def meta(key, nbytes, platform):
        return device_objects.DeviceObjectMeta(
            key=key, shape=[nbytes // 4], dtype="float32", nbytes=nbytes,
            owner_addr=["h", 1, "w", "n1"], platform=platform,
            device_ids=[0] if platform == "cuda" else [], sharding="",
            card_uuid="GPU-x")

    calls = []
    monkeypatch.setattr(device_objects, "HOST_CHUNK_BYTES", 100)
    monkeypatch.setattr(device_objects, "choose_route",
                        lambda m, cw: "ipc" if m.platform == "cuda"
                        else "host")
    monkeypatch.setattr(device_objects, "_pull", lambda ms, cw, route: (
        calls.append((route, [m.key for m in ms])) or
        {m.key: m.key for m in ms}))
    metas = [meta("a", 60, "cpu"), meta("g", 400, "cuda"),
             meta("b", 60, "cpu"), meta("c", 200, "cpu"),
             meta("d", 40, "cpu"), meta("h", 400, "cuda")]
    out = device_objects._pull_batch(metas, None)
    assert sorted(out) == sorted(m.key for m in metas)
    assert calls == [("ipc", ["g", "h"]), ("host", ["a"]), ("host", ["b"]),
                     ("host", ["c"]), ("host", ["d"])]
    assert device_objects._chunked([1, 2, 3, 4], 5, lambda n: n) == \
        [[1, 2], [3], [4]]
