"""The port's runtime (ray_tpu_torch) against the reference's (ray_tpu).

One module-scoped cluster per runtime, 4 CPUs each. The port's cluster
starts with CUDA_VISIBLE_DEVICES=0,1 in the driver's environment, so its
node reports two cards without having any: GPU leases get card ids from
the raylet and pin CUDA_VISIBLE_DEVICES, and nothing touches CUDA.

- Parity programs: each small driver program runs on both runtimes and
  gives the same result.
- Device pinning: GPU 2; concurrent num_gpus=1 tasks see distinct single
  ids, CPU tasks see "", a share of a card pins one card; no worker has
  initialised CUDA.
- Tensors travel through the object store bitwise and out of band; a
  received tensor is a copy, a received numpy array a read-only view.
- No process of the port's cluster loads jax, ray_tpu, msgpack or
  cloudpickle (the workers report sys.modules, the GCS and raylet their
  loaded packages through their state calls); the runtime runs with
  msgpack and cloudpickle made unimportable.
- tensor_transport="device" is taken (the device plane's own tests are
  tests/test_torch_device_plane.py).
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu._private.config import Config as RefConfig  # noqa: E402
from ray_tpu_torch._private import serialization  # noqa: E402
from ray_tpu_torch._private.api_internal import get_core_worker  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu", "msgpack",
          "cloudpickle")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fast(cfg):
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    # Idle leases go back in 0.2 s, not 2 s: a placement group or a
    # check of the free cards waits for them.
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def ref_rt():
    ray_tpu.init(num_cpus=4, config=_fast(RefConfig()))
    yield ray_tpu
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_rt():
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0,1"
    try:
        ray_tpu_torch.init(num_cpus=4, config=_fast(PortConfig()))
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ---- parity programs: each takes the runtime module, returns a value ----


def prog_tasks(r):
    @r.remote
    def square(x):
        return x * x

    return r.get([square.remote(i) for i in range(6)])


def prog_nested(r):
    @r.remote
    def leaf(x):
        return x + 1

    @r.remote
    def fan(n):
        return sum(r.get([leaf.remote(i) for i in range(n)]))

    return r.get([fan.remote(3), fan.remote(4)])


def prog_actor_state(r):
    @r.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote(10)
    out = r.get([c.add.remote(k) for k in (1, 2, 3)])
    r.kill(c)
    return out


def prog_wait_split(r):
    @r.remote
    def nap(s):
        import time

        time.sleep(s)
        return s

    fast, slow = nap.remote(0.0), nap.remote(3.0)
    r.get(fast)
    ready, not_ready = r.wait([slow, fast], num_returns=1, timeout=1.0)
    return ([x == fast for x in ready], [x == slow for x in not_ready])


def prog_get_timeout(r):
    @r.remote
    def hang():
        import time

        time.sleep(5)

    ref = hang.remote()
    t0 = time.monotonic()
    try:
        r.get(ref, timeout=0.3)
    except r.exceptions.GetTimeoutError as e:
        return type(e).__name__, isinstance(e, TimeoutError), \
            time.monotonic() - t0 < 3.0
    return "no error"


def prog_named_actor_twice(r):
    @r.remote
    class Named:
        def ping(self):
            return "pong"

    a = Named.options(name="dup").remote()
    first = r.get(a.ping.remote())
    try:
        Named.options(name="dup").remote()
        second = "created"
    except r.exceptions.RayTpuError as e:
        second = type(e).__name__
    r.kill(a)
    return first, second


def prog_task_exception(r):
    @r.remote
    def boom():
        raise KeyError("nope")

    try:
        r.get(boom.remote())
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, isinstance(e, KeyError),
                isinstance(e, r.exceptions.RayTpuError))
    return "no error"


def prog_placement_group(r):
    from importlib import import_module

    pgm = import_module(r.__name__ + ".util.placement_group")
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 2}], strategy="PACK")
    ready = pg.wait(30)
    specs = pg.bundle_specs

    @r.remote(num_cpus=1)
    def in_bundle():
        return "ran"

    out = r.get(in_bundle.options(
        placement_group=pg, placement_group_bundle_index=1).remote())
    pgm.remove_placement_group(pg)
    return ready, specs, out


PROGRAMS = [prog_tasks, prog_placement_group, prog_nested, prog_actor_state,
            prog_wait_split, prog_get_timeout, prog_named_actor_twice,
            prog_task_exception]


# Programs whose answer on the reference depends on timing, with the
# answer the port must give. wait_split: the reference's native task loop
# sends a batch's completions when the batch ends, so when the driver
# still holds an idle lease of the shape from the program before, both
# tasks go to its worker as one batch and the fast result waits for the
# slow one. The port sends held completions once the next task passes
# worker.FP_HOLD_S, so its fast result is ready before the slow one.
TIMING_DEPENDENT = {prog_wait_split: ([True], [True])}


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__[5:])
def test_parity_program(program, ref_rt, port_rt):
    expected = program(ref_rt)
    assert expected not in ("no error", None)
    expected = TIMING_DEPENDENT.get(program, expected)
    assert program(port_rt) == expected


# ---- GPU resources and pinning on a faked two-card node ----


def test_faked_two_card_node_pins_distinct_cards(port_rt):
    r = port_rt
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

        import torch

        from ray_tpu_torch._private import accelerator

        r.get(meet.arrive.remote())
        deadline = time.monotonic() + 20
        while r.get(meet.count.remote()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        return (os.environ["CUDA_VISIBLE_DEVICES"],
                r.get_runtime_context().get_accelerator_ids()["GPU"],
                torch.cuda.is_initialized(), accelerator.cuda_initialized())

    @r.remote(num_gpus=1)
    class Card:
        def visible(self):
            import os

            return os.environ["CUDA_VISIBLE_DEVICES"]

    @r.remote
    def no_card():
        import os

        import torch

        return (os.environ["CUDA_VISIBLE_DEVICES"], torch.cuda.device_count(),
                torch.cuda.is_available(), torch.cuda.is_initialized())

    @r.remote(num_gpus=0.5)
    def half_card():
        import os
        import time

        time.sleep(0.3)
        return os.environ["CUDA_VISIBLE_DEVICES"]

    meet = Meet.remote()
    a, b = r.get([one_card.remote(meet), one_card.remote(meet)])
    assert sorted([a[0], b[0]]) == ["0", "1"]
    assert [a[1], b[1]] == [[a[0]], [b[0]]]
    assert not any(a[2:] + b[2:])
    assert r.get([no_card.remote() for _ in range(3)]) == [("", 0, False,
                                                            False)] * 3
    cards = [Card.remote(), Card.remote()]
    assert sorted(r.get([c.visible.remote() for c in cards])) == ["0", "1"]
    for actor in cards + [meet]:
        r.kill(actor)
    # A share of a card pins that one card.
    assert set(r.get([half_card.remote() for _ in range(4)])) <= {"0", "1"}
    # Every card back in the pool once its leases ended.
    deadline = time.monotonic() + 10
    while r.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline
        time.sleep(0.1)


def test_gpu_lease_without_a_card_never_runs_on_the_cpu(port_rt):
    @port_rt.remote(num_gpus=3)
    def three_cards():
        return "ran"

    ref = three_cards.remote()
    with pytest.raises((ray_tpu_torch.exceptions.GetTimeoutError,
                        ray_tpu_torch.exceptions.RayTpuError)):
        port_rt.get(ref, timeout=2.0)


def test_device_transport_waits_for_the_device_plane(port_rt):
    """tensor_transport="device" is taken on tasks and actor methods (the
    device plane's own tests are tests/test_torch_device_plane.py): a
    tensor return comes back as a DeviceObjectRef, and a return with no
    tensor takes the host path."""
    @port_rt.remote
    def f(n):
        import torch

        return torch.arange(n) if n else "none"

    ref = f.options(tensor_transport="device").remote(3)
    assert isinstance(ref, port_rt.DeviceObjectRef)
    assert port_rt.get(ref).tolist() == [0, 1, 2]
    assert port_rt.get(f.options(tensor_transport="device").remote(0)) \
        == "none"

    @port_rt.remote
    class A:
        def g(self):
            import torch

            return {"t": torch.ones(2)}

    a = A.options(tensor_transport="device").remote()
    assert port_rt.get(a.g.remote())["t"].tolist() == [1.0, 1.0]
    port_rt.kill(a)
    with pytest.raises(ValueError, match="tensor_transport"):
        f.options(tensor_transport="nvlink")


# ---- tensors through the store ----


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy().copy()


def _tensors():
    g = np.random.default_rng(0)
    base = torch.from_numpy(g.standard_normal((64, 48)).astype(np.float32))
    return {
        "f32": base,
        "bf16": base.to(torch.bfloat16),
        "f16": base.to(torch.float16),
        "int64": torch.from_numpy(g.integers(-2**40, 2**40, (300,))),
        "non_contiguous": base.t()[::2],
    }


@pytest.mark.parametrize("name", list(_tensors()))
def test_tensor_round_trip_bitwise_out_of_band(name, port_rt):
    t = _tensors()[name]
    sobj = serialization.serialize(t)
    assert len(sobj.buffers) == 1 and len(sobj.inband) < 512  # out of band
    r = port_rt

    @r.remote
    def echo(x):
        return x, str(x.dtype), x.is_contiguous()

    for got in (r.get(r.put(t)), r.get(echo.remote(t))[0]):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(_bits(got), _bits(t))
    assert r.get(echo.remote(t))[1] == str(t.dtype)


def test_a_received_tensor_is_its_own_copy(port_rt):
    """Writing to a tensor from get() changes neither the stored object
    nor what a later get() of the ref sees, in the driver or in a worker.
    A numpy array from get() is a read-only view of the stored object."""
    r = port_rt
    # 1 MiB each: above the inline limit, so both live in the shm arena.
    t = torch.arange(512 * 512, dtype=torch.float32).reshape(512, 512)
    a = np.arange(512 * 512, dtype=np.float32)
    ref, aref = r.put(t), r.put(a)

    @r.remote
    def bump(x):
        x.add_(1)
        return float(x[0, 0])

    got = r.get(ref)
    got.add_(1)
    assert float(got[0, 0]) == 1.0
    assert r.get(bump.remote(ref)) == 1.0
    assert torch.equal(r.get(ref), t)
    arr = r.get(aref)
    assert not arr.flags.writeable
    with pytest.raises(ValueError):
        arr[0] = 1.0
    np.testing.assert_array_equal(r.get(aref), a)


# ---- clean processes ----


def test_no_port_process_loads_jax_ray_tpu_or_the_codecs(port_rt):
    r = port_rt

    @r.remote
    def loaded():
        import sys

        return sorted({m.split(".")[0] for m in sys.modules})

    @r.remote
    class Probe:
        def loaded(self):
            import sys

            return sorted({m.split(".")[0] for m in sys.modules})

    p = Probe.remote()
    cw = get_core_worker()
    listings = {
        "worker": r.get(loaded.remote()),
        "actor": r.get(p.loaded.remote()),
        "raylet": cw._run(cw.raylet.call("GetState", {}))["loaded_packages"],
        "gcs": cw._run(cw.gcs.call("GetClusterStatus", {}))[
            "loaded_packages"],
    }
    r.kill(p)
    for who, pkgs in listings.items():
        assert "ray_tpu_torch" in pkgs, who
        assert not set(pkgs) & set(BANNED), (who, set(pkgs) & set(BANNED))


def test_runtime_runs_without_msgpack_and_cloudpickle(tmp_path):
    for name in ("msgpack", "cloudpickle"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed here')\n")
    script = textwrap.dedent("""
        import sys
        import torch
        import ray_tpu_torch as rt

        rt.init(num_cpus=2)
        try:
            @rt.remote
            def add(a, b):
                return a + b

            @rt.remote
            class Box:
                def __init__(self):
                    self.v = []

                def push(self, x):
                    self.v.append(x)
                    return list(self.v)

            assert rt.get(add.remote(2, 3)) == 5
            box = Box.remote()
            rt.get(box.push.remote(1))
            assert rt.get(box.push.remote(2)) == [1, 2]
            t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
            assert torch.equal(rt.get(rt.put(t)), t)
            assert rt.get(rt.put({"k": [1, "x"]})) == {"k": [1, "x"]}
            assert not {"msgpack", "cloudpickle"} & set(sys.modules)
        finally:
            rt.shutdown()
        print("OK")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path), REPO] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), \
        proc.stderr[-3000:]
