"""The device plane, collective groups and Data's device landing on the
card. Every test here needs a CUDA device and skips without one. The file
imports neither jax nor ray_tpu, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gang.py

One cluster for the file (ray_tpu_torch.init with 4 CPUs and the cards
the node reports).

- The ipc route across two pinned processes: a producer actor on a GPU
  lease (on the last card where there are several: the others are held
  first, so its cuda:0 is the driver's cuda:N-1) returns a tensor with
  tensor_transport="device"; the driver's copy is bitwise, on the
  driver's index of the producer's card (by UUID), and the driver's own:
  writing to it leaves the producer's pinned tensor as it was. An actor
  takes a driver tensor from device_put by the same route.
- NCCL groups of one in a GPU actor: every op, two named groups side by
  side, bf16 and f32, bitwise the input (a world of one).
- A device landing: iter_device_batches lands CUDA tensors equal to the
  host path's batches, by the ipc route.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def rt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _routes():
    from ray_tpu_torch._private import device_objects

    return device_objects.counters()


def test_ipc_route_maps_the_card_by_uuid_and_copies(rt):
    from ray_tpu_torch._private import device_objects

    n = torch.cuda.device_count()

    @rt.remote(num_gpus=1)
    class Hold:
        def ready(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote(num_gpus=1 if n > 1 else 0.5)
    class Producer:
        def make(self):
            gen = torch.Generator(device="cuda").manual_seed(5)
            self.t = torch.randn(1 << 20, generator=gen,
                                 device="cuda").to(torch.bfloat16)
            return self.t

        def card(self):
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    str(torch.cuda.get_device_properties(0).uuid))

        def checksum(self):
            return float(self.t.float().sum())

        def routes(self):
            from ray_tpu_torch._private import device_objects

            return device_objects.counters()

    holds = [Hold.remote() for _ in range(n - 1)]
    rt.get([h.ready.remote() for h in holds], timeout=120)
    p = Producer.remote()
    before = _routes()
    visible, uuid = rt.get(p.card.remote(), timeout=120)
    ref = p.make.options(tensor_transport="device").remote()
    got = rt.get(ref, timeout=120)
    after = _routes()
    want_index = device_objects._local_card_index(uuid)
    assert got.device == torch.device("cuda", want_index)
    if n > 1:
        assert want_index == n - 1 and visible == str(n - 1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    want = torch.randn(1 << 20, generator=gen, device="cuda").to(
        torch.bfloat16).to(got.device)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert (after["ipc"] - before["ipc"],
            after["host_fallback"] - before["host_fallback"]) == (1, 0)
    checksum = rt.get(p.checksum.remote())
    got.fill_(7)
    torch.cuda.synchronize()
    assert rt.get(p.checksum.remote()) == checksum
    assert rt.get(p.routes.remote())["ipc_out"] >= 1
    del ref
    for h in holds:
        rt.kill(h)
    rt.kill(p)


def test_actor_takes_device_put_by_ipc(rt):
    from ray_tpu_torch._private import device_objects

    @rt.remote(num_gpus=0.5)
    class Taker:
        def take(self, tree):
            from ray_tpu_torch._private import device_objects

            t = tree["w"]
            return (str(t.device), float(t.float().sum()),
                    device_objects.counters()["ipc"])

    t = torch.arange(4096, dtype=torch.float32, device="cuda")
    ref = device_objects.device_put({"w": t, "b": [t[:8]]})
    taker = Taker.remote()
    device, total, ipc = rt.get(taker.take.remote(ref), timeout=120)
    assert device.startswith("cuda") and total == float(t.sum())
    assert ipc == 2
    del ref
    rt.kill(taker)


def test_nccl_groups_of_one(rt):
    @rt.remote(num_gpus=0.5)
    class Member:
        def run(self):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(1, 0, backend="nccl", group_name="a")
            col.init_collective_group(1, 0, group_name="b")  # default: nccl
            bad = []
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(5, 33, generator=torch.Generator()
                                .manual_seed(1)).to(dtype).cuda()
                for name in ("a", "b"):
                    outs = [col.allreduce(x.clone(), name, op=op)
                            for op in ("sum", "product", "min", "max")]
                    outs += col.allgather(x, name)
                    outs.append(col.reducescatter(x, name))
                    outs.append(col.broadcast(x.clone(), 0, name))
                    col.barrier(name)
                    bad += [f"{dtype} {name} {i}" for i, o in enumerate(outs)
                            if not torch.equal(o, x)]
            sizes = [col.get_collective_group_size(n) for n in ("a", "b")]
            col.destroy_collective_group("a")
            col.destroy_collective_group("b")
            return bad, sizes

    m = Member.remote()
    bad, sizes = rt.get(m.run.remote(), timeout=300)
    assert bad == [] and sizes == [1, 1]
    rt.kill(m)


def test_device_landing_lands_cuda_tensors_by_ipc(rt):
    from ray_tpu_torch import data
    from ray_tpu_torch.data import dataset as data_mod

    rows = [{"tokens": r} for r in np.random.default_rng(0).integers(
        0, 1000, (12, 17))]

    def shift(batch):
        tok = batch["tokens"]
        return {"inp": tok[:, :-1], "tgt": tok[:, 1:]}

    ds = data.from_items(rows, override_num_blocks=4).map_batches(shift)
    before, landed = _routes(), data_mod.landing_counters()
    got = list(ds.iter_device_batches(batch_size=4, device_transport=True))
    after = _routes()
    want = list(ds.iter_batches(batch_size=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["inp"].device.type == "cuda"
        np.testing.assert_array_equal(g["inp"].cpu().numpy(), w["inp"])
        np.testing.assert_array_equal(g["tgt"].cpu().numpy(), w["tgt"])
    assert data_mod.landing_counters()["device_landings"] \
        - landed["device_landings"] == 4
    assert after["ipc"] - before["ipc"] == 8
    assert after["host_fallback"] == before["host_fallback"]
