"""The port's Data (ray_tpu_torch.data) against the reference's
(ray_tpu.data): the same pipelines give the same rows, and the device
landing gives the reference's batches.

One cluster per runtime for the file (4 CPUs each). The port's starts
with CUDA_VISIBLE_DEVICES=0 in the driver's environment, a faked
one-card node: a landing task takes a GPU share and its lease pins a
card, and nothing touches CUDA (the landings land on the CPU,
`device="cpu"`). Each pipeline is a program over the data module; its
UDFs are closures, so they pickle by value and no port worker imports
this module (or jax).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import ray_tpu  # noqa: E402
import ray_tpu.data as ref_data  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.data as port_data  # noqa: E402
from ray_tpu._private.config import Config as RefConfig  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.data import dataset as port_dataset  # noqa: E402


def _fast(cfg):
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def runtimes():
    # A window of 2 blocks: on one core each new worker process costs
    # seconds (a reference landing worker also starts jax), and 2 keep
    # the windowed, pipelined paths.
    contexts = [ref_data.DataContext.get_current(),
                port_data.DataContext.get_current()]
    windows = [c.max_in_flight_blocks for c in contexts]
    for c in contexts:
        c.max_in_flight_blocks = 2
    ray_tpu.init(num_cpus=4, config=_fast(RefConfig()))
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    try:
        ray_tpu_torch.init(num_cpus=4, config=_fast(PortConfig()))
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    for c, w in zip(contexts, windows):
        c.max_in_flight_blocks = w


def _plain(v):
    """Rows as plain Python (numpy scalars and arrays as lists)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _items(n=40):
    return [{"id": i, "x": float(i) * 0.5, "g": i % 3} for i in range(n)]


def prog_map_batches_filter_flat_map(rd):
    def double(batch):
        return {"id": batch["id"], "x": batch["x"] * 2.0, "g": batch["g"]}

    return (rd.from_items(_items(), override_num_blocks=4)
            .map_batches(double).filter(lambda r: r["id"] % 4 != 1)
            .flat_map(lambda r: [r, {**r, "id": -r["id"]}])
            .map(lambda r: {**r, "y": r["x"] + r["id"]}).take_all())


def prog_seeded_shuffles(rd):
    ds = rd.from_items(_items(), override_num_blocks=5)
    return [ds.random_shuffle(seed=7).take_all(),
            ds.randomize_block_order(seed=3).take_all(),
            ds.random_sample(0.5, seed=11).take_all()]


def prog_repartition_sort_limit(rd):
    ds = rd.from_items(_items(), override_num_blocks=3)
    return [ds.repartition(7).num_blocks(),
            ds.repartition(7).take_all(),
            ds.sort("x", descending=True).take(10),
            ds.limit(13).take_all(), ds.limit(13).count()]


def prog_groupby(rd):
    ds = rd.from_items(_items(), override_num_blocks=4)
    g = ds.groupby("g")
    return [g.count().take_all(), g.sum("x").take_all(),
            g.mean("x").take_all(), g.max("id").take_all(),
            g.map_groups(lambda rows: {"n": len(rows)}).take_all()]


def prog_zip_split_union(rd):
    a = rd.from_items(_items(12), override_num_blocks=3)
    b = rd.range(12, override_num_blocks=2).map(lambda i: {"k": i * i})
    return [a.zip(b).take_all(),
            [s.take_all() for s in a.split(3)],
            a.union(a).count(), a.sum("x"), a.min("id"), a.max("x")]


def prog_fused_stages(rd):
    ds = (rd.range(20, override_num_blocks=4).map(lambda i: i + 1)
          .filter(lambda i: i % 2 == 0).map(lambda i: {"v": i}))
    rows = ds.take_all()
    return [rows, ds.explain()]


def prog_read_write(rd, tmp):
    ds = rd.from_items(_items(9), override_num_blocks=3)
    out = []
    for fmt in ("json", "csv"):
        path = os.path.join(tmp, f"{rd.__name__}-{fmt}")
        getattr(ds, f"write_{fmt}")(path)
        back = getattr(rd, f"read_{fmt}")(os.path.join(path, "*")).take_all()
        out.append(sorted(back, key=lambda r: str(r)))
    path = os.path.join(tmp, f"{rd.__name__}-npy")
    rd.from_numpy(np.arange(12).reshape(6, 2)).write_numpy(path)
    out.append(rd.read_numpy(os.path.join(path, "*")).take_all())
    return out


PROGRAMS = [prog_map_batches_filter_flat_map, prog_seeded_shuffles,
            prog_repartition_sort_limit, prog_groupby, prog_zip_split_union,
            prog_fused_stages]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__[5:])
def test_pipeline_rows_match_the_reference(program, runtimes):
    got = program(port_data)
    want = program(ref_data)
    if program is prog_fused_stages:
        assert got[1] == want[1]
        assert "Map" in got[1] or "->" in got[1]
        got, want = got[0], want[0]
    assert _plain(got) == _plain(want)


def test_readers_and_writers_match_the_reference(runtimes, tmp_path):
    assert _plain(prog_read_write(port_data, str(tmp_path))) == \
        _plain(prog_read_write(ref_data, str(tmp_path)))


def _token_rows(n=10, s=9):
    toks = np.random.default_rng(0).integers(0, 100, (n, s))
    return [{"tokens": t, "w": np.float32(i)} for i, t in enumerate(toks)]


def _shift(batch):
    tok = batch["tokens"]
    return {"inp": tok[:, :-1], "tgt": tok[:, 1:], "w": batch["w"]}


@pytest.fixture
def one_landing_at_a_time():
    """A window of one: each runtime's landings reuse one worker (a
    reference landing worker starts jax, seconds on one core)."""
    contexts = [ref_data.DataContext.get_current(),
                port_data.DataContext.get_current()]
    for c in contexts:
        c.max_in_flight_blocks = 1
    yield
    for c in contexts:
        c.max_in_flight_blocks = 2


def test_device_landing_matches_iter_jax_batches(runtimes,
                                                 one_landing_at_a_time):
    before = port_dataset.landing_counters()
    got = list(port_data.from_items(_token_rows(), override_num_blocks=4)
               .map_batches(_shift)
               .iter_device_batches(batch_size=3, device="cpu",
                                    device_transport=True, drop_last=False))
    after = port_dataset.landing_counters()
    want = list(ref_data.from_items(_token_rows(), override_num_blocks=4)
                .map_batches(_shift)
                .iter_jax_batches(batch_size=3, device_transport=True,
                                  drop_last=False))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert after["device_landings"] - before["device_landings"] == 4
    assert after["host_batches"] == before["host_batches"]


def test_no_free_share_takes_the_counted_host_path(runtimes):
    @ray_tpu_torch.remote(num_gpus=1)
    class Card:
        def ready(self):
            return True

    holder = Card.remote()
    ray_tpu_torch.get(holder.ready.remote(), timeout=30)
    try:
        # The node's GPU count as the GCS sees it trails the lease.
        import time

        deadline = time.monotonic() + 10
        while port_dataset._free_landing_share() and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        ds = port_data.from_items(_token_rows(), override_num_blocks=4) \
            .map_batches(_shift)
        before = port_dataset.landing_counters()
        got = list(ds.iter_device_batches(batch_size=5, device="cpu"))
        after = port_dataset.landing_counters()
        assert after["host_batches"] - before["host_batches"] == 2
        assert after["device_landings"] == before["device_landings"]
        want = list(ref_data.from_items(_token_rows(), override_num_blocks=4)
                    .map_batches(_shift).iter_batches(batch_size=5))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["inp"].numpy(), w["inp"])
        with pytest.raises(RuntimeError, match="no free GPU share"):
            next(ds.iter_device_batches(batch_size=5, device="cpu",
                                        device_transport=True))
    finally:
        ray_tpu_torch.kill(holder)


def test_iter_device_batches_raises_without_a_card_unless_asked_for_cpu(
        runtimes):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(port_data.range(4).iter_device_batches(batch_size=2))


def test_connectors_wait_for_their_item():
    for name in ("read_mongo", "write_mongo", "read_sql", "read_webdataset",
                 "read_tfrecords"):
        with pytest.raises(NotImplementedError, match="A14"):
            getattr(port_data, name)("x")
    with pytest.raises(NotImplementedError, match="A14"):
        port_data.read_json("s3://bucket/key.json")
