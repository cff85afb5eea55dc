"""The port's native C++ object-transfer plane, by the reference's own
tests (tests/test_native_transfer.py; reference test model:
python/ray/tests/test_object_manager.py — cross-node object movement)."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import native_transfer
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreClient


def test_server_fetch_roundtrip(tmp_path):
    """Pure native plane: two arenas, one fetch — no cluster involved."""
    src_path = str(tmp_path / "src_store")
    dst_path = str(tmp_path / "dst_store")
    src = ObjectStoreClient(src_path, create=True, size=8 << 20)
    dst = ObjectStoreClient(dst_path, create=True, size=8 << 20)
    oid = ObjectID.from_random()
    meta = b"M" * 7
    payload = np.random.default_rng(0).bytes(1 << 20)
    buf = src.create(oid, len(meta) + len(payload), len(meta))
    buf[: len(meta)] = meta
    buf[len(meta):] = payload
    src.seal(oid)

    server = native_transfer.TransferServer(src_path)
    assert server.port > 0
    try:
        rc = native_transfer.fetch(dst_path, "127.0.0.1", server.port,
                                   oid.binary())
        assert rc == 0
        got = dst.get_buffer(oid)
        assert got is not None
        got_meta, got_data = got
        assert bytes(got_meta) == meta
        assert bytes(got_data) == payload
        dst.release(oid)
        # Unknown object -> not-found code, connection stays usable.
        rc = native_transfer.fetch(dst_path, "127.0.0.1", server.port,
                                   ObjectID.from_random().binary())
        assert rc == -2
    finally:
        server.stop()
        src.close()
        dst.close()


@pytest.fixture
def ray_start_cluster():
    """Bare Cluster factory; the test adds nodes itself."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.cluster_utils import Cluster

    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.num_heartbeats_timeout = 5
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cluster = Cluster(initialize_head=False, config=cfg)
    yield cluster
    cluster.shutdown()


def test_cross_node_object_pull_uses_native_plane(ray_start_cluster):
    """Objects produced on one node and consumed on another flow through
    the C++ transfer servers (every raylet advertises a transfer_port)."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, resources={"remote_node": 1})
    cluster.connect()

    for n in ray_tpu_torch.nodes():
        if n["alive"]:
            assert n.get("transfer_port", 0) >= 0  # field propagated

    @ray_tpu_torch.remote(resources={"remote_node": 0.1})
    def produce():
        return np.arange(300_000, dtype=np.int64)  # 2.4 MB — store path

    @ray_tpu_torch.remote(num_cpus=1)
    def consume(arr):
        return int(arr.sum())

    ref = produce.remote()
    # Consume on the head node: the argument must cross nodes.
    total = ray_tpu_torch.get(consume.remote(ref), timeout=120)
    assert total == sum(range(300_000))
