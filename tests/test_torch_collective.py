"""The port's collective groups (ray_tpu_torch.util.collective) against the
reference's semantics (ray_tpu/util/collective/collective.py:362-447).

One port cluster for the file (4 CPUs, no card). Four actors form a
gloo group and run every op on seeded f32 inputs; the results are held
against the reference's own reduction table (`_REDUCE_OPS`) applied in
rank order, its `np.array_split` rule for reducescatter (a leading dim
of 5 over 4 ranks: pieces of 2, 1, 1, 1), its list for allgather and
src's tensor for broadcast, to 1e-6 (gloo may sum in another order).
A second named group of two of the actors, in another rank order, runs
beside the first.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu.util.collective import collective as ref_col  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.util import collective as col  # noqa: E402

W = 4
TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ["allgather", "allreduce", "barrier", "broadcast",
         "destroy_collective_group", "get_collective_group_size",
         "get_rank", "init_collective_group", "is_group_initialized", "recv",
         "reducescatter", "send"]


@pytest.fixture(scope="module")
def results():
    cfg = PortConfig()
    cfg.health_check_period_s = 0.2
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ray_tpu_torch.init(num_cpus=W, config=cfg)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old

    @ray_tpu_torch.remote(num_cpus=1)
    class Member:
        def run(self, rank, x, y, pair_rank):
            import torch

            from ray_tpu_torch.util import collective as col

            col.init_collective_group(W, rank, backend="gloo",
                                      group_name="all")
            if pair_rank is not None:
                # "cpu", the reference's name, is gloo here.
                col.init_collective_group(2, pair_rank, backend="cpu",
                                          group_name="pair")
            out = {"rank": col.get_rank("all"),
                   "size": col.get_collective_group_size("all"),
                   "inited": [col.is_group_initialized(n)
                              for n in ("all", "pair", "nope")]}
            t = torch.from_numpy(x)
            for op in ("sum", "product", "min", "max"):
                buf = t.clone()
                got = col.allreduce(buf, "all", op=op)
                assert got is buf
                out[f"allreduce_{op}"] = got.numpy()
            out["allreduce_numpy"] = col.allreduce(x.copy(), "all")
            if pair_rank is not None:
                out["pair_sum"] = col.allreduce(torch.from_numpy(y),
                                                "pair").numpy()
                out["pair_rank"] = col.get_rank("pair")
            out["allgather"] = [g.numpy() for g in col.allgather(t, "all")]
            out["reducescatter_uneven"] = col.reducescatter(t, "all").numpy()
            out["reducescatter_max"] = col.reducescatter(
                torch.from_numpy(np.concatenate([x, x[:3]])), "all",
                op="max").numpy()
            buf = t.clone()
            col.broadcast(buf, src_rank=2, group_name="all")
            out["broadcast"] = buf.numpy()
            col.barrier("all")
            dst, src = (rank + 1) % W, (rank - 1) % W
            got = torch.empty_like(t)
            if rank % 2 == 0:
                col.send(t, dst, "all")
                col.recv(got, src, "all")
            else:
                col.recv(got, src, "all")
                col.send(t, dst, "all")
            out["recv"] = got.numpy()
            col.destroy_collective_group("all")
            out["after_destroy"] = col.is_group_initialized("all")
            if pair_rank is not None:
                col.destroy_collective_group("pair")
            return out

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(W)]
    ys = [rng.standard_normal((4,)).astype(np.float32) for _ in range(W)]
    # The pair group: actor 3 is its rank 0, actor 1 its rank 1.
    pair = {3: 0, 1: 1}
    members = [Member.remote() for _ in range(W)]
    try:
        outs = ray_tpu_torch.get(
            [m.run.remote(r, xs[r], ys[r], pair.get(r))
             for r, m in enumerate(members)], timeout=120)
    finally:
        for m in members:
            ray_tpu_torch.kill(m)
        ray_tpu_torch.shutdown()
    return xs, ys, pair, outs


def _reduce(op, arrays):
    acc = arrays[0]
    for a in arrays[1:]:
        acc = ref_col._REDUCE_OPS[op](acc, a)
    return acc


def test_exports_the_references_twelve_names():
    assert sorted(col.__all__) == sorted(NAMES)
    for name in NAMES:
        assert callable(getattr(col, name))


def test_ranks_sizes_and_groups(results):
    _, _, pair, outs = results
    for r, o in enumerate(outs):
        assert (o["rank"], o["size"]) == (r, W)
        assert o["inited"] == [True, r in pair, False]
        assert o["after_destroy"] is False


@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
def test_allreduce_matches_the_reference(results, op):
    xs, _, _, outs = results
    want = _reduce(op, xs)
    for o in outs:
        np.testing.assert_allclose(o[f"allreduce_{op}"], want, **TOL)


def test_allreduce_of_a_numpy_array_returns_numpy(results):
    xs, _, _, outs = results
    for o in outs:
        assert isinstance(o["allreduce_numpy"], np.ndarray)
        np.testing.assert_allclose(o["allreduce_numpy"], _reduce("sum", xs),
                                   **TOL)


def test_allgather_is_every_members_tensor_in_rank_order(results):
    xs, _, _, outs = results
    for o in outs:
        assert len(o["allgather"]) == W
        for got, want in zip(o["allgather"], xs):
            np.testing.assert_array_equal(got, want)


def test_uneven_reducescatter_is_array_split_of_the_reduction(results):
    xs, _, _, outs = results
    pieces = np.array_split(_reduce("sum", xs), W)
    assert [p.shape[0] for p in pieces] == [2, 1, 1, 1]
    for r, o in enumerate(outs):
        assert o["reducescatter_uneven"].shape == pieces[r].shape
        np.testing.assert_allclose(o["reducescatter_uneven"], pieces[r],
                                   **TOL)


def test_reducescatter_max_over_eight_rows(results):
    xs, _, _, outs = results
    full = _reduce("max", [np.concatenate([x, x[:3]]) for x in xs])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["reducescatter_max"],
                                      np.array_split(full, W)[r])


def test_broadcast_and_send_recv(results):
    xs, _, _, outs = results
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["broadcast"], xs[2])
        np.testing.assert_array_equal(o["recv"], xs[(r - 1) % W])


def test_a_second_named_group_beside_the_first(results):
    _, ys, pair, outs = results
    want = _reduce("sum", [ys[3], ys[1]])
    for r, pr in pair.items():
        assert outs[r]["pair_rank"] == pr
        np.testing.assert_allclose(outs[r]["pair_sum"], want, **TOL)


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ray_tpu_torch.util.collective import collective

    with pytest.raises(RuntimeError, match="nccl"):
        collective.new_process_group("nccl", None, 0, 1)
    assert collective.default_backend() == "gloo"
