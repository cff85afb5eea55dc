"""The port's native C++ scheduler core
(ray_tpu_torch/_private/csrc/scheduler.cc via ctypes), by the reference's
own tests (tests/test_native_scheduler.py).

Parity targets: reference hybrid policy tests
(src/ray/raylet/scheduling/policy/hybrid_scheduling_policy_test.cc) and
bundle policy semantics (policy/bundle_scheduling_policy.h).
"""

import pytest

from ray_tpu_torch._private import native_scheduler
from ray_tpu_torch._private.native_scheduler import ClusterScheduler


@pytest.fixture
def sched():
    assert native_scheduler.available(), "native control switched off"
    s = ClusterScheduler()
    yield s
    s.close()


def test_basic_feasibility(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.update_node("b", total={"CPU": 8, "TPU": 4},
                      available={"CPU": 8, "TPU": 4})
    assert sched.num_nodes() == 2
    # Only b has TPU.
    assert sched.pick_node({"TPU": 1}) == "b"
    # Nothing fits 16 CPUs.
    assert sched.pick_node({"CPU": 16}) is None
    # Fractional demand fits.
    assert sched.pick_node({"CPU": 0.5, "TPU": 0.5}) == "b"


def test_dead_node_excluded(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.update_node("b", total={"CPU": 4}, available={"CPU": 4}, alive=False)
    for seed in range(8):
        assert sched.pick_node({"CPU": 1}, seed=seed) == "a"
    sched.update_node("b", alive=True)
    # b kept its resources across the alive flip.
    assert sched.pick_node({"CPU": 1}, strategy="spread") in ("a", "b")


def test_exclude_and_fallback_total(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 0})
    sched.update_node("b", total={"CPU": 2}, available={"CPU": 2})
    # b fits now; excluding b leaves nothing available — but with
    # fallback_total, a's total capacity qualifies (lease queues there).
    assert sched.pick_node({"CPU": 4}, exclude="b") is None
    assert sched.pick_node({"CPU": 4}, exclude="b",
                           fallback_total=True) == "a"


def test_pack_prefers_most_utilized(sched):
    sched.update_node("a", total={"CPU": 8}, available={"CPU": 8})
    sched.update_node("b", total={"CPU": 8}, available={"CPU": 2})
    assert sched.pick_node({"CPU": 1}, strategy="pack") == "b"
    assert sched.pick_node({"CPU": 1}, strategy="spread") == "a"


def test_hybrid_threshold_and_topk(sched):
    # Node under the 0.5 utilization knee wins over an over-threshold node
    # even when the latter is "more packed".
    sched.update_node("cold", total={"CPU": 10}, available={"CPU": 9})
    sched.update_node("hot", total={"CPU": 10}, available={"CPU": 2})
    for seed in range(8):
        assert sched.pick_node({"CPU": 1}, seed=seed) == "cold"
    # With every node over threshold, least-utilized wins.
    sched.update_node("cold", available={"CPU": 3})
    for seed in range(8):
        assert sched.pick_node({"CPU": 1}, seed=seed) == "cold"


def test_hybrid_spreads_across_topk(sched):
    # 10 identical nodes -> top-k pool of 2; different seeds must not all
    # herd onto one node.
    for i in range(10):
        sched.update_node(f"n{i}", total={"CPU": 4}, available={"CPU": 4})
    picks = {sched.pick_node({"CPU": 1}, seed=s) for s in range(16)}
    assert len(picks) == 2


def test_affinity(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.update_node("b", total={"CPU": 4}, available={"CPU": 4})
    assert sched.pick_node({"CPU": 1}, strategy="affinity:b:0") == "b"
    sched.update_node("b", alive=False)
    # Hard affinity to a dead node fails; soft falls back to the policy.
    assert sched.pick_node({"CPU": 1}, strategy="affinity:b:0") is None
    assert sched.pick_node({"CPU": 1}, strategy="affinity:b:1") == "a"


def test_debit(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.debit_node("a", {"CPU": 3})
    assert sched.pick_node({"CPU": 2}) is None
    assert sched.pick_node({"CPU": 1}) == "a"


def test_bundles_pack_and_strict_pack(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.update_node("b", total={"CPU": 4}, available={"CPU": 4})
    # PACK: both bundles fit on the first node.
    got = sched.schedule_bundles([{"CPU": 2}, {"CPU": 2}], "PACK")
    assert got == ["a", "a"]
    # STRICT_PACK with bundles that exceed any single node -> infeasible.
    assert sched.schedule_bundles([{"CPU": 3}, {"CPU": 3}],
                                  "STRICT_PACK") is None
    assert sched.schedule_bundles([{"CPU": 2}, {"CPU": 2}],
                                  "STRICT_PACK") == ["a", "a"]


def test_bundles_spread_and_strict_spread(sched):
    sched.update_node("a", total={"CPU": 4}, available={"CPU": 4})
    sched.update_node("b", total={"CPU": 4}, available={"CPU": 4})
    got = sched.schedule_bundles([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                                 "SPREAD")
    assert sorted(got[:2]) == ["a", "b"]  # round-robins before reusing
    assert len(got) == 3
    # STRICT_SPREAD needs distinct nodes: 3 bundles on 2 nodes fails.
    assert sched.schedule_bundles([{"CPU": 1}] * 3, "STRICT_SPREAD") is None
    assert sorted(sched.schedule_bundles([{"CPU": 1}] * 2,
                                         "STRICT_SPREAD")) == ["a", "b"]


def test_bundles_strict_ici(sched):
    # Two slices; slice-1 hosts can't fit the gang, slice-2 can.
    sched.update_node("h1", total={"TPU": 4}, available={"TPU": 1},
                      labels={"tpu-slice": "s1"})
    sched.update_node("h2", total={"TPU": 4}, available={"TPU": 1},
                      labels={"tpu-slice": "s1"})
    sched.update_node("h3", total={"TPU": 4}, available={"TPU": 4},
                      labels={"tpu-slice": "s2"})
    sched.update_node("h4", total={"TPU": 4}, available={"TPU": 4},
                      labels={"tpu-slice": "s2"})
    sched.update_node("cpu", total={"CPU": 64}, available={"CPU": 64})
    got = sched.schedule_bundles([{"TPU": 4}, {"TPU": 4}], "STRICT_ICI")
    assert sorted(got) == ["h3", "h4"]
    # A gang too big for any one slice is infeasible.
    assert sched.schedule_bundles([{"TPU": 4}] * 3, "STRICT_ICI") is None


def test_fixed_point_exactness(sched):
    # 0.1 + 0.2-style float drift must not leak capacity (fixed-point math).
    sched.update_node("a", total={"CPU": 1}, available={"CPU": 1})
    for _ in range(10):
        sched.debit_node("a", {"CPU": 0.1})
    assert sched.pick_node({"CPU": 0.0001}) is None
