"""The port's native control-plane cores against the reference's, on the
CPU, with exact equality.

- ClusterScheduler: one seeded sequence of node updates, removals,
  debits, picks (every strategy) and gang placements goes through
  ray_tpu._private.native_scheduler and the port's copy; every pick must
  be the same.
- RayletResourceCore: one seeded sequence of acquire, release, block,
  unblock and pg_* calls without GPU goes through both cores; every
  answer and every available() snapshot must be the same (the port's
  core adds the card free list, which a demand without GPU never
  touches).
- The WAL format both ways: rows written by the reference's
  GcsTableStore read back the same through the port's, and rows written
  by the port's through the reference's.
- The reference's G2 check on the port's own copies: the
  `// graftgen: native-handler <Method>` markers in the port's csrc/
  equal the keys of the port's NATIVE_FALLTHROUGH_POLICY.
"""

import os
import re

import numpy as np
import pytest

from ray_tpu._private import native_gcs_store as ref_gstore
from ray_tpu._private import native_raylet_core as ref_rcore
from ray_tpu._private import native_scheduler as ref_sched
from ray_tpu_torch._private import native_gcs_store as port_gstore
from ray_tpu_torch._private import native_policy
from ray_tpu_torch._private import native_raylet_core as port_rcore
from ray_tpu_torch._private import native_scheduler as port_sched

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ray_tpu_torch", "_private", "csrc")

_KEYS = ("CPU", "TPU", "memory", "custom")


def _resources(rng, lo=0.0, hi=8.0, keys=_KEYS):
    out = {}
    for k in keys:
        if rng.random() < 0.6:
            # Quarter steps and a few odd fractions (fixed-point ticks).
            out[k] = float(np.round(rng.uniform(lo, hi) * 4) / 4)
            if rng.random() < 0.2:
                out[k] = float(np.round(rng.uniform(lo, hi), 4))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_same_picks(seed):
    rng = np.random.default_rng(seed)
    ref, port = ref_sched.ClusterScheduler(), port_sched.ClusterScheduler()
    nodes = [f"n{i}" for i in range(8)]
    strategies = ("hybrid", "pack", "spread")
    picks = 0
    try:
        for step in range(400):
            op = rng.integers(0, 7)
            nid = nodes[rng.integers(0, len(nodes))]
            if op == 0:
                total = _resources(rng, 1, 16)
                avail = {k: float(np.round(v * rng.uniform(0, 1), 2))
                         for k, v in total.items()}
                labels = ({"tpu-slice": f"s{rng.integers(0, 3)}"}
                          if rng.random() < 0.5 else {})
                alive = bool(rng.random() < 0.9)
                for s in (ref, port):
                    s.update_node(nid, total=total, available=avail,
                                  labels=labels, alive=alive)
            elif op == 1:
                avail = _resources(rng, 0, 8)
                for s in (ref, port):
                    s.update_node(nid, available=avail)
            elif op == 2 and rng.random() < 0.3:
                for s in (ref, port):
                    s.remove_node(nid)
            elif op == 3:
                demand = _resources(rng, 0, 2)
                for s in (ref, port):
                    s.debit_node(nid, demand)
            elif op in (4, 5):
                demand = _resources(rng, 0, 4)
                r = rng.random()
                if r < 0.75:
                    strategy = strategies[rng.integers(0, 3)]
                else:
                    strategy = (f"affinity:{nid}:"
                                f"{int(rng.integers(0, 2))}")
                exclude = nid if rng.random() < 0.2 else ""
                fallback = bool(rng.random() < 0.3)
                pick_seed = int(rng.integers(0, 2 ** 32))
                got = [s.pick_node(demand, strategy, exclude=exclude,
                                   fallback_total=fallback, seed=pick_seed)
                       for s in (ref, port)]
                assert got[0] == got[1], (step, demand, strategy)
                picks += 1
            else:
                bundles = [_resources(rng, 0, 3)
                           for _ in range(int(rng.integers(1, 4)))]
                strategy = ("PACK", "SPREAD", "STRICT_PACK",
                            "STRICT_SPREAD", "STRICT_ICI")[
                                rng.integers(0, 5)]
                got = [s.schedule_bundles(bundles, strategy)
                       for s in (ref, port)]
                assert got[0] == got[1], (step, bundles, strategy)
                picks += 1
            assert ref.num_nodes() == port.num_nodes()
    finally:
        ref.close()
        port.close()
    assert picks > 100


@pytest.mark.parametrize("seed", range(4))
def test_raylet_core_same_answers_without_gpu(seed):
    rng = np.random.default_rng(seed)
    total = {"CPU": 8.0, "memory": 16.0, "custom": 3.5}
    ref = ref_rcore.RayletResourceCore(total)
    port = port_rcore.RayletResourceCore(total)
    leases: list[str] = []
    bundles: list[tuple[str, int]] = []
    keys = ("CPU", "memory", "custom")
    try:
        for step in range(600):
            op = int(rng.integers(0, 8))
            if op in (0, 1):
                lid = f"l{step}"
                demand = _resources(rng, 0, 3, keys)
                pg, idx = "", -1
                if bundles and rng.random() < 0.3:
                    pg, idx = bundles[rng.integers(0, len(bundles))]
                    if rng.random() < 0.3:
                        idx = -1
                got = [c.try_acquire(lid, demand, pg, idx)
                       for c in (ref, port)]
                if got[0]:
                    leases.append(lid)
            elif op == 2 and leases:
                lid = leases.pop(int(rng.integers(0, len(leases))))
                got = [c.release(lid) for c in (ref, port)]
            elif op == 3 and leases:
                lid = leases[int(rng.integers(0, len(leases)))]
                got = [c.block(lid) for c in (ref, port)]
            elif op == 4 and leases:
                lid = leases[int(rng.integers(0, len(leases)))]
                got = [c.unblock(lid) for c in (ref, port)]
            elif op == 5:
                key = (f"pg{int(rng.integers(0, 4))}",
                       int(rng.integers(0, 3)))
                demand = _resources(rng, 0, 3, keys)
                got = [c.pg_prepare(*key, demand) for c in (ref, port)]
                if got[0] and key not in bundles:
                    bundles.append(key)
            elif op == 6 and bundles:
                key = bundles[int(rng.integers(0, len(bundles)))]
                got = [c.pg_commit(*key) for c in (ref, port)]
            elif op == 7 and bundles:
                key = bundles.pop(int(rng.integers(0, len(bundles))))
                got = [c.pg_return(*key) for c in (ref, port)]
            else:
                got = [None, None]
            assert got[0] == got[1], (step, op)
            assert ref.available() == port.available(), step
            assert ref.num_leases() == port.num_leases()
            assert ref.num_bundles() == port.num_bundles()
    finally:
        ref.close()
        port.close()


def _random_rows(rng, n):
    rows = []
    for i in range(n):
        ns = ("kv", "actors", "nodes", "jobs")[rng.integers(0, 4)]
        key = f"{ns}-{int(rng.integers(0, n // 2))}"
        value = rng.bytes(int(rng.integers(0, 2048)))
        rows.append((ns, key, value, bool(rng.random() < 0.15)))
    return rows


def _write(store, rows, compact_at):
    expect = {}
    for i, (ns, key, value, delete) in enumerate(rows):
        if delete:
            store.delete(ns, key)
            expect.pop((ns, key), None)
        else:
            assert store.put(ns, key, value)
            expect[(ns, key)] = value
        if i == compact_at:
            assert store.compact()
    assert store.sync()
    return expect


def _read(store):
    got = {}
    for ns in store.namespaces():
        for key, value in store.scan(ns):
            got[(ns, key)] = value
    return got


@pytest.mark.parametrize("writer,reader", [
    (ref_gstore, port_gstore), (port_gstore, ref_gstore)],
    ids=["reference-to-port", "port-to-reference"])
def test_wal_format_reads_back_the_same(writer, reader, tmp_path):
    """A WAL (snapshot and tail) one side writes, the other side replays
    row for row: namespaces, scans and point reads."""
    rng = np.random.default_rng(7)
    rows = _random_rows(rng, 300)
    prefix = str(tmp_path / "gcs_state")
    w = writer.GcsTableStore(prefix)
    expect = _write(w, rows, compact_at=150)
    assert w.num_rows() == len(expect)
    w.close()
    r = reader.GcsTableStore(prefix)
    try:
        assert _read(r) == expect
        assert r.num_rows() == len(expect)
        for (ns, key), value in list(expect.items())[:20]:
            assert r.get(ns, key) == value
        assert r.get("kv", "never-written") is None
    finally:
        r.close()


def test_native_handler_markers_equal_the_policy_table():
    """Every method a native plane owns carries a
    `// graftgen: native-handler <Method>` marker at its dispatch branch
    in the port's sources, and has a declared fallthrough policy — in
    both directions."""
    marker = re.compile(r"//\s*graftgen:\s*native-handler\s+(\w+)")
    owned = set()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cc") and not name.endswith("_test.cc"):
            with open(os.path.join(CSRC, name)) as f:
                owned.update(marker.findall(f.read()))
    assert owned, "no native-handler markers found"
    assert owned == set(native_policy.NATIVE_FALLTHROUGH_POLICY)
