"""The raylet's node-local resource accounting.

A Python copy of the reference's native core (src/raylet_core.cc behind
ray_tpu/_private/native_raylet_core.py): the node pool, placement-group
bundle pools with their two-phase prepare/commit, lease records and the
blocked-worker credit, all in integer ticks of 1/10000 so float demands
add and subtract exactly. The native core returns in ROADMAP A1's second
part; until then this is the raylet's only accounting path.

One addition: GPU card ids. The node's cards form a free list, and every
lease with a GPU demand draws distinct cards from it (whole cards for a
demand of 1 or more, a share of one card, packed best-fit, for less), so
the worker it runs on can pin CUDA_VISIBLE_DEVICES to them. A blocked
worker gives back its other resources but keeps its cards: its process
still holds them.
"""

from __future__ import annotations

import threading

_TICKS = 10000
_GPU = "GPU"


def _ticks(res: dict | None) -> dict[str, int]:
    out = {}
    for k, v in (res or {}).items():
        t = int(round(float(v) * _TICKS))
        if t > 0:
            out[k] = t
    return out


def _fits(avail: dict, demand: dict) -> bool:
    return all(avail.get(k, 0) >= v for k, v in demand.items())


def _sub(avail: dict, demand: dict) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) - v


def _add(avail: dict, demand: dict) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0) + v


class _Lease:
    __slots__ = ("resources", "pg", "blocked", "cards")

    def __init__(self, resources, pg, cards):
        self.resources = resources
        self.pg = pg                # (pg_id, index) or None
        self.blocked = False
        self.cards = cards          # [(card index, ticks)]


class RayletResourceCore:
    """Node pool + PG bundle pools + lease records + GPU card free list.

    Thread-safe. Lease ids are caller-chosen strings; the core records
    which pool each lease drew from, so release/block/unblock need only
    the id.
    """

    def __init__(self, total_resources: dict,
                 gpu_ids: list[str] | None = None):
        self._mu = threading.Lock()
        self._total = _ticks(total_resources)
        self._avail = dict(self._total)
        self._bundles: dict[tuple[str, int], dict] = {}
        self._leases: dict[str, _Lease] = {}
        n_cards = self._total.get(_GPU, 0) // _TICKS
        ids = list(gpu_ids or [])[:n_cards]
        ids += [str(i) for i in range(len(ids), n_cards)]
        self._card_ids = ids
        self._card_free = [_TICKS] * n_cards

    # ---- GPU cards ----

    def _take_cards(self, ticks: int) -> list | None:
        if ticks <= 0:
            return []
        free = self._card_free
        if ticks >= _TICKS:
            if ticks % _TICKS:
                return None
            whole = [i for i, f in enumerate(free) if f == _TICKS]
            if len(whole) < ticks // _TICKS:
                return None
            got = [(i, _TICKS) for i in whole[:ticks // _TICKS]]
        else:
            fit = [(f, i) for i, f in enumerate(free) if f >= ticks]
            if not fit:
                return None
            got = [(min(fit)[1], ticks)]
        for i, t in got:
            free[i] -= t
        return got

    def _give_cards(self, cards) -> None:
        for i, t in cards:
            self._card_free[i] += t

    # ---- leases ----

    def try_acquire(self, lease_id: str, resources: dict,
                    pg_id: str = "", bundle_index: int = -1) -> bool:
        """True if acquired (recorded under lease_id). False on no-fit
        AND on missing/uncommitted bundle (callers queue either way)."""
        demand = _ticks(resources)
        with self._mu:
            if lease_id in self._leases:
                return False
            if pg_id:
                keys = ([(pg_id, bundle_index)] if bundle_index >= 0 else
                        sorted(k for k in self._bundles if k[0] == pg_id))
                pool = key = None
                for k in keys:
                    b = self._bundles.get(k)
                    if b is None or not b["committed"]:
                        continue
                    if _fits(b["avail"], demand):
                        pool, key = b["avail"], k
                        break
                if pool is None:
                    return False
            else:
                pool, key = self._avail, None
                if not _fits(pool, demand):
                    return False
            cards = self._take_cards(demand.get(_GPU, 0))
            if cards is None:
                return False
            _sub(pool, demand)
            self._leases[lease_id] = _Lease(demand, key, cards)
            return True

    def gpu_ids(self, lease_id: str) -> list[str]:
        """The card ids a lease holds, in card order."""
        with self._mu:
            lease = self._leases.get(lease_id)
            if lease is None:
                return []
            return [self._card_ids[i] for i, _ in sorted(lease.cards)]

    def _pool_of(self, lease: _Lease) -> dict | None:
        if lease.pg is None:
            return self._avail
        b = self._bundles.get(lease.pg)
        return b["avail"] if b is not None else None

    @staticmethod
    def _blockable(lease: _Lease) -> dict:
        return {k: v for k, v in lease.resources.items() if k != _GPU}

    def release(self, lease_id: str) -> None:
        with self._mu:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                return
            pool = self._pool_of(lease)
            if pool is not None:
                if lease.blocked:  # block() credited all but the cards
                    _add(pool, {k: v for k, v in lease.resources.items()
                                if k == _GPU})
                else:
                    _add(pool, lease.resources)
            self._give_cards(lease.cards)

    def block(self, lease_id: str) -> bool:
        with self._mu:
            lease = self._leases.get(lease_id)
            if lease is None or lease.blocked:
                return False
            lease.blocked = True
            pool = self._pool_of(lease)
            if pool is not None:
                _add(pool, self._blockable(lease))
            return True

    def unblock(self, lease_id: str) -> bool:
        with self._mu:
            lease = self._leases.get(lease_id)
            if lease is None or not lease.blocked:
                return False
            lease.blocked = False
            pool = self._pool_of(lease)
            if pool is not None:
                _sub(pool, self._blockable(lease))
            return True

    # ---- placement-group bundles (two-phase) ----

    def pg_prepare(self, pg_id: str, bundle_index: int,
                   resources: dict) -> bool:
        key = (pg_id, bundle_index)
        res = _ticks(resources)
        with self._mu:
            if key in self._bundles:
                return True
            if not _fits(self._avail, res):
                return False
            _sub(self._avail, res)
            self._bundles[key] = {"resources": res, "avail": dict(res),
                                  "committed": False}
            return True

    def pg_commit(self, pg_id: str, bundle_index: int) -> bool:
        with self._mu:
            b = self._bundles.get((pg_id, bundle_index))
            if b is None:
                return False
            b["committed"] = True
            return True

    def pg_return(self, pg_id: str, bundle_index: int) -> list[str] | None:
        """Drop the bundle; returns lease_ids still held against it (the
        caller kills those workers), or None if the bundle was unknown."""
        key = (pg_id, bundle_index)
        with self._mu:
            b = self._bundles.pop(key, None)
            if b is None:
                return None
            held = sorted(lid for lid, lease in self._leases.items()
                          if lease.pg == key)
            _add(self._avail, b["resources"])
            return held

    # ---- views ----

    def available(self) -> dict:
        """Node-pool availability snapshot (floats, may be negative)."""
        with self._mu:
            return {k: v / _TICKS for k, v in sorted(self._avail.items())}

    def num_leases(self) -> int:
        with self._mu:
            return len(self._leases)

    def num_bundles(self) -> int:
        with self._mu:
            return len(self._bundles)
