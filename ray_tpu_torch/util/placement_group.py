"""Placement groups: gang resource reservation across nodes.

Parity: reference python/ray/util/placement_group.py (strategies
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD at :16-19, placement_group() at :146).
TPU-first addition: the STRICT_ICI strategy places all bundles on nodes of
one ICI-connected TPU slice (nodes sharing a `tpu-slice` label) — the
gang-lease unit for multi-host SPMD programs (see SURVEY.md §7 stage 3).
"""

from __future__ import annotations

import time

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.api_internal import get_core_worker
from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "STRICT_ICI")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_specs(self) -> list[dict]:
        return self.bundles

    def ready(self):
        """Returns an ObjectRef that resolves once the PG is scheduled.

        The reference submits a probe task (bundle_reservation_check_func)
        into bundle 0 (python/ray/util/placement_group.py ready()); here
        the promise is settled straight off the GCS PG pubsub channel —
        CREATED is only published after every bundle's 2PC commit, so it
        validates the same thing without leasing (and on a fresh cluster,
        SPAWNING) one worker per placement group."""
        return get_core_worker().pg_ready_promise(self.id.hex())

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the PG is scheduled (reference:
        PlacementGroup.wait(timeout_seconds))."""
        cw = get_core_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            resp = cw._run(cw.gcs.call("GetPlacementGroup", {"pg_id": self.id.hex()}))
            if resp.get("found") and resp["state"] == "CREATED":
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.02)

    def bundle_node_ids(self) -> list[str]:
        cw = get_core_worker()
        resp = cw._run(cw.gcs.call("GetPlacementGroup", {"pg_id": self.id.hex()}))
        if not resp.get("found"):
            raise exc.PlacementGroupSchedulingError("placement group not found")
        return [b["node_id"] for b in resp["bundles"]]


def placement_group(bundles: list[dict], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or not all(isinstance(b, dict) and b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    cw = get_core_worker()
    pg_id = PlacementGroupID.from_random()
    resp = cw._run(cw.gcs.call("CreatePlacementGroup", {
        "pg_id": pg_id.hex(), "bundles": bundles, "strategy": strategy,
        "name": name, "job_id": cw.job_id}))
    if not resp.get("ok"):
        raise exc.PlacementGroupSchedulingError("placement group creation failed")
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    cw = get_core_worker()
    cw._run(cw.gcs.call("RemovePlacementGroup", {"pg_id": pg.id.hex()}))


def placement_group_table() -> list[dict]:
    cw = get_core_worker()
    return cw._run(cw.gcs.call("ListPlacementGroups", {}))["placement_groups"]
