"""Scheduling strategies for tasks and actors.

Parity: reference python/ray/util/scheduling_strategies.py
("DEFAULT"/"SPREAD" strings, PlacementGroupSchedulingStrategy,
NodeAffinitySchedulingStrategy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

DEFAULT = "DEFAULT"
SPREAD = "SPREAD"


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False
