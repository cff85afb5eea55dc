"""DataContext: process-wide execution knobs for ray_tpu_torch.data.
Port of ray_tpu/data/context.py (reference: python/ray/data/context.py — DataContext.get_current()).

    ctx = ray_tpu_torch.data.DataContext.get_current()
    ctx.max_in_flight_blocks = 16   # streaming backpressure window
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import ClassVar


@dataclass
class DataContext:
    # Streaming executor backpressure: how many block-transform tasks may
    # be outstanding per pipeline segment (reference: ExecutionResources
    # limits in streaming_executor.py:280).
    max_in_flight_blocks: int = 8
    # Byte-based backpressure: estimated in-flight block bytes are kept
    # under this budget (0 disables). Sizes are learned from completed
    # blocks, so >RAM datasets stream with a bounded footprint.
    max_in_flight_bytes: int = 512 * 1024 * 1024
    # Default block count for from_items/range when unspecified.
    default_block_count: int = 8
    # Per-block remote task timeout (seconds) in the streaming loop.
    block_task_timeout_s: float = 300.0
    # Logical-optimizer catalog override: None = the built-in rules from
    # ray_tpu_torch/data/optimizer.py (plus any register_optimizer_rule()
    # additions, reference: _user_provided_optimizer_rules.py). Set to a
    # list of Rule instances to replace the catalog wholesale.
    optimizer_rules: list | None = None

    _lock: ClassVar[threading.Lock] = threading.Lock()
    _current: ClassVar["DataContext | None"] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = cls()
            return cls._current
