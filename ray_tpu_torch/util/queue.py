"""Distributed FIFO queue backed by an actor. Port of
ray_tpu/util/queue.py.

Parity: reference python/ray/util/queue.py (Queue over _QueueActor).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def qsize(self) -> int:
        return len(self.items)

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self):
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def get_batch(self, n: int):
        out = []
        while self.items and len(out) < n:
            out.append(self.items.popleft())
        return out


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: dict | None = None):
        cls = _QueueActor
        if actor_options:
            cls = _QueueActor.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, item: Any, block: bool = True,
            timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() > deadline:
                raise Full
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.01)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def get_batch(self, n: int) -> list:
        return ray_tpu_torch.get(self.actor.get_batch.remote(n))

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
