"""multiprocessing.Pool-compatible API over the port's actors. Port of
ray_tpu/util/multiprocessing.py.

Parity: reference python/ray/util/multiprocessing/pool.py — a drop-in
`Pool` whose workers are cluster actors, so `pool.map` fans out across
nodes instead of local forks. Chunking semantics follow the stdlib: the
iterable is split into chunks, each chunk is one remote task.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable

import ray_tpu_torch

__all__ = ["Pool"]


@ray_tpu_torch.remote
class _PoolWorker:
    def run_chunk(self, fn, chunk, star: bool, extra_args, extra_kwargs):
        if star:
            return [fn(*item) for item in chunk]
        return [fn(item, *extra_args, **extra_kwargs) for item in chunk]


class AsyncResult:
    """Handle on an in-flight map/apply (stdlib AsyncResult shape)."""

    def __init__(self, refs: list, single: bool = False):
        self._refs = refs
        self._single = single

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs,
                                      num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def wait(self, timeout: float | None = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs)
            return True
        except Exception:
            return False

    def get(self, timeout: float | None = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        flat = [x for chunk in chunks for x in chunk]
        return flat[0] if self._single else flat


class Pool:
    """Process pool backed by cluster actors.

    `processes=None` sizes the pool to the cluster's CPU count, like the
    stdlib sizes to os.cpu_count().
    """

    def __init__(self, processes: int | None = None,
                 initializer: Callable | None = None,
                 initargs: tuple = (), ray_remote_args: dict | None = None):
        if processes is None:
            processes = max(1, int(
                ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._size = processes
        opts = dict(ray_remote_args or {})
        self._workers = [_PoolWorker.options(**opts).remote()
                         for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._inflight: list = []  # refs close()/join() must drain
        if initializer is not None:
            # Initializers run once per worker (stdlib semantics); results
            # are discarded.
            ray_tpu_torch.get([
                w.run_chunk.remote(lambda _: initializer(*initargs), [None],
                                   False, (), {})
                for w in self._workers])

    # ---- submission ----

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _submit_chunks(self, fn, iterable, chunksize, star: bool,
                       args=(), kwargs=None) -> list:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, math.ceil(len(items) / (self._size * 4)))
        refs = []
        for i in range(0, len(items), chunksize):
            w = self._workers[next(self._rr)]
            refs.append(w.run_chunk.remote(fn, items[i:i + chunksize], star,
                                           args, kwargs or {}))
        self._inflight.extend(refs)
        if len(self._inflight) > 512:  # prune completed refs
            _, pending = ray_tpu_torch.wait(self._inflight,
                                            num_returns=len(self._inflight),
                                            timeout=0)
            self._inflight = pending
        return refs

    def apply(self, fn: Callable, args: tuple = (), kwds: dict | None = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict | None = None) -> AsyncResult:
        self._check_running()
        w = self._workers[next(self._rr)]
        ref = w.run_chunk.remote(lambda _a, **_k: fn(*args, **(kwds or {})),
                                 [None], False, (), {})
        self._inflight.append(ref)
        return AsyncResult([ref], single=True)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: int | None = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: int | None = None) -> AsyncResult:
        self._check_running()
        return AsyncResult(self._submit_chunks(fn, iterable, chunksize, False))

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: int | None = None) -> list:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn: Callable, iterable: Iterable,
                      chunksize: int | None = None) -> AsyncResult:
        self._check_running()
        return AsyncResult(self._submit_chunks(fn, iterable, chunksize, True))

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int | None = None):
        self._check_running()
        refs = self._submit_chunks(fn, iterable, chunksize, False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int | None = None):
        self._check_running()
        refs = self._submit_chunks(fn, iterable, chunksize, False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for r in ready:
                yield from ray_tpu_torch.get(r)

    # ---- lifecycle ----

    def close(self):
        """Stop accepting work; in-flight tasks keep running (stdlib
        contract — join() then waits for them and reaps the workers)."""
        self._closed = True

    def terminate(self):
        self._closed = True
        for w in self._workers:
            ray_tpu_torch.kill(w)
        self._workers = []
        self._inflight = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")
        if self._inflight:
            ray_tpu_torch.wait(self._inflight,
                               num_returns=len(self._inflight))
            self._inflight = []
        for w in self._workers:
            ray_tpu_torch.kill(w)
        self._workers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
