"""Event-loop / RPC-dispatch statistics for the daemon servers.

Python analogue of the reference's src/ray/common/asio/event_stats.h
(`RecordExecution` around every event-loop post: per-handler call count,
cumulative and max execution time, plus loop-level queueing stats).
Here the instrumented loop is the daemon RPC server — the native frame
pump's drain callback (fast_rpc.FastRpcServer) or the asyncio fallback
(rpc.RpcServer) — so the numbers attribute exactly where the GCS/raylet
event loop spends its time, per RPC method.

One instance per server; every update runs on that server's loop thread
(or inside its drain callback), so plain dict mutation is safe. The
snapshot is read cross-thread by the GetEventLoopStats handler — worst
case it observes a half-updated bucket, never a torn structure.
"""

from __future__ import annotations

import time


class EventLoopStats:
    __slots__ = ("name", "start_time", "handlers", "drains", "events",
                 "max_batch", "queue_depth", "queue_depth_max")

    def __init__(self, name: str = "loop"):
        self.name = name
        self.start_time = time.time()
        # method -> [count, errors, cum_seconds, max_seconds]
        self.handlers: dict[str, list] = {}
        self.drains = 0          # drain callbacks (loop wakeups)
        self.events = 0          # events pulled across all drains
        self.max_batch = 0       # largest single drain batch
        self.queue_depth = 0     # in-flight async dispatches (last seen)
        self.queue_depth_max = 0

    def record_handler(self, method: str, dt_s: float,
                       error: bool = False) -> None:
        h = self.handlers.get(method)
        if h is None:
            h = self.handlers[method] = [0, 0, 0.0, 0.0]
        h[0] += 1
        if error:
            h[1] += 1
        h[2] += dt_s
        if dt_s > h[3]:
            h[3] = dt_s

    def record_drain(self, n_events: int) -> None:
        self.drains += 1
        self.events += n_events
        if n_events > self.max_batch:
            self.max_batch = n_events

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        if depth > self.queue_depth_max:
            self.queue_depth_max = depth

    def snapshot(self) -> dict:
        handlers = {}
        for method, (count, errors, cum_s, max_s) in list(
                self.handlers.items()):
            handlers[method] = {
                "count": count,
                "errors": errors,
                "cum_ms": round(cum_s * 1000.0, 3),
                "max_ms": round(max_s * 1000.0, 3),
                "mean_ms": round(cum_s / count * 1000.0, 4) if count else 0.0,
            }
        return {
            "name": self.name,
            "uptime_s": round(time.time() - self.start_time, 3),
            "handlers": handlers,
            "loop": {
                "drains": self.drains,
                "events": self.events,
                "max_batch": self.max_batch,
                "queue_depth": self.queue_depth,
                "queue_depth_max": self.queue_depth_max,
            },
        }
