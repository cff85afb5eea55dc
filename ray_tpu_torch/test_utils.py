"""Chaos-testing utilities. Port of ray_tpu/test_utils.py's NodeKiller,
NodePreempter and wait_for_condition (reference:
python/ray/_private/test_utils.py, NodeKillerActor and
wait_for_condition; release/nightly_tests/setup_chaos.py).

`NodeKiller` kills raylets of a `cluster_utils.Cluster` at an interval;
`NodePreempter` drains one to DRAINED first and then kills it, the
spot-reclaim model, at an interval or on a seeded schedule of training
steps. The reference's `NetChaos` (a TCP proxy that faults one link)
is not ported yet (ROADMAP).
"""

from __future__ import annotations

import random
import threading
import time


class NodeKiller:
    """Kills random non-head nodes of a Cluster every `interval_s`.

    with NodeKiller(cluster, interval_s=0.5, respawn=True,
                    node_args={"num_cpus": 2}):
        ... run workload ...
    """

    def __init__(self, cluster, *, interval_s: float = 1.0,
                 respawn: bool = True, node_args: dict | None = None,
                 max_kills: int | None = None, seed: int | None = None):
        self.cluster = cluster
        self.interval_s = interval_s
        self.respawn = respawn
        self.node_args = node_args or {}
        self.max_kills = max_kills
        self.rng = random.Random(seed)
        self.kills = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _victims(self):
        return _victims(self.cluster)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            if self.max_kills is not None and self.kills >= self.max_kills:
                return
            victims = self._victims()
            if not victims:
                continue
            node = self.rng.choice(victims)
            try:
                self.cluster.remove_node(node)
                self.kills += 1
            except Exception:
                continue
            if self.respawn:
                try:
                    self.cluster.add_node(**self.node_args)
                except Exception:
                    pass

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-killer")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def _victims(cluster):
    return [n for n in cluster._node.nodes
            if n is not cluster.head_node and n.proc.poll() is None]


class NodePreempter:
    """Graceful preemption: drain with a deadline, then kill. A preempted
    node's death must be a non-event: the drain evacuated everything
    first.

    Deterministic use::

        result = NodePreempter(cluster, deadline_s=10).preempt(node)
        assert result["state"] == "DRAINED"

    Interval mode mirrors NodeKiller (`interval_s`, `respawn`,
    `node_args`). Step mode (`step_interval`, `step_jitter`,
    `step_source`, a zero-argument callable giving the workload's current
    step) preempts every ~step_interval steps, each gap drawn from the
    seeded rng within +-step_jitter: the same seed gives the same
    schedule.
    """

    def __init__(self, cluster, *, deadline_s: float = 10.0,
                 reason: str = "preemption", interval_s: float | None = None,
                 respawn: bool = False, node_args: dict | None = None,
                 max_preemptions: int | None = None, seed: int | None = None,
                 step_interval: int | None = None,
                 step_jitter: float = 0.3, step_source=None):
        self.cluster = cluster
        self.deadline_s = deadline_s
        self.reason = reason
        self.interval_s = interval_s
        self.respawn = respawn
        self.node_args = node_args or {}
        self.max_preemptions = max_preemptions
        self.rng = random.Random(seed)
        self.preemptions = 0
        self.results: list[dict] = []
        self.step_interval = step_interval
        self.step_jitter = step_jitter
        self.step_source = step_source
        self.step_schedule: list[int] = []  # steps preemptions fired at
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def preempt(self, node, *, kill: bool = True) -> dict:
        """Drain one node with the configured deadline, wait for DRAINED,
        then (by default) kill it. Returns the drain response (its
        "state" is DRAINED on a clean evacuation)."""
        result = self.cluster.drain_node(
            node, deadline_s=self.deadline_s, reason=self.reason, wait=True)
        self.results.append(result)
        if kill:
            self.cluster.remove_node(node)
        self.preemptions += 1
        return result

    def _preempt_one(self) -> bool:
        victims = _victims(self.cluster)
        if not victims:
            return False
        try:
            self.preempt(self.rng.choice(victims))
        except Exception:
            return False
        if self.respawn:
            try:
                self.cluster.add_node(**self.node_args)
            except Exception:
                pass
        return True

    def _spent(self) -> bool:
        return self.max_preemptions is not None \
            and self.preemptions >= self.max_preemptions

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            if self._spent():
                return
            self._preempt_one()

    def _next_gap(self) -> int:
        """Steps until the next preemption: step_interval +- jitter, from
        the seeded rng."""
        lo = max(1, int(round(self.step_interval * (1 - self.step_jitter))))
        hi = max(lo, int(round(self.step_interval * (1 + self.step_jitter))))
        return self.rng.randint(lo, hi)

    def _step_loop(self):
        target = self._next_gap()
        while not self._stop.wait(0.05):
            if self._spent():
                return
            try:
                step = int(self.step_source())
            except Exception:
                continue
            if step < target:
                continue
            if self._preempt_one():
                self.step_schedule.append(step)
                target = step + self._next_gap()

    def start(self):
        if self.step_interval is not None:
            assert self.step_source is not None, \
                "step schedule needs step_source (current-step callable)"
            target = self._step_loop
        else:
            assert self.interval_s is not None, \
                "interval mode needs interval_s; use preempt() directly"
            target = self._loop
        self._thread = threading.Thread(target=target, daemon=True,
                                        name="node-preempter")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def wait_for_condition(predicate, timeout: float = 30.0,
                       retry_interval_ms: float = 100.0) -> None:
    """Poll `predicate` until it returns true; TimeoutError after
    `timeout` seconds, naming the last error it raised (reference:
    _private/test_utils.py wait_for_condition)."""
    deadline = time.monotonic() + timeout
    last_exc = None
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except Exception as e:  # noqa: BLE001
            last_exc = e
        time.sleep(retry_interval_ms / 1000.0)
    msg = f"condition not met within {timeout}s"
    if last_exc is not None:
        msg += f" (last error: {last_exc})"
    raise TimeoutError(msg)
