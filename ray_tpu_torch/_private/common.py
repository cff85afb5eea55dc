"""Shared runtime structures: task specs, resources, addresses.

Parity: reference src/ray/common/task/task_spec.h (TaskSpecification),
src/ray/common/scheduling/resource_set.h (fixed-point resource math — here
plain floats with an epsilon), and the owner address embedded in object refs
(reference: src/ray/protobuf/common.proto Address).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)

RESOURCE_EPS = 1e-9


# ---------- supervised task spawning (graftlint rule R1) ----------
# asyncio.create_task/ensure_future keep only a WEAK reference to the
# spawned task (it can be GC'd mid-flight) and park escaped exceptions
# on the task object where nobody reads them. Both shapes have produced
# real outages here: the lease pump died on an escaped
# ConnectionRefusedError and wedged the task queue for 120s, and
# conn-retirement leaked pending recv tasks as GC cycles (r4 teardown
# flake). supervised_task() is the ONLY sanctioned way to fire-and-
# forget a coroutine — graftlint R1 flags every raw spawn.

_BG_TASKS: set = set()
_task_stats = {"spawned": 0, "errors_total": 0, "ignored_total": 0}


def supervised_task(coro, *, name: str = "", tasks: set | None = None,
                    ignore: tuple = (), on_error=None, log=None):
    """Spawn `coro` as an asyncio task that cannot die silently.

    - Holds a strong reference until the task finishes (in the
      module-level registry, or in `tasks` if the caller needs its own
      cancellation set, e.g. FastRpcServer._inflight).
    - Attaches a done-callback that logs any escaped exception and bumps
      the `errors_total` counter (see task_stats()).
    - `ignore`: exception types that are an expected end-state for this
      task (e.g. ConnectionLost on a best-effort notify); they are
      counted and logged at DEBUG instead of ERROR.
    - `on_error(exc)`: optional hook run before logging.

    Returns the task, so callers may still await/cancel it.
    """
    import asyncio

    task = asyncio.ensure_future(coro)  # graftlint: disable=R1
    if name:
        try:
            task.set_name(name)
        except AttributeError:
            pass
    registry = _BG_TASKS if tasks is None else tasks
    registry.add(task)
    _task_stats["spawned"] += 1
    lg = log or logger

    def _done(t, registry=registry):
        registry.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is None:
            return
        if ignore and isinstance(exc, ignore):
            _task_stats["ignored_total"] += 1
            lg.debug("supervised task %r finished with expected %r",
                     name or str(t), exc)
            return
        _task_stats["errors_total"] += 1
        if on_error is not None:
            try:
                on_error(exc)
            except Exception:
                lg.exception("supervised task %r: on_error hook failed",
                             name or str(t))
        lg.error("supervised task %r died with escaped exception",
                 name or str(t), exc_info=exc)

    task.add_done_callback(_done)
    return task


def task_stats() -> dict:
    """Snapshot of supervised-task counters (spawned/errors/ignored)."""
    return dict(_task_stats)


# ---------- retry policy (session layer; graftlint rule R6) ----------
# Every transient-failure loop in the tree used to roll its own
# delay/except tuple; two of them busy-looped with no jitter and one
# swallowed EMFILE as a bring-up race. RetryPolicy is the ONE shape:
# jittered exponential backoff, a total deadline, and a transient/
# permanent classifier that refuses to retry resource-exhaustion and
# permission errnos.

import errno as _errno

# Local resource exhaustion / misconfiguration: retrying cannot help and
# only hides the bug (the EMFILE class of failure).
_NON_TRANSIENT_ERRNOS = frozenset({
    _errno.EMFILE, _errno.ENFILE, _errno.EACCES, _errno.EPERM,
    _errno.EBADF, _errno.EAFNOSUPPORT, _errno.EPROTONOSUPPORT,
})


@dataclass
class RetryPolicy:
    """Jittered exponential backoff with a total deadline.

    `run(fn)` awaits `fn()` until it succeeds, the deadline expires, or
    a non-transient exception escapes. Transient means: connection-level
    failures (refused/reset/pipe), timeouts, and OSErrors whose errno is
    NOT in the non-transient set; anything in `also_transient` joins the
    set (e.g. rpc.ConnectionLost, which common can't import).
    """

    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5           # each delay drawn from [d*(1-j), d]
    deadline_s: float = 10.0      # total budget; float("inf") = forever
    also_transient: tuple = ()

    def is_transient(self, exc: BaseException) -> bool:
        import asyncio

        if self.also_transient and isinstance(exc, self.also_transient):
            return True
        if isinstance(exc, (ConnectionRefusedError, ConnectionResetError,
                            BrokenPipeError, ConnectionAbortedError,
                            asyncio.TimeoutError, TimeoutError)):
            return True
        if isinstance(exc, OSError):
            return exc.errno not in _NON_TRANSIENT_ERRNOS
        return False

    def delay(self, attempt: int) -> float:
        """Backoff for retry number `attempt` (0-based), jittered."""
        import random

        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** attempt))
        return d * (1.0 - self.jitter * random.random())

    async def run(self, fn, *, name: str = "", log=None):
        """Await `fn()` under this policy. On deadline expiry the LAST
        transient exception is re-raised (not a generic TimeoutError) so
        callers keep their existing except clauses."""
        import asyncio

        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.deadline_s
        attempt = 0
        while True:
            try:
                return await fn()
            except BaseException as e:
                if not self.is_transient(e):
                    raise
                d = self.delay(attempt)
                if loop.time() + d > deadline:
                    raise
                (log or logger).debug(
                    "%s: transient %r; retry %d in %.2fs",
                    name or getattr(fn, "__name__", "retry"), e, attempt, d)
                attempt += 1
                await asyncio.sleep(d)


# ---------- request-frame validation (graftlint rule R5) ----------

class MalformedError(Exception):
    """A request frame failed field validation.

    Raised by require_fields(); the RPC dispatchers turn it into a
    MSG_ERROR response whose text carries "Malformed" — same contract
    as the native service's Malformed() replies (src/gcs_service.cc) —
    instead of a KeyError traceback from deep inside the handler.
    """


def require_fields(payload, *names, method: str = ""):
    """Validate that `payload` is a map carrying every field in `names`.

    Returns the payload so handlers can write
    `payload = require_fields(payload, "node_id", method="Heartbeat")`
    as their first line. graftlint R5 treats fields named here as
    validated; unvalidated subscripts of the request payload are
    flagged.
    """
    where = f" in {method}" if method else ""
    if not isinstance(payload, dict):
        raise MalformedError(
            f"Malformed request{where}: payload must be a map, "
            f"got {type(payload).__name__}")
    missing = [n for n in names if n not in payload]
    if missing:
        raise MalformedError(
            f"Malformed request{where}: missing field(s) "
            f"{', '.join(missing)}")
    return payload


def _maybe_attach_daemon_profiler(name: str) -> None:
    """Env-gated daemon CPU profiler: RAY_TPU_TORCH_DAEMON_PROFILE=<dir> starts
    cProfile at boot; SIGUSR2 dumps `<dir>/<name>-<pid>.pstats` (daemons
    die by SIGKILL, so atexit can't be the dump trigger). Reference
    analog: RAY_PROFILING + py-spy hooks in the dashboard reporter."""
    import os

    out_dir = os.environ.get("RAY_TPU_TORCH_DAEMON_PROFILE")
    if not out_dir:
        return
    import cProfile
    import signal

    prof = cProfile.Profile()
    prof.enable()

    def dump(signum, frame):
        prof.disable()
        path = os.path.join(out_dir, f"{name}-{os.getpid()}.pstats")
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof.dump_stats(path)
        finally:
            prof.enable()

    signal.signal(signal.SIGUSR2, dump)

# Well-known resource names. TPU is first-class: a node exposes `TPU` chips
# and slice-topology labels so gang placement can target ICI-connected hosts
# (reference only knows TPU via autodetect: python/ray/_private/accelerator.py:155).
CPU = "CPU"
GPU = "GPU"
TPU = "TPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def normalize_resources(res: dict[str, float] | None) -> dict[str, float]:
    out = {}
    for k, v in (res or {}).items():
        if v is None:
            continue
        v = float(v)
        if v < 0:
            raise ValueError(f"resource {k} must be >= 0, got {v}")
        if v > 0:
            out[k] = v
    return out


def resources_fit(available: dict[str, float], demand: dict[str, float]) -> bool:
    return all(available.get(k, 0.0) + RESOURCE_EPS >= v for k, v in demand.items())


def subtract_resources(available: dict[str, float], demand: dict[str, float]) -> None:
    for k, v in demand.items():
        available[k] = available.get(k, 0.0) - v


def add_resources(available: dict[str, float], demand: dict[str, float]) -> None:
    for k, v in demand.items():
        available[k] = available.get(k, 0.0) + v


@dataclass
class Address:
    """Network address of a worker/raylet/gcs endpoint."""

    host: str
    port: int
    worker_id: str = ""   # hex; empty for daemons
    node_id: str = ""     # hex

    def to_wire(self):
        return [self.host, self.port, self.worker_id, self.node_id]

    @classmethod
    def from_wire(cls, w):
        return cls(w[0], w[1], w[2], w[3])

    def key(self):
        return (self.host, self.port)


STREAMING_RETURNS = -1  # TaskSpec.num_returns sentinel: streaming generator


@dataclass
class TaskSpec:
    """Wire form of a task invocation (reference: TaskSpecification).

    func_key: GCS function-table key (functions are registered once per job
    and fetched by workers on first use — reference:
    python/ray/_private/function_manager.py).
    args: list of wire-args; each is ["v", meta, data] inline value or
    ["r", object_id, owner_addr] reference.
    """

    task_id: str                      # hex
    job_id: str
    name: str
    func_key: str
    args: list = field(default_factory=list)
    kwargs_keys: list = field(default_factory=list)  # last len(kwargs_keys) args are kwargs
    num_returns: int = 1
    resources: dict = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: bool = False
    owner: list | None = None         # Address.to_wire()
    # actor fields
    actor_id: str = ""                # set for actor tasks
    actor_creation: bool = False
    actor_seq: int = -1               # per-caller ordering for actor tasks
    max_restarts: int = 0
    max_task_retries: int = 0
    # scheduling
    strategy: list | None = None      # e.g. ["spread"], ["node_affinity", node_id, soft]
    placement_group: str = ""         # pg id hex
    pg_bundle_index: int = -1
    runtime_env: dict | None = None
    # W3C traceparent of the submitting span (reference: tracing context
    # propagates inside the TaskSpec, tracing_helper.py).
    trace_ctx: str = ""
    # Actor creation only: how many tasks may execute concurrently on the
    # actor (reference: max_concurrency / async actors, fiber.h).
    max_concurrency: int = 1
    # "device": returned tensors stay pinned in the executing worker
    # (device object plane, _private/device_objects.py); only a small
    # descriptor travels the object path.
    tensor_transport: str = ""

    def to_wire(self):
        return [
            self.task_id, self.job_id, self.name, self.func_key, self.args,
            self.kwargs_keys, self.num_returns, self.resources, self.max_retries,
            self.retry_exceptions, self.owner, self.actor_id, self.actor_creation,
            self.actor_seq, self.max_restarts, self.max_task_retries, self.strategy,
            self.placement_group, self.pg_bundle_index, self.runtime_env,
            self.trace_ctx, self.max_concurrency, self.tensor_transport,
        ]

    @classmethod
    def from_wire(cls, w):
        return cls(*w)


@dataclass
class NodeInfo:
    node_id: str
    host: str
    raylet_port: int
    total_resources: dict
    available_resources: dict
    labels: dict = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    store_path: str = ""
    is_head: bool = False
    # Port of the node's native C++ object-transfer server (0 = none;
    # peers then fall back to the RPC chunk path).
    transfer_port: int = 0
    # Drain ladder (reference: autoscaler.proto DrainNode / rpc
    # DrainNodeReason):
    # ALIVE -> DRAINING (evacuation in progress) -> DRAINED (safe to kill)
    # -> DEAD. A DRAINED node's death is expected and must not trigger
    # recovery storms.
    state: str = "ALIVE"
    drain_reason: str = ""        # preemption | idle | manual
    drain_deadline_s: float = 0.0
    drain_stats: dict = field(default_factory=dict)
    # Suspicion rung (partition tolerance): connection loss marks a node
    # SUSPECT (excluded from new placement, like DRAINING); only a
    # heartbeat-timeout expiry promotes SUSPECT -> DEAD. A re-register
    # inside the grace window restores `pre_suspect_state` and bumps
    # `suspect_recoveries` — the flap was a non-event.
    suspect_since_s: float = 0.0      # wall clock, for display; 0 = not suspect
    pre_suspect_state: str = ""       # state to restore on reconnect
    suspect_recoveries: int = 0       # times this node flapped and came back

    def to_wire(self):
        return {
            "node_id": self.node_id,
            "host": self.host,
            "raylet_port": self.raylet_port,
            "total_resources": self.total_resources,
            "available_resources": self.available_resources,
            "labels": self.labels,
            "alive": self.alive,
            "store_path": self.store_path,
            "is_head": self.is_head,
            "transfer_port": self.transfer_port,
            "state": self.state,
            "drain_reason": self.drain_reason,
            "drain_deadline_s": self.drain_deadline_s,
            "drain_stats": self.drain_stats,
            "suspect_since_s": self.suspect_since_s,
            "suspect_recoveries": self.suspect_recoveries,
        }


def wait_for_drained(get_nodes, node_id: str, deadline_s: float, *,
                     poll_s: float = 0.2, slack_s: float = 10.0):
    """Poll `get_nodes()` (a callable returning node-table wire dicts)
    until `node_id` finishes its drain. ONE implementation for every
    wait-for-DRAINED caller (CLI, autoscaler monitor, cluster_utils) so
    they cannot disagree about what a finished drain looks like.

    Returns (outcome, node_wire | None) with outcome one of:
      "DRAINED" — evacuation completed (even if the node has since
                  died: a self-drained raylet exits right after);
      "DIED"    — dead before reaching DRAINED (evacuation failed);
      "GONE"    — node vanished from the table;
      "TIMEOUT" — still draining past deadline_s + slack_s;
      "ERROR"   — get_nodes itself failed.
    """
    deadline = time.monotonic() + deadline_s + slack_s
    me = None
    while time.monotonic() < deadline:
        try:
            nodes = get_nodes()
        except Exception:
            logger.warning("wait_for_drained(%s): node listing failed",
                           node_id[:8], exc_info=True)
            return "ERROR", me
        me = next((n for n in nodes if n["node_id"] == node_id), None)
        if me is None:
            return "GONE", None
        if me.get("state") == "DRAINED":
            return "DRAINED", me
        if not me.get("alive"):
            return "DIED", me
        time.sleep(poll_s)
    return "TIMEOUT", me


def loaded_packages() -> list[str]:
    """Sorted top-level names in this process's sys.modules (daemon state
    calls report it)."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if not m.startswith("_")})
