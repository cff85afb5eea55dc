"""CoreWorker: per-process runtime — ownership, task submission, execution.

Re-design of the reference's core_worker library + Cython binding
(reference: src/ray/core_worker/core_worker.cc — SubmitTask:1878,
CreateActor:1948, SubmitActorTask:2182, Get:1353, Put:1141, ExecuteTask:2565;
reference_count.cc ownership/borrowing; task_manager.cc retries + lineage;
object_recovery_manager.h:96 lineage reconstruction; transport:
direct_task_transport.cc lease pool + PushNormalTask:588,
direct_actor_task_submitter.h:68 ordered per-actor queues;
python/ray/_raylet.pyx task_execution_handler:1981).

Every process that touches the cluster embeds one CoreWorker:
- the *driver* (ray_tpu_torch.init()) for submitting work and owning results
- pool *workers* spawned by raylets for executing tasks / hosting actors

Threading model: all network IO runs on a dedicated asyncio loop thread;
task execution runs on the process main thread (workers) so blocking user
code never stalls RPC. Public methods are thread-safe wrappers that post
coroutines to the loop (the reference gets the same split with C++ io
threads + the Python main loop in _raylet.pyx:3044 run_task_loop).

Ownership model (reference: reference_count.cc): the submitting process is
the *owner* of result objects. The owner stores small results inline in its
in-process memory store, tracks shm locations of large results, serves
`GetObjectStatus` long-polls to other processes, and reconstructs lost
task-produced objects by resubmitting their creating task (lineage).

Borrower protocol (reference: reference_count.cc borrowing): refs serialized
inside payloads are COLLECTED, not pinned. Holds are per-cause — submission
holds released at task completion, container holds released when the
enclosing object frees, per-handle borrow counts released by ObjectRef
GC — and every handoff registers the recipient with the owner BEFORE the
sender's own hold can release (reply-reported arg borrows; eager forward
for returns and status fetches), so the owner frees an object only when
local refs, submitted refs, and the borrowers set are all empty. The only
job-lifetime pin left is for refs pickled outside any runtime context.
"""

from __future__ import annotations

import asyncio
import collections as _collections
import functools
import hashlib
import inspect
import itertools
import logging
import os
import queue as _queue
import threading
import time
import traceback
from collections import defaultdict, deque

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.common import (STREAMING_RETURNS, Address,
                                     TaskSpec, normalize_resources,
                                     require_fields, supervised_task)
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import ObjectStoreClient, ObjectStoreFullError

logger = logging.getLogger(__name__)

OBJ_PENDING = "pending"
OBJ_READY = "ready"
OBJ_FAILED = "failed"
# A completion the native task loop holds for its batch is sent once the
# task running after it has taken this long (_HeldDoneWatch).
FP_HOLD_S = 0.002



class _ShmPin:
    """Holds one store read-reference for a zero-copy payload.

    Deserialized numpy arrays are views into shm; building them from
    `memoryview(_ShmPin)` (PEP 688 __buffer__) makes every view keep this
    object alive, and the LAST view's death releases the store ref —
    the pure-Python equivalent of plasma's PlasmaBuffer destructor
    (reference: plasma client buffer lifetime)."""

    __slots__ = ("_mv", "_store", "_oid")

    def __init__(self, mv, store, oid):
        self._mv = mv
        self._store = store
        self._oid = oid

    def __buffer__(self, flags):
        # Read-only: a view must not write to the sealed object.
        return memoryview(self._mv).toreadonly()

    def __del__(self):
        try:
            self._store.release(self._oid)
        except Exception:
            pass  # store already torn down at interpreter exit


def _pep688_supported() -> bool:
    """Python-class __buffer__ (PEP 688) landed in 3.12; older
    interpreters must fall back to copying payloads out of shm."""
    class _Probe:
        def __buffer__(self, flags):
            return memoryview(b"")

    try:
        memoryview(_Probe())
        return True
    except TypeError:
        return False


_HAS_PEP688 = _pep688_supported()


class _OwnedObject:
    __slots__ = ("state", "inline", "locations", "lineage_task", "error",
                 "ready_event", "local_refs", "submitted_refs", "size",
                 "borrowers", "device")

    def __init__(self):
        self.state = OBJ_PENDING
        self.inline = None          # (meta: bytes, data: bytes) for small values
        self.locations: set[str] = set()
        self.lineage_task: str | None = None  # creating task id (hex)
        self.error = None           # (meta, data) serialized exception
        self.ready_event: asyncio.Event | None = None
        self.local_refs = 0
        self.submitted_refs = 0     # pending tasks that take this as an arg
        self.size = 0
        # Device object plane (device_objects.py): [pin_worker_addr_wire,
        # key_prefix, pinned_bytes, n_leaves] when this object's payload
        # is pinned on a worker; freeing the object unpins it.
        self.device = None
        # Borrower protocol (reference: reference_count.cc): worker_ids of
        # remote processes known to hold a reference. A non-empty set
        # blocks freeing; the owner's WaitForRefRemoved watches remove
        # entries when borrowers release or die.
        self.borrowers: set[str] = set()


class _BorrowedRef:
    """This process's accounting for ONE object owned elsewhere
    (reference: reference_count.cc borrower-side state). count aggregates
    every local holder: live ObjectRef instances, containers (return
    values / puts) embedding the ref, and in-flight submissions that
    forwarded it. `registered` means the owner knows about us; release is
    OWNER-INITIATED — the owner long-polls WaitForRefRemoved and we answer
    when count reaches zero (removed_event), which makes release ordering
    race-free by construction (reference: WaitForRefRemoved pub/sub in
    reference_count.cc)."""
    __slots__ = ("owner", "count", "registered", "removed_event")

    def __init__(self, owner):
        self.owner = owner
        self.count = 0
        self.registered = False
        self.removed_event: asyncio.Event | None = None


_task_seq = itertools.count(1)

# Exact types only: a subclass could carry ObjectRef attributes.
_PRIMITIVE_TYPES = frozenset(
    (int, float, bool, str, bytes, type(None)))


class _PendingTask:
    __slots__ = ("spec", "retries_left", "constructor_like", "futures",
                 "pushed_to", "nested_args", "seq", "return_hexes",
                 "stream_q", "next_yield_index", "reconstructing",
                 "submitted_ts")

    def __init__(self, spec: TaskSpec, retries_left: int,
                 nested_args: list | None = None):
        self.spec = spec
        self.retries_left = retries_left
        # Wall-clock submission time: the task-lifecycle ladder's origin
        # (lease timestamps from a warm, pre-existing slot clamp to it).
        self.submitted_ts = time.time()
        self.futures: list[asyncio.Future] = []
        self.pushed_to: str | None = None
        # Return ObjectID hexes, filled by submit_task so completion does
        # not re-derive them (each is a sha1).
        self.return_hexes: list[str] | None = None
        # Streaming tasks (num_returns="streaming"): thread-safe queue the
        # driver-side ObjectRefGenerator drains; items are ("item",
        # oid_hex) / ("end",) / ("error", meta, data).
        self.stream_q = None
        # Next yield index expected from the stream. On a retry the
        # generator re-executes from scratch; yields with index below
        # this were already delivered and are dropped (fast-forward —
        # reference: generator task retries replay only unconsumed
        # returns, task_manager.cc HandleReportGeneratorItemReturns).
        self.next_yield_index = 0
        # Lineage-reconstruction re-execution of a completed STREAMING
        # task: yields only refresh their owned objects — nothing is
        # delivered to a consumer (the original generator is long gone).
        self.reconstructing = False
        # Refs serialized INSIDE value args (not top-level): list of
        # (oid_hex, owner_wire|None); refcounted like top-level args and
        # released at completion per the borrower protocol.
        self.nested_args = nested_args or []
        # Submission order, kept across retries: queues stay sorted by
        # seq so a retried producer re-enters AHEAD of a later-submitted
        # consumer (a tail re-enqueue could order the consumer first in
        # the same push batch, which executes sequentially on one worker
        # thread — the consumer would block forever on the producer's
        # return object while the producer sits behind it).
        self.seq = next(_task_seq)


class _HeldDoneWatch:
    """Sends a PushTaskBatch's held completions (TaskDone) once the task
    running after them has taken `hold_s`: a fast task's result must not
    wait for a slow batch-mate, as it does not on the asyncio task loop,
    which sends each completion from the event loop. One daemon thread a
    worker, started at the first hold, for every exec thread; it sleeps
    while nothing is held, and a task that starts with completions held
    costs one lock round."""

    def __init__(self, hold_s: float):
        self._hold_s = hold_s
        self._cv = threading.Condition()
        self._held: dict = {}  # exec thread ident -> (task start, flush)
        self._idle = True
        self._thread = None

    def hold(self, flush) -> None:
        """The calling exec thread starts a task while `flush` would send
        completions it holds; None: it holds none (or the task ended)."""
        key = threading.get_ident()
        with self._cv:
            if flush is None:
                self._held.pop(key, None)
                return
            self._held[key] = (time.monotonic(), flush)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="fp-held-done")
                self._thread.start()
            elif self._idle:
                self._cv.notify()

    def _run(self) -> None:
        while True:
            due = []
            with self._cv:
                if not self._held:
                    self._idle = True
                    self._cv.wait()
                    self._idle = False
                    continue
                now = time.monotonic()
                first = min(since for since, _ in self._held.values())
                if now - first < self._hold_s:
                    self._cv.wait(first + self._hold_s - now)
                    continue
                for key, (since, flush) in list(self._held.items()):
                    if now - since >= self._hold_s:
                        due.append(flush)
                        del self._held[key]
            for flush in due:
                try:
                    flush()
                except Exception:
                    logger.exception("fastpath: held completions not sent")


class _LeaseSlot:
    """One leased worker. `outstanding` tracks tasks pushed but not yet
    completed (streamed TaskDone notifies drain it; a closed connection
    fails/retries everything left in it)."""
    __slots__ = ("conn", "lease_id", "worker_id", "node_id", "raylet", "busy",
                 "idle_since", "outstanding", "worker_addr", "fp_id",
                 "pushed_any", "lease_requested_ts", "lease_granted_ts",
                 "lease_timing")

    def __init__(self, conn, lease_id, worker_id, node_id, raylet,
                 worker_addr=None, lease_requested_ts=None,
                 lease_granted_ts=None):
        self.conn = conn
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.node_id = node_id
        self.raylet = raylet
        self.busy = False
        self.idle_since = time.monotonic()
        self.outstanding: dict = {}  # task_id -> _PendingTask
        self.worker_addr = worker_addr  # Address wire of the worker
        self.fp_id = None  # native fastpath conn id (None = asyncio path)
        self.pushed_any = False  # ever dispatched (spread recycle gate)
        # Lease negotiation wall-clock stamps for the lifecycle ladder
        # (per-task LEASE_* events clamp these to the task's own
        # submission time — a warm lease predates late submissions).
        now = time.time()
        self.lease_requested_ts = lease_requested_ts or now
        self.lease_granted_ts = lease_granted_ts or now
        self.lease_timing = None  # raylet-side stamps from the grant


def _shape_key(resources: dict) -> str:
    return repr(sorted(resources.items()))


class CoreWorker:
    def __init__(self, *, gcs_host: str, gcs_port: int, raylet_host: str,
                 raylet_port: int, store_path: str, node_id: str,
                 is_driver: bool, job_id: str | None = None,
                 worker_id: str | None = None, config: Config | None = None,
                 owns_cluster: bool = False):
        self.config = config or Config()
        self.gcs_host, self.gcs_port = gcs_host, gcs_port
        self.raylet_host, self.raylet_port = raylet_host, raylet_port
        self.node_id = node_id
        self.is_driver = is_driver
        self.owns_cluster = owns_cluster
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.job_id = job_id or JobID.from_random().hex()
        self.store = ObjectStoreClient(store_path)
        self.objects: dict[str, _OwnedObject] = {}
        self.pending_tasks: dict[str, _PendingTask] = {}
        self.lineage: dict[str, TaskSpec] = {}
        self._lineage_bytes = 0
        self._lineage_est: dict[str, int] = {}  # exact add, exact subtract
        # Live owned objects per lineage task: the spec is only dropped
        # when the LAST object created by that task is freed (a streamed
        # generator's yields share one spec — freeing the first consumed
        # yield must not strand the others without reconstruction).
        self._lineage_live: dict[str, int] = {}
        # Recovery accounting: lineage re-executions started by this
        # owner, and losses recovered instead from the GCS's drained-node
        # relocation directory. A clean drain shows relocations > 0 and
        # reconstructions == 0 (what the chaos tests assert).
        self._num_reconstructions = 0
        self._num_relocation_recoveries = 0
        self.actor_handles_state: dict[str, dict] = {}  # actor_id -> conn/seq/queue
        self._fn_cache: dict[str, object] = {}
        self._put_counter = itertools.count(1)
        self._task_counter = itertools.count(1)
        self._task_id_prefix = os.urandom(TaskID.SIZE - 8)
        self._default_task_id = TaskID.from_random()
        self._exec_tls = threading.local()  # per-thread current task id
        # executor
        self._exec_queue: _queue.Queue = _queue.Queue()
        # Card ids the raylet's current lease holds for this worker
        # (SetLeaseDevices); pinned at task start (accelerator.py).
        self._lease_gpu_ids: list[str] = []
        # Native fastpath IO plane (csrc/fastpath.cc): C++ epoll pumps own
        # the steady-state task cycle. _fp_exec_pump (pool workers only)
        # serves inbound PushTaskBatch and carries TaskDone/TaskYield
        # back; _fp_sub_pump (lazily, any submitter) carries this
        # process's outbound pushes and completion drains.
        # Off with the config's `fastpath` (RAY_TPU_TORCH_NATIVE_CONTROL=0);
        # a pump that does not build or listen raises.
        from ray_tpu_torch._private import native_fastpath
        self._fp = native_fastpath if self.config.fastpath else None
        self._fp_exec_pump = None
        self._fp_sub_pump = None
        self._fp_held_watch = _HeldDoneWatch(FP_HOLD_S)
        self.fp_port = 0
        self._fp_slots: dict = {}      # fp conn_id -> (_LeaseSlot, shape)
        self._fp_backlog: list = []
        self._fp_processing = False
        self._inject_items: dict = {}  # token -> exec item (queue bypass)
        self._inject_token = itertools.count(1)
        self._inject_lock = threading.Lock()
        if self._fp is not None and not is_driver:
            self._fp_exec_pump = native_fastpath.FastPump()
            self.fp_port = self._fp_exec_pump.listen()
        self._actor_instance = None
        self._actor_id: str | None = None
        self._actor_callers: dict[str, dict] = {}
        self._shutdown = False
        # loop thread
        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._run_loop, daemon=True,
                                             name="ray_tpu_torch-io")
        self._loop_ready = threading.Event()
        self._loop_thread.start()
        self._loop_ready.wait()
        # Connections (established in async_init)
        self.gcs: rpc.Connection | None = None
        self.raylet: rpc.Connection | None = None
        self.server: rpc.RpcServer | None = None
        self.address: Address | None = None
        # Cached outbound conns (per owner / per raylet) + per-key connect
        # locks: concurrent first uses must not each open a connection
        # and orphan the losers' sockets + recv tasks.
        self._owner_conns: dict = {}
        self._raylet_conns: dict = {}
        self._conn_locks: dict = {}
        self._leases: dict[str, list[_LeaseSlot]] = defaultdict(list)
        self._lease_requests_in_flight: dict[str, int] = defaultdict(int)
        self._lease_retry_logged = 0.0  # rate-limits lease-retry warnings
        # pg_id -> [promise oid_hex] armed by pg_ready_promise.
        self._pg_ready_waiters: dict[str, list[str]] = {}
        # Strong refs to fire-and-forget loop tasks (the loop keeps
        # tasks weakly; a GC'd pending task never runs its cleanup).
        self._bg_tasks: set = set()
        # shape -> deque[task_id]: popleft is O(1) — a LIST's pop(0)
        # memmoves the whole queue per task, which at 200k queued depth
        # turned the drain phase into ~GBs of shifting (r4's 5.8k/s
        # drain ceiling vs 12k/s submit).
        self._queues: dict[str, deque] = defaultdict(deque)
        # Shapes submitted with SPREAD: dispatch ONE task per push so
        # work disperses across the cluster's width instead of batching
        # onto early leases (reference: spread_scheduling_policy.cc
        # round-robins each task over feasible nodes).
        self._spread_shapes: set[str] = set()
        # Submission batching: caller threads append here; ONE loop wakeup
        # drains the whole burst (reference analog: the Cython submit path
        # amortizes into the C++ submitter; here we amortize loop wakeups).
        self._submit_buf: list = []
        self._submit_lock = threading.Lock()
        self._submit_scheduled = False
        # Ref-count op batching: same trick for add/remove_local_ref and
        # bump_submitted_ref — a burst of ObjectRef creations costs one
        # loop wakeup, not one self-pipe write per ref.
        self._post_buf: list = []
        self._post_lock = threading.Lock()
        self._post_scheduled = False
        # Worker-side completion streaming (see _queue_task_done).
        self._done_buf: dict = {}
        self._done_lock = threading.Lock()
        self._done_scheduled: set = set()
        # Borrower protocol state (reference: reference_count.cc).
        self.borrowed: dict[str, _BorrowedRef] = {}   # oid -> borrow state
        self._borrow_lock = threading.Lock()
        # container oid -> [(nested_oid, owner_wire|None), ...]: refs
        # embedded in a stored payload; released when the container frees.
        self._container_nested: dict[str, list] = {}
        self._actor_task_nested: dict[str, list] = {}  # task_id -> nested
        # container oid -> {nested oids} pre-registered for us by the
        # container's owner (consumed by get()'s deserialize).
        self._fetched_prereg: dict[str, set] = {}
        self._borrow_watches: dict = {}  # (oid, borrower) -> generation
        # Streaming tasks whose driver-side generator was closed: later
        # yields free on arrival instead of buffering forever.
        self._abandoned_streams: set[str] = set()
        # task_id -> stream queue, for the whole life of the consumer
        # generator (pending_tasks entries die at completion; the
        # abandon path must outlive them — see _abandon_stream_impl).
        self._stream_queues: dict[str, _queue.Queue] = {}
        self._task_events: list = []
        # Elastic-training signal surfaces: NODE state-transition
        # subscribers (GCS pubsub, lazy channel subscribe) and
        # raylet→worker DrainNotice subscribers (pre-death signal for
        # processes ON the draining node).
        self._node_event_listeners: list = []
        self._drain_notice_listeners: list = []
        self._run(self._async_init())
        # GC tuning for task-burst workloads: default thresholds run a
        # collection every ~700 allocations, and with 100k+ pending
        # tasks/objects live each pass rescans them all — measured ~15%
        # of drain throughput on a 200k-task queue. DRIVERS freeze the
        # warm startup heap out of scanning and raise the young-gen
        # threshold (driver churn is ray_tpu_torch bookkeeping). Pool workers
        # do NEITHER here: their startup heap is frozen once in the
        # ZYGOTE template pre-fork (worker_zygote.main — a collect per
        # spawned worker cost ~70ms on a framework-warm heap and capped
        # actor bursts), and user code's cyclic garbage must keep
        # collecting at the default cadence — unless RAY_TPU_TORCH_GC_GEN0 is
        # set explicitly (it overrides everywhere; 0 = leave thresholds
        # alone). COLD-spawned workers (zygote disabled/retired/failed)
        # have no pre-frozen template, so they freeze here.
        import gc

        if is_driver or not os.environ.get("RAY_TPU_TORCH_FORKED_FROM_ZYGOTE"):
            gc.collect()
            gc.freeze()
        gen0 = int(os.environ.get("RAY_TPU_TORCH_GC_GEN0",
                                  "50000" if is_driver else "0"))
        if gen0 > 0:
            gc.set_threshold(gen0, 20, 20)

    # ---------- plumbing ----------

    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        self._loop_ready.set()
        self.loop.run_forever()

    def _run(self, coro, timeout: float | None = None):
        """Run a coroutine on the IO loop from any thread."""
        try:
            fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:
            # Loop already stopped (shutdown race): close the coroutine
            # so it doesn't surface as a 'never awaited' RuntimeWarning.
            coro.close()
            raise
        return fut.result(timeout)

    def _spawn(self, coro):
        if self._shutdown:
            # Teardown race: a spawn that lands between loop.stop() and
            # the drain tick is only ever a ready callback — never a
            # Task — and GC reports it 'never awaited'. Spawns after
            # shutdown starts are best-effort by definition; drop them
            # deterministically instead.
            coro.close()
            return
        try:
            asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:
            coro.close()

    async def _async_init(self):
        self.server = rpc.RpcServer({
            "PushTaskBatch": self._handle_push_task_batch,
            "ActorCall": self._handle_actor_call,
            "ActorSeqSkip": self._handle_actor_seq_skip,
            "AssignActor": self._handle_assign_actor,
            "GetObjectStatus": self._handle_get_object_status,
            "AddObjectLocation": self._handle_add_object_location,
            "BorrowRef": self._handle_borrow_ref,
            "WaitForRefRemoved": self._handle_wait_for_ref_removed,
            "SetLeaseDevices": self._handle_set_lease_devices,
            "DeviceObjectPull": self._handle_device_object_pull,
            "DeviceObjectRelease": self._handle_device_object_release,
            "DeviceObjectStats": self._handle_device_object_stats,
            "DeviceObjectEvacuate": self._handle_device_object_evacuate,
            "DeviceObjectRepin": self._handle_device_object_repin,
            "DrainNotice": self._handle_drain_notice,
            "Ping": lambda conn, p: {"ok": True},
            "DumpStack": self._handle_dump_stack,
            "DebugTasks": self._handle_debug_tasks,
            "Profile": self._handle_profile,
        }, name=f"worker-{self.worker_id[:8]}")
        host, port = await self.server.start("127.0.0.1", 0)
        self.address = Address(host, port, self.worker_id, self.node_id)
        self._gcs_channels = []
        # Resilient session: survives GCS restarts AND network flaps —
        # the _gcs_reattach handshake (resubscribe + job re-registration
        # + PG-waiter requery) runs on every re-established socket before
        # any stamped call is replayed (reference: workers retry through
        # gcs_client across GCS failover).
        self.gcs = await rpc.connect_session(
            self.gcs_host, self.gcs_port,
            handlers={"Publish": self._on_gcs_publish},
            name=f"w{self.worker_id[:8]}->gcs",
            grace_s=self.config.gcs_reconnect_timeout_s,
            connect_timeout_s=self.config.rpc_connect_timeout_s,
            on_reconnect=self._gcs_reattach)
        self.gcs.on_close(self._on_gcs_session_failed)
        # Drivers subscribe eagerly (they hold actor handles from the
        # start); pool workers subscribe lazily on their first handle —
        # see _actor_state (an eager per-worker ACTOR subscription made
        # actor-creation bursts O(N^2) in publish fan-out).
        channels = ["ACTOR"] if self.is_driver else []
        if self.is_driver and self.config.log_to_driver:
            channels.append("LOGS")
        self._gcs_channels = channels
        if channels:
            await self.gcs.call("Subscribe", {"channels": channels})
        # The raylet pushes AssignActor/Exit over this same connection, so
        # it carries the worker's full handler table. Drivers get a short
        # reconnect grace (a flapped local socket re-registers); pool
        # workers keep grace 0 — a lost raylet conn still means exit
        # (reference: workers exit on raylet socket disconnect), so a
        # dead node leaves no orphans racing against retried tasks.
        self.raylet = await rpc.connect_session(
            self.raylet_host, self.raylet_port,
            handlers=self.server.handlers,
            name=f"w{self.worker_id[:8]}->raylet",
            grace_s=(self.config.rpc_session_grace_s
                     if self.is_driver else 0.0),
            connect_timeout_s=self.config.rpc_connect_timeout_s,
            on_reconnect=self._raylet_reattach)
        await self.raylet.call("RegisterWorker", {
            "worker_id": self.worker_id, "host": host, "port": port,
            "fp_port": self.fp_port})
        if not self.is_driver:
            self.raylet.on_close(
                lambda: (not self._shutdown) and os._exit(1))
        if self.is_driver:
            await self.gcs.call("RegisterJob", {
                "job_id": self.job_id, "driver_address": self.address.to_wire(),
                "entrypoint": " ".join(os.sys.argv),
                # Local-mode sessions die with their driver (reference: a
                # ray.init() head tears down when the driver exits).
                "owns_cluster": self.owns_cluster})
        supervised_task(self._flush_task_events_loop(),
                        name="flush-task-events")

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        # Stop the usage-stats daemon thread (attached by ray_tpu_torch.init)
        # so init/shutdown cycles don't leak pollers against a
        # torn-down runtime.
        reporter = getattr(self, "_usage_reporter", None)
        if reporter is not None:
            try:
                reporter.stop()
            except Exception:
                pass
        try:
            self._run(self._async_shutdown(), timeout=8)
        except Exception:
            pass
        # Belt-and-braces second pass: whatever survived (or was spawned
        # by close callbacks during) the graceful teardown is cancelled
        # and AWAITED here, so loop.stop() finds a quiet loop — "Task was
        # destroyed but it is pending!" is a bug, not noise.
        try:
            self._run(self._final_cancel(), timeout=3)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join(timeout=2)
        # Native pumps go after the loop stops (the reader was removed in
        # _async_shutdown; destroy wakes any exec thread still blocked in
        # next() — the C side keeps the handle's sync primitives alive).
        for pump in (self._fp_exec_pump, self._fp_sub_pump):
            if pump is not None:
                try:
                    pump.close()
                except Exception:
                    pass
        self._fp_exec_pump = self._fp_sub_pump = None
        self._drain_and_close_loop()
        try:
            self.store.close()
        except Exception:
            pass

    def _drain_and_close_loop(self):
        """Retire EVERYTHING still attached to the (now stopped) loop, then
        close it. Two timing-dependent leaks end here: (a) a coroutine
        handed to run_coroutine_threadsafe just before loop.stop() is only
        a ready callback — never a Task — so GC reports it 'never awaited';
        (b) a task the bounded cancel sweeps missed surfaces as 'Task was
        destroyed but it is pending!'. Running the stopped loop from this
        thread turns (a) into real tasks, then one cancel+await retires
        both. Closing the loop makes any later _run fail fast (RuntimeError
        path in _run closes the coroutine)."""
        if self._loop_thread.is_alive() or self.loop.is_closed():
            return  # wedged loop thread: closing under it would be worse
        try:
            # One tick: promote queued threadsafe callbacks into tasks.
            self.loop.run_until_complete(asyncio.sleep(0))
            pending = asyncio.all_tasks(self.loop)
            for t in pending:
                t.cancel()
            if pending:
                self.loop.run_until_complete(
                    asyncio.wait(pending, timeout=2))
            self.loop.close()
        except Exception:
            pass

    async def _async_shutdown(self):
        if self._fp_sub_pump is not None:
            try:
                self.loop.remove_reader(self._fp_sub_pump.eventfd)
            except Exception:
                pass
        if self.is_driver and self.gcs and not self.gcs.closed:
            try:
                await self.gcs.call("FinishJob", {"job_id": self.job_id}, timeout=2)
            except Exception:
                pass

        # Leases go back in PARALLEL: the old sequential 2s-per-slot walk
        # could outlive the whole shutdown budget, skipping the cancel
        # sweep below — the actual source of the r3 teardown noise.
        async def give_back(s):
            try:
                await s.raylet.call("ReturnWorker",
                                    {"lease_id": s.lease_id}, timeout=2)
            except Exception:
                pass
        all_slots = [s for slots in self._leases.values() for s in slots]
        if all_slots:
            await asyncio.gather(*(give_back(s) for s in all_slots),
                                 return_exceptions=True)
        if self.server:
            await self.server.stop()
        # EVERY connection this worker owns: gcs, raylet, lease slots,
        # cached owner/raylet conns, actor conns.
        conns = [self.gcs, self.raylet]
        conns += [s.conn for s in all_slots]
        conns += list(self._owner_conns.values())
        conns += list(self._raylet_conns.values())
        conns += [st.get("conn") for st in self.actor_handles_state.values()]
        for c in conns:
            if c is not None and not c.closed:
                try:
                    await c.close()
                except Exception:
                    pass
        await self._cancel_stragglers()

    async def _cancel_stragglers(self, timeout: float = 1.0):
        """Cancel + AWAIT every other task on the loop — cancelling
        without awaiting leaves 'Task was destroyed but it is pending!'
        at loop teardown."""
        pending = [t for t in asyncio.all_tasks()
                   if t is not asyncio.current_task()]
        for t in pending:
            t.cancel()
        if pending:
            try:
                await asyncio.wait(pending, timeout=timeout)
            except Exception:
                pass

    async def _final_cancel(self):
        await self._cancel_stragglers(timeout=1.5)

    # ---------- events ----------

    def _record_task_event(self, task_id: str, name: str, state: str,
                           ts: float | None = None, **extra):
        # Hot path (several per task): append a tuple; the flush loop
        # formats the wire dicts off the critical path. `ts` lets the
        # lease ladder stamp negotiation times captured earlier.
        self._task_events.append(
            (task_id, name, state, time.time() if ts is None else ts,
             extra or None))

    _TASK_EVENT_FLUSH_MAX = 5000

    async def _flush_task_events_loop(self):
        dropped = 0
        while True:
            await asyncio.sleep(1.0)
            if self._task_events and self.gcs and not self.gcs.closed:
                batch, self._task_events = self._task_events, []
                if len(batch) > self._TASK_EVENT_FLUSH_MAX:
                    # Pressure valve (reference: task_event_buffer.h caps
                    # buffered events and counts drops): at 10k+ tasks/s
                    # shipping 3 events/task would make the GCS steal the
                    # core the tasks need. Keep the newest window.
                    first_drop = dropped == 0
                    dropped += len(batch) - self._TASK_EVENT_FLUSH_MAX
                    batch = batch[-self._TASK_EVENT_FLUSH_MAX:]
                    if first_drop:
                        logger.info("task events exceed flush budget; "
                                    "dropping oldest (state API sees a "
                                    "sampled view under burst load)")
                events = []
                for task_id, name, state, ts, extra in batch:
                    ev = {"task_id": task_id, "name": name, "state": state,
                          "node_id": self.node_id,
                          "worker_id": self.worker_id,
                          "job_id": self.job_id, "ts": ts}
                    if extra:
                        ev.update(extra)
                    events.append(ev)
                try:
                    await self.gcs.call("AddTaskEvents", {"events": events},
                                        timeout=5)
                except Exception:
                    pass

    # ---------- put / get / wait ----------

    @property
    def _current_task_id(self) -> TaskID:
        # Thread-local: concurrent actor tasks (max_concurrency > 1) each
        # carry their own task id for puts/lineage attribution.
        return getattr(self._exec_tls, "task_id", None) or self._default_task_id

    @_current_task_id.setter
    def _current_task_id(self, value) -> None:
        self._exec_tls.task_id = value

    def put(self, value) -> "tuple[ObjectID, Address]":
        from ray_tpu_torch._private.api_internal import collect_nested_refs

        oid = ObjectID.for_put(self._current_task_id,
                               next(self._put_counter))
        with collect_nested_refs() as sink:
            sobj = serialization.serialize(value)
        if sink:
            # Embedded refs live as long as the put container does.
            self._post(self._track_container, oid.hex(), list(sink))
        self._run(self._store_owned(oid, sobj))
        return oid, self.address

    # ---- promise refs (owned pending objects with no producing task) ----

    def pg_ready_promise(self, pg_id_hex: str):
        """ObjectRef that resolves when the placement group reaches
        CREATED, driven by the GCS PG pubsub channel — NO probe task, no
        worker lease (the reference's ready() schedules
        bundle_reservation_check_func into the PG; here CREATED is only
        published after every bundle's 2PC commit, so the control-plane
        future validates the same thing at zero worker cost — the r4
        gate burned one worker SPAWN per PG on it)."""
        from ray_tpu_torch._private.api_internal import ObjectRef

        oid = ObjectID.for_put(self._current_task_id,
                               next(self._put_counter))

        async def arm_and_check():
            self.objects.setdefault(oid.hex(), _OwnedObject())
            if "PG" not in self._gcs_channels:
                self._gcs_channels.append("PG")
                await self.gcs.call("Subscribe", {"channels": ["PG"]})
            self._pg_ready_waiters.setdefault(pg_id_hex,
                                              []).append(oid.hex())
            # The subscription may postdate the CREATED publish: check
            # current state once AFTER arming (never misses: either the
            # publish arrives after the arm, or this read sees CREATED).
            resp = await self.gcs.call("GetPlacementGroup",
                                       {"pg_id": pg_id_hex})
            if resp.get("found") and resp.get("state") in ("CREATED",
                                                           "REMOVED"):
                self._settle_pg_waiters(pg_id_hex, resp["state"])

        self._run(arm_and_check())
        return ObjectRef(oid, self.address)

    def _settle_pg_waiters(self, pg_id_hex: str, state: str) -> None:
        """Resolve (CREATED) or fail (REMOVED) all ready()-promises of
        one placement group. Loop-side; idempotent."""
        for oid_hex in self._pg_ready_waiters.pop(pg_id_hex, []):
            o = self.objects.get(oid_hex)
            if o is None or o.state != OBJ_PENDING:
                continue
            if state == "CREATED":
                sobj = serialization.serialize(True)
                o.inline = (sobj.meta, sobj.to_bytes())
                o.size = len(o.inline[1])
                o.state = OBJ_READY
            else:
                err = serialization.serialize_exception(
                    exc.RayTpuError(
                        f"placement group {pg_id_hex[:8]} was removed "
                        "before it was scheduled"))
                o.error = (err.meta, err.to_bytes())
                o.state = OBJ_FAILED
            if o.ready_event:
                o.ready_event.set()

    async def _store_owned(self, oid: ObjectID, sobj: serialization.SerializedObject,
                           lineage_task: str | None = None):
        o = self.objects.setdefault(oid.hex(), _OwnedObject())
        o.size = sobj.total_size
        if sobj.total_size <= self.config.max_inline_object_size:
            o.inline = (sobj.meta, sobj.to_bytes())
        else:
            await self._write_to_store(oid, sobj)
            o.locations.add(self.node_id)
        self._set_lineage_task(o, lineage_task)
        o.state = OBJ_READY
        if o.ready_event:
            o.ready_event.set()

    async def _write_to_store(self, oid: ObjectID, sobj):
        # Several MakeRoom rounds: concurrent writers race for freshly
        # spilled space, so one retry is not enough under load
        # (reference: plasma's create_request_queue keeps create requests
        # queued until the spill pipeline frees room).
        attempts = 5
        for attempt in range(attempts):
            try:
                if not self.store.contains(oid):
                    meta = sobj.meta
                    buf = self.store.create(oid, len(meta) + sobj.total_size, len(meta))
                    buf[: len(meta)] = meta
                    sobj.write_to(buf[len(meta):])
                    self.store.seal(oid)
                return
            except ObjectStoreFullError:
                if attempt == attempts - 1:
                    raise
                # Ask the raylet to spill idle objects to disk, then retry
                # (reference: plasma create-retry via local_object_manager
                # spilling).
                try:
                    await self.raylet.call(
                        "MakeRoom",
                        {"needed": len(sobj.meta) + sobj.total_size},
                        timeout=self.config.rpc_call_timeout_s)
                except Exception:
                    raise ObjectStoreFullError(
                        f"store full and spill request failed "
                        f"({sobj.total_size} bytes)") from None
                if attempt:
                    await asyncio.sleep(0.05 * attempt)
            except Exception as e:
                if "already exists" not in str(e):
                    raise
                return

    def get(self, refs: list, timeout: float | None = None):
        """refs: list of (ObjectID, owner Address). Returns list of values.

        All fetches run concurrently on the IO loop (one threadsafe
        round-trip total; remote pulls overlap — reference: Get batches
        plasma + remote fetches, core_worker.cc:1353)."""
        # Fastpath workers buffer TaskDone results while executing a
        # batch; entering a (possibly blocking) get from the exec thread
        # must flush them first — a task may be waiting on a result this
        # very thread is holding back (the one deadlock case of
        # completion coalescing).
        fp_flush = getattr(self._exec_tls, "fp_flush", None)
        if fp_flush is not None:
            fp_flush()
        # About to (possibly) block on the exec thread: hand the
        # unstarted rest of the current push batch back to its owner —
        # a blocked task must not starve batch-mates (their subtrees
        # may be exactly what this get() waits on; nested fan-outs
        # deadlock otherwise). Cheap local-readiness probe avoids the
        # return when this get() resolves immediately.
        batch_return = getattr(self._exec_tls, "batch_return", None)
        if batch_return is not None and not self._refs_ready_local(refs):
            batch_return()
        async def fetch_all():
            # A worker blocked here still holds its lease's CPU — release
            # it for the duration so nested/fan-out tasks can run on this
            # node (reference: raylet blocked-worker accounting; without
            # this, width > num_cpus nested gets deadlock the pool).
            notify_blocked = (not self.is_driver and self.raylet is not None
                              and self._current_task_id is not None
                              and not self._refs_ready_local(refs))
            if notify_blocked:
                try:
                    await self.raylet.notify("WorkerBlocked",
                                             {"worker_id": self.worker_id})
                except Exception:
                    notify_blocked = False
            try:
                return await asyncio.gather(
                    *(self._fetch_object(oid, owner, timeout)
                      for oid, owner in refs), return_exceptions=True)
            finally:
                if notify_blocked:
                    try:
                        await self.raylet.notify(
                            "WorkerUnblocked", {"worker_id": self.worker_id})
                    except Exception:
                        pass

        fetched = self._run(fetch_all(),
                            None if timeout is None else timeout + 5)
        def release_unconsumed(upto: int):
            # Drop shm pins this call acquired but will not hand out —
            # every fetch from `upto` on, plus any consumed-but-unpinned
            # earlier ones are already handled. A retried get re-pins.
            # Pins are (store_client, oid): a same-host zero-copy read
            # pins the PEER node's arena, not ours.
            for (oid, _), f in zip(refs[upto:], fetched[upto:]):
                if not isinstance(f, BaseException) and f[2] is not None:
                    f[2][0].release(oid)

        first_err = next((f for f in fetched if isinstance(f, BaseException)),
                         None)
        if first_err is not None:
            release_unconsumed(0)
            raise first_err
        from ray_tpu_torch._private.api_internal import deser_context

        out = []
        for i, ((oid, _owner), (meta, data, pin)) in enumerate(
                zip(refs, fetched)):
            try:
                # Pre-registered nested oids: from our own container map
                # (we own the object) or the owner's status reply.
                oid_hex = oid.hex()
                prereg = ({n[0] for n in self._container_nested.get(oid_hex, [])}
                          | self._fetched_prereg.pop(oid_hex, set()))
                if pin is not None and _has_buffers(meta):
                    if _HAS_PEP688:
                        # Zero-copy payload: DONATE the store read-ref to
                        # a _ShmPin that every deserialized view keeps
                        # alive (plasma-buffer semantics — the pin dies
                        # with the last numpy view, so spilling/eviction
                        # can reclaim the slot; round 1 pinned for
                        # process lifetime, which deadlocks restores in a
                        # small arena).
                        shm_owner = _ShmPin(data, pin[0], oid)
                        pin = None
                        payload = memoryview(shm_owner)
                    else:
                        # No PEP 688 on this interpreter: copy out of shm
                        # and release the read-ref immediately — correct,
                        # just not zero-copy.
                        payload = bytes(data)
                        pin[0].release(oid)
                        pin = None
                    with deser_context(prereg) as dsink:
                        kind, value = serialization.deserialize(
                            meta, payload)
                else:
                    with deser_context(prereg) as dsink:
                        kind, value = serialization.deserialize(meta, data)
                    if pin is not None:
                        pin[0].release(oid)
                        pin = None
                self._register_new_borrows(dsink)
                if kind == serialization.KIND_DEVICE:
                    # Pinned payload: the stored value is only a
                    # descriptor; swap in the tensors (identity in
                    # process; IPC, NCCL or host transfer otherwise).
                    value = self._resolve_device_value(oid, _owner, value)
                if kind == serialization.KIND_EXCEPTION:
                    cause, tb = value
                    if isinstance(cause, exc.RayTpuError):
                        # System errors (actor death, object loss, OOM, ...)
                        # propagate as themselves, matching the reference
                        # where ray.get raises RayActorError etc. directly.
                        raise cause
                    raise exc.TaskError(cause, tb)
            except BaseException:
                if pin is not None:
                    pin[0].release(oid)
                release_unconsumed(i + 1)
                raise
            out.append(value)
        return out

    async def _fetch_object(self, oid: ObjectID, owner: Address,
                            timeout: float | None):
        """Returns (meta, data, pinned_oid|None)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        oid_hex = oid.hex()
        poll = 0.0005
        while True:
            o = self.objects.get(oid_hex)
            if o is not None and o.state == OBJ_FAILED:
                return o.error[0], o.error[1], None
            if o is not None and o.state == OBJ_READY and o.inline is not None:
                return o.inline[0], o.inline[1], None
            # Self-owned PENDING objects cannot be sealed in the store yet
            # (results register through _register_return first): skip the
            # shm index probe and go straight to the ready-event wait —
            # at burst-get rates the probe is measurable (~5 us/object).
            if not (o is not None and o.state == OBJ_PENDING
                    and (owner is None or owner.worker_id == self.worker_id)):
                got = self.store.get_buffer(oid)
                if got is not None:
                    return got[0], got[1], (self.store, oid)
            if o is not None and o.state == OBJ_READY and o.locations:
                same_host = await self._try_same_host_read(
                    oid, list(o.locations))
                if same_host is not None:
                    return same_host
                ok = await self._pull_to_local(oid_hex, list(o.locations),
                                               owner)
                if ok:
                    continue
                # All known copies lost. A drained node's copies were
                # pushed to peers — consult the GCS relocation
                # directory before paying for lineage reconstruction.
                if await self._try_relocated(oid_hex, o, owner):
                    continue
                recovered = await self._try_reconstruct(oid_hex)
                if not recovered:
                    raise exc.ObjectLostError(oid_hex)
                continue
            if o is None or o.state == OBJ_PENDING:
                if owner is not None and owner.worker_id != self.worker_id:
                    status = await self._poll_owner(oid, owner)
                    if status is not None:
                        return status
                    # else: became available in store / keep looping
                else:
                    # We own it and it is pending: wait for task completion.
                    if o is None:
                        raise exc.ObjectLostError(
                            oid_hex, f"object {oid_hex} is not owned by this "
                                     "process and no owner address is known")
                    if o.ready_event is None:
                        o.ready_event = asyncio.Event()
                    try:
                        wait_t = None if deadline is None else \
                            min(30.0, max(0.001, deadline - time.monotonic()))
                        await asyncio.wait_for(o.ready_event.wait(), wait_t)
                        # Event fired: re-check state immediately, no
                        # backoff sleep (hot path for burst completions).
                        continue
                    except asyncio.TimeoutError:
                        pass
            if deadline is not None and time.monotonic() > deadline:
                raise exc.GetTimeoutError(f"timed out getting {oid_hex}")
            await asyncio.sleep(poll)
            poll = min(poll * 2, 0.02)

    async def _poll_owner(self, oid: ObjectID, owner: Address):
        """Long-poll the owner for object status. Returns a full fetch
        triple (meta, data, pin|None) when the value resolved, or None
        if we should retry via the store."""
        try:
            conn = await self._owner_conn(owner)
            resp = await conn.call("GetObjectStatus",
                                   {"object_id": oid.hex(), "wait_s": 2.0,
                                    "requester": self.worker_id,
                                    "requester_addr": self.address.to_wire()},
                                   timeout=self.config.rpc_call_timeout_s)
        except (rpc.RpcError, OSError) as e:
            raise exc.OwnerDiedError(
                oid.hex(), f"owner of {oid.hex()} unreachable: {e}")
        if resp.get("nested"):
            # The owner pre-registered us as borrower of these embedded
            # refs; remember that for the deserialize in get().
            self._fetched_prereg[oid.hex()] = {n[0] for n in resp["nested"]}
        status = resp["status"]
        if status == "inline":
            return bytes(resp["meta"]), bytes(resp["data"]), None
        if status == "stored":
            same_host = await self._try_same_host_read(
                oid, resp["locations"])
            if same_host is not None:
                return same_host
            ok = await self._pull_to_local(oid.hex(), resp["locations"],
                                           owner)
            if not ok:
                # The owner's locations may predate a node drain: pull
                # from the relocated copy (and report ours back so the
                # owner's directory heals for later borrowers).
                await self._try_relocated(oid.hex(), None, owner)
            return None
        if status == "failed":
            return bytes(resp["meta"]), bytes(resp["data"]), None
        if status == "unknown":
            raise exc.ObjectLostError(oid.hex(),
                                      f"owner does not know object {oid.hex()}")
        return None  # pending

    async def _connect_cached(self, cache: dict, key, host, port,
                              name: str, kind: str) -> rpc.Connection:
        """Double-checked locked connect: one live connection per key.

        `kind` namespaces the lock table — owner and raylet cache keys
        are both (host, port)-shaped and must not share locks.
        """
        conn = cache.get(key)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault((kind, key), asyncio.Lock())
        async with lock:
            conn = cache.get(key)
            if conn is None or conn.closed:
                # dial, not a session: a dead owner/raylet conn IS the
                # liveness signal callers consume (borrow watches, lease
                # fallback paths) — transparent reconnection would mask it.
                conn = await rpc.dial(
                    host, port, name=name,
                    timeout=self.config.rpc_connect_timeout_s)
                cache[key] = conn
        return conn

    async def _owner_conn(self, owner: Address) -> rpc.Connection:
        return await self._connect_cached(
            self._owner_conns, owner.key(), owner.host, owner.port,
            name=f"w{self.worker_id[:6]}->owner", kind="owner")

    async def _try_same_host_read(self, oid: ObjectID, locations: list):
        """Zero-copy read from a co-hosted node's arena.

        One host is ONE shared-memory domain: when an object's holder
        runs on this host (fake multi-node clusters, multi-raylet
        hosts), the consumer maps the holder's arena and reads in place
        — no bytes move, exactly plasma's same-node property extended
        across raylets (reference: plasma zero-copy mmap reads; the
        cross-HOST path still chunks over the transfer plane). Returns
        a fetch triple with the pin against the PEER store, or None."""
        if self.raylet is None or not self.config.same_host_zero_copy:
            return None
        cache = getattr(self, "_peer_store_cache", None)
        if cache is None:
            cache = self._peer_store_cache = {}
        for nid in locations:
            if nid == self.node_id:
                continue  # local store probe already ran
            entry = cache.get(nid, ...)
            if entry is ...:
                try:
                    resp = await self.raylet.call(
                        "NodeStoreInfo", {"node_id": nid},
                        timeout=self.config.rpc_call_timeout_s)
                except Exception:
                    return None
                entry = None
                if resp.get("found") and resp.get("store_path") \
                        and resp.get("host") in (self.raylet_host,
                                                 "127.0.0.1"):
                    try:
                        if os.path.exists(resp["store_path"]):
                            entry = ObjectStoreClient(resp["store_path"])
                    except Exception:
                        entry = None
                cache[nid] = entry
            if entry is None:
                continue
            try:
                got = entry.get_buffer(oid)
            except Exception:
                cache.pop(nid, None)
                continue
            if got is not None:
                return got[0], got[1], (entry, oid)
        return None

    async def _pull_to_local(self, oid_hex: str, locations: list[str],
                             owner: "Address | None" = None) -> bool:
        resp = await self.raylet.call("PullObject", {
            "object_id": oid_hex, "locations": locations},
            timeout=self.config.rpc_call_timeout_s)
        ok = bool(resp.get("ok"))
        if ok and owner is not None and owner.worker_id != self.worker_id \
                and self.node_id not in locations:
            # Register this node as a NEW copy with the owner's location
            # directory: later pullers stripe across every node that has
            # the object, turning a broadcast from a star fan-out into a
            # chain (reference: ownership_based_object_directory tracks
            # every copy; push_manager chunked pushes + location-aware
            # pulls).
            self._spawn(self._report_copy(owner, oid_hex))
        return ok

    async def _report_copy(self, owner: Address, oid_hex: str) -> None:
        try:
            conn = await self._owner_conn(owner)
            await conn.notify("AddObjectLocation",
                              {"object_id": oid_hex,
                               "node_id": self.node_id})
        except Exception:
            pass  # best-effort: the hint only widens future pulls

    async def _try_relocated(self, oid_hex: str, o, owner=None) -> bool:
        """Recover a lost object from the GCS drained-node relocation
        directory (raylet._evacuate_objects pushed primary copies to
        peers before the node died). Returns True when the object is
        now in the local store — the cheap alternative to lineage
        reconstruction for every foreseen node death."""
        try:
            resp = await self.gcs.call(
                "GetObjectRelocations", {"object_ids": [oid_hex]},
                timeout=self.config.rpc_call_timeout_s)
        except Exception:
            return False
        nid = (resp.get("relocations") or {}).get(oid_hex)
        if not nid or (o is not None and nid in o.locations):
            return False  # unknown, or the failed pull already tried it
        if o is not None:
            o.locations.add(nid)
        ok = await self._pull_to_local(oid_hex, [nid], owner)
        if ok:
            self._num_relocation_recoveries += 1
            logger.info("recovered %s from drained-node relocation on %s",
                        oid_hex[:12], nid[:8])
        return ok

    async def _try_reconstruct(self, oid_hex: str) -> bool:
        """Lineage reconstruction (reference: object_recovery_manager.h:96
        ReconstructObject → resubmit the creating task)."""
        o = self.objects.get(oid_hex)
        if o is None or not o.lineage_task:
            return False
        spec = self.lineage.get(o.lineage_task)
        if spec is None:
            return False
        self._num_reconstructions += 1
        logger.warning("reconstructing %s via task %s", oid_hex[:12], spec.name)
        o.state = OBJ_PENDING
        o.locations.clear()
        if spec.task_id not in self.pending_tasks:
            # In-flight guard: concurrent gets on two lost yields of the
            # same generator must share ONE re-execution — a second
            # submission would overwrite the pending entry and strand
            # the first execution's remaining yields.
            pt = _PendingTask(spec, retries_left=1)
            if spec.num_returns == STREAMING_RETURNS:
                # Re-run the GENERATOR: every live yield re-registers
                # through the reconstructing path (no consumer
                # delivery) — the lost yield refreshes along the way.
                # Reference: generator lineage re-execution,
                # task_manager.cc.
                pt.stream_q = _queue.Queue()
                pt.reconstructing = True
            self.pending_tasks[spec.task_id] = pt
            self._enqueue_task(pt)
        # Wait for re-execution.
        if o.ready_event is None:
            o.ready_event = asyncio.Event()
        o.ready_event.clear()
        try:
            await asyncio.wait_for(o.ready_event.wait(),
                                   self.config.rpc_call_timeout_s)
        except asyncio.TimeoutError:
            return False
        return o.state == OBJ_READY

    def wait(self, refs: list, num_returns: int = 1, timeout: float | None = None):
        """Returns (ready, not_ready) index lists."""
        fp_flush = getattr(self._exec_tls, "fp_flush", None)
        if fp_flush is not None:  # see get(): flush buffered completions
            fp_flush()
        return self._run(self._wait_async(refs, num_returns, timeout))

    async def _wait_async(self, refs, num_returns, timeout):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list[int] = []
        while True:
            ready = []
            for i, (oid, owner) in enumerate(refs):
                if await self._is_ready(oid, owner):
                    ready.append(i)
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            await asyncio.sleep(0.005)
        not_ready = [i for i in range(len(refs)) if i not in ready]
        return ready, not_ready

    async def _is_ready(self, oid: ObjectID, owner: Address) -> bool:
        o = self.objects.get(oid.hex())
        if o is not None:
            return o.state in (OBJ_READY, OBJ_FAILED)
        if self.store.contains(oid):
            return True
        if owner is not None and owner.worker_id != self.worker_id:
            try:
                conn = await self._owner_conn(owner)
                resp = await conn.call("GetObjectStatus",
                                       {"object_id": oid.hex(), "wait_s": 0},
                                       timeout=5.0)
                return resp["status"] in ("inline", "stored", "failed")
            except Exception:
                return False
        return False

    async def _gcs_reattach(self, conn):
        """Session handshake run on every re-established GCS socket
        (BEFORE replayed calls resume): resubscribe, re-arm the job's
        session-teardown hook, and requery armed PG-ready waiters —
        a CREATED/REMOVED published during the gap is gone (PG promises
        have no polling fallback, unlike the actor path)."""
        if self._gcs_channels:
            await conn.call("Subscribe", {"channels": self._gcs_channels})
        if self.is_driver:
            # Re-arm the session-teardown hook (owns_cluster sessions
            # die with their driver connection).
            await conn.call("RegisterJob", {
                "job_id": self.job_id,
                "driver_address": self.address.to_wire(),
                "entrypoint": " ".join(os.sys.argv),
                "owns_cluster": self.owns_cluster,
            })
        logger.info("reconnected to GCS")
        for pg_id in list(self._pg_ready_waiters):
            try:
                resp = await conn.call(
                    "GetPlacementGroup", {"pg_id": pg_id})
            except Exception:
                continue
            if resp.get("found") and resp.get("state") in (
                    "CREATED", "REMOVED"):
                self._settle_pg_waiters(pg_id, resp["state"])

    def _on_gcs_session_failed(self):
        if not self._shutdown:
            logger.error(
                "gave up reconnecting to GCS after %.0fs; control-plane "
                "operations will fail until restart",
                self.config.gcs_reconnect_timeout_s)

    async def _raylet_reattach(self, conn):
        """Re-register with the local raylet after its session socket
        flapped (driver-only: pool workers run with grace 0 and exit)."""
        await conn.call("RegisterWorker", {
            "worker_id": self.worker_id, "host": self.address.host,
            "port": self.address.port, "fp_port": self.fp_port})
        logger.info("reconnected to raylet")

    # ---------- ref counting ----------

    def _post(self, fn, *args):
        """Run fn(*args) on the IO loop, batched: FIFO order is preserved
        (single buffer, single drain) while a burst of posts costs one
        call_soon_threadsafe wakeup."""
        with self._post_lock:
            self._post_buf.append((fn, args))
            wake = not self._post_scheduled
            if wake:
                self._post_scheduled = True
        if wake:
            try:
                self.loop.call_soon_threadsafe(self._drain_post_buf)
            except RuntimeError:
                pass

    def _drain_post_buf(self):
        with self._post_lock:
            buf, self._post_buf = self._post_buf, []
            self._post_scheduled = False
        for fn, args in buf:
            try:
                fn(*args)
            except Exception:
                logger.exception("posted op failed")

    def add_local_ref(self, oid_hex: str):
        """Thread-safe: counts mutate on the IO loop only. Post order is
        creation order per ref, so a later remove can never overtake its
        add in the loop's FIFO."""
        self._post(self._add_local_ref_impl, oid_hex)

    def _add_local_ref_impl(self, oid_hex: str):
        o = self.objects.get(oid_hex)
        if o is not None:
            o.local_refs += 1

    def pin_nested_ref(self, oid_hex: str):
        """Job-lifetime pin — LEGACY escape hatch, used only when a ref is
        pickled outside any runtime serialization context (user calls
        pickle.dumps themselves); in-runtime payloads go through the
        borrower protocol instead (collect_nested_refs)."""
        self.add_local_ref(oid_hex)

    # ---------- borrower protocol (reference: reference_count.cc) ----------

    def borrow_incr(self, oid_hex: str, owner, *, registered: bool = False):
        """Count one more local holder of a borrowed (non-owned) ref.
        Thread-safe (exec threads deserialize). registered=True when the
        owner already knows about this process (pre-registered by the
        sender), so no BorrowRef needs to be sent; release happens via
        the owner's WaitForRefRemoved long-poll."""
        with self._borrow_lock:
            b = self.borrowed.get(oid_hex)
            if b is None:
                b = self.borrowed[oid_hex] = _BorrowedRef(owner)
            b.count += 1
            if registered:
                b.registered = True

    def borrow_decr(self, oid_hex: str):
        """Drop one local holder; at zero, wake the owner's
        WaitForRefRemoved long-poll (if one is parked)."""
        with self._borrow_lock:
            b = self.borrowed.get(oid_hex)
            if b is None:
                return
            b.count -= 1
            if b.count > 0:
                return
            del self.borrowed[oid_hex]
            ev = b.removed_event
        if ev is not None and not self._shutdown:
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass

    def borrow_mark_registered(self, oid_hex: str) -> bool:
        """Mark a live borrow as owner-known; False if already released."""
        with self._borrow_lock:
            b = self.borrowed.get(oid_hex)
            if b is None:
                return False
            b.registered = True
            return True

    async def _handle_wait_for_ref_removed(self, conn, payload):
        """Borrower-side: park until our count for this object reaches
        zero (the owner holds this call open; our reply IS the release)."""
        require_fields(payload, "object_id",
                       method="_handle_wait_for_ref_removed")
        oid_hex = payload["object_id"]
        with self._borrow_lock:
            b = self.borrowed.get(oid_hex)
            if b is None or b.count <= 0:
                return {}
            if b.removed_event is None:
                b.removed_event = asyncio.Event()
            ev = b.removed_event
        await ev.wait()
        return {}

    def _add_borrower(self, oid_hex: str, borrower_id: str, borrower_addr):
        """Owner-side: record a borrower and start (once per live
        registration) the WaitForRefRemoved watch that will eventually
        remove it. Re-registration while a watch exists bumps the watch
        generation so a stale watch cannot discard the fresh borrow."""
        o = self.objects.get(oid_hex)
        if o is None or borrower_id == self.worker_id:
            return
        o.borrowers.add(borrower_id)
        key = (oid_hex, borrower_id)
        if key in self._borrow_watches:
            self._borrow_watches[key] += 1
        else:
            self._borrow_watches[key] = 1
            self._spawn(self._watch_borrower(oid_hex, borrower_id,
                                             borrower_addr))

    async def _watch_borrower(self, oid_hex: str, borrower_id: str,
                              borrower_addr):
        """Long-poll the borrower; when it answers (count hit zero) or its
        process dies (connection error), drop it from the borrowers set.
        The initial grace period lets an eagerly pre-registered borrower
        actually record its borrow before we ask. A generation bump
        (re-registration racing our completed wait) restarts the wait
        instead of discarding the live borrow."""
        key = (oid_hex, borrower_id)
        seen_gen = self._borrow_watches.get(key, 1)
        transient_failures = 0
        try:
            while not self._shutdown:
                await asyncio.sleep(5.0)
                try:
                    conn = await self._owner_conn(
                        Address.from_wire(borrower_addr))
                    await conn.call("WaitForRefRemoved",
                                    {"object_id": oid_hex}, timeout=None)
                except (rpc.ConnectionLost, ConnectionRefusedError,
                        ConnectionResetError):
                    break  # borrower process confirmed gone
                except (rpc.RpcError, OSError, asyncio.TimeoutError):
                    # Transient (handler error, busy peer): a live
                    # borrower must NOT be discarded — its object would
                    # be freed under it. Retry a few times first.
                    transient_failures += 1
                    if transient_failures >= 5:
                        break
                    continue
                transient_failures = 0
                gen = self._borrow_watches.get(key, seen_gen)
                if gen == seen_gen:
                    break  # clean release, no re-registration raced us
                seen_gen = gen  # re-registered: wait for the new borrow
        finally:
            self._borrow_watches.pop(key, None)
            o = self.objects.get(oid_hex)
            if o is not None:
                o.borrowers.discard(borrower_id)
                if o.local_refs <= 0 and o.submitted_refs <= 0 \
                        and not o.borrowers:
                    self._free_object(oid_hex)

    def _register_new_borrows(self, dsink: list):
        """Immediately register any rebuilt borrow the owner doesn't know
        about yet (payloads fetched from the shm store have no
        pre-registration channel). Tiny race vs a concurrent final
        release — crash-free: a late BorrowRef on a freed object is a
        no-op and the borrower then observes ObjectLostError, the
        reference's behavior for out-of-band ref leaks."""
        for oid_hex, owner in dsink:
            with self._borrow_lock:
                b = self.borrowed.get(oid_hex)
                if b is None or b.registered:
                    continue
                b.registered = True
            if owner is not None:
                self._spawn(self._send_borrow_ref(oid_hex, owner))

    async def _send_borrow_ref(self, oid_hex: str, owner):
        try:
            conn = await self._owner_conn(owner)
            await conn.notify("BorrowRef",
                              {"object_id": oid_hex,
                               "borrower": self.worker_id,
                               "borrower_addr": self.address.to_wire()})
        except Exception:
            pass

    async def _forward_borrow(self, oid_hex: str, owner_wire,
                              borrower_id: str, borrower_addr):
        """Register a borrower (id + address) with the object's owner on
        our ordered owner connection — sent BEFORE we release our own hold
        on the same connection, which is what makes the handoff
        race-free. The owner starts a WaitForRefRemoved watch to the
        borrower's address."""
        if owner_wire is None or borrower_addr is None:
            return
        owner = Address.from_wire(owner_wire)
        if owner.worker_id == self.worker_id:
            self._add_borrower(oid_hex, borrower_id, borrower_addr)
            return
        # Retry transient failures with backoff: the executing worker has
        # already marked this borrow registered (it will never send its
        # own BorrowRef), so dropping the forward on a 10s timeout
        # against a live-but-busy owner would let the owner free an
        # object a live process still references. Only confirmed owner
        # death (connection lost/refused) aborts — then the object is
        # lost regardless of the borrow.
        for delay in (0.5, 1.0, 2.0, 4.0, None):
            try:
                conn = await self._owner_conn(owner)
                # A CALL, not a notify: the ack guarantees the owner
                # recorded the new borrower before our own hold (whose
                # release answers a WaitForRefRemoved on a DIFFERENT
                # connection) can drop — cross-connection ordering that a
                # notify cannot provide.
                await conn.call("BorrowRef", {"object_id": oid_hex,
                                              "borrower": borrower_id,
                                              "borrower_addr": borrower_addr},
                                timeout=10)
                return
            except (rpc.ConnectionLost, ConnectionRefusedError):
                return  # owner process gone: object is lost anyway
            except Exception:
                if delay is None or self._shutdown:
                    logger.warning(
                        "forwarding borrow of %s to its owner kept "
                        "failing; the borrower at %s may observe "
                        "ObjectLostError", oid_hex[:8], borrower_addr)
                    return
                await asyncio.sleep(delay)

    async def _handle_borrow_ref(self, conn, payload):
        require_fields(payload, "borrower", "object_id",
                       method="_handle_borrow_ref")
        self._add_borrower(payload["object_id"], payload["borrower"],
                           payload.get("borrower_addr"))

    def _track_container(self, container_hex: str, nested: list):
        """A stored payload (put value / task return) embeds `nested`
        refs: hold each until the container object is freed. Owned refs
        take a local count; borrowed refs take a borrow count and are
        registered with their owner if not already (duplicate BorrowRefs
        are idempotent — borrowers is a set)."""
        if not nested:
            return
        self._container_nested.setdefault(container_hex, []).extend(nested)
        new_borrows = []
        for oid_hex, owner_wire in nested:
            o = self.objects.get(oid_hex)
            if o is not None:
                o.local_refs += 1
            else:
                owner = Address.from_wire(owner_wire) if owner_wire else None
                self.borrow_incr(oid_hex, owner)
                new_borrows.append((oid_hex, owner))
        self._register_new_borrows(new_borrows)

    def _release_container(self, container_hex: str):
        for oid_hex, _owner in self._container_nested.pop(container_hex, []):
            o = self.objects.get(oid_hex)
            if o is not None:
                self._remove_local_ref_impl(oid_hex)
            else:
                self.borrow_decr(oid_hex)

    def bump_submitted_ref(self, oid_hex: str):
        """Thread-safe submitted_refs increment (submissions may originate
        on concurrent actor exec threads)."""
        self._post(self._bump_submitted_ref_impl, oid_hex)

    def _bump_submitted_ref_impl(self, oid_hex: str):
        o = self.objects.get(oid_hex)
        if o is not None:
            o.submitted_refs += 1

    def remove_local_ref(self, oid_hex: str):
        if self._shutdown:
            return
        self._post(self._remove_local_ref_impl, oid_hex)

    def _remove_local_ref_impl(self, oid_hex: str):
        o = self.objects.get(oid_hex)
        if o is None:
            return
        o.local_refs -= 1
        if o.local_refs <= 0 and o.submitted_refs <= 0 and not o.borrowers:
            self._free_object(oid_hex)

    def _free_object(self, oid_hex: str):
        o = self.objects.pop(oid_hex, None)
        if o is None:
            return
        if o.locations:
            self._spawn(self.raylet.call("FreeObjects", {"object_ids": [oid_hex]}))
        if o.lineage_task:
            live = self._lineage_live.get(o.lineage_task, 0) - 1
            if live > 0:
                self._lineage_live[o.lineage_task] = live
            else:
                self._lineage_live.pop(o.lineage_task, None)
                if self.lineage.pop(o.lineage_task, None) is not None:
                    # Subtract exactly what was added (the counter must
                    # not drift, or the cap stops meaning anything).
                    self._lineage_bytes -= self._lineage_est.pop(
                        o.lineage_task, 0)
        # Refs embedded in this container's payload lose their hold.
        self._release_container(oid_hex)
        if o.device:
            # Last reference gone: the pinned tensors on the producing
            # worker are released too.
            self._spawn(self._release_device_object(o.device))

    # ---------- runtime env provisioning ----------

    _renv_cache: dict | None = None

    def ensure_runtime_env(self, env: dict, job_id: str = "") -> dict:
        """Materialize provisioned env parts via this node's raylet.
        Cached per (job, env): a pooled worker reused by a NEW job must
        re-register that job's reference with the raylet, or job-finish GC
        could delete an env dir the new job still uses."""
        if self._renv_cache is None:
            self._renv_cache = {}
        job_id = job_id or self.job_id
        fields = {k: env[k] for k in ("pip", "working_dir", "py_modules")
                  if k in env}
        key = (job_id, repr(sorted(fields.items(), key=lambda kv: kv[0])))
        ctx = self._renv_cache.get(key)
        if ctx is None:
            # Generous timeout: first pip-env creation may download/build.
            ctx = self._run(self.raylet.call(
                "EnsureRuntimeEnv", {"env": fields, "job_id": job_id},
                timeout=650))
            self._renv_cache[key] = ctx
        return ctx

    # ---------- function table ----------

    def register_function(self, fn) -> str:
        blob = serialization.dumps_func(fn)
        key = self.job_id + ":" + hashlib.sha1(blob).hexdigest()
        if key not in self._fn_cache:
            self._fn_cache[key] = fn
            self._run(self.gcs.call("KVPut", {
                "ns": "fn", "key": key.encode(), "value": blob, "overwrite": False}))
        return key

    async def _fetch_function(self, key: str):
        if key in self._fn_cache:
            return self._fn_cache[key]
        deadline = time.monotonic() + self.config.rpc_call_timeout_s
        while True:
            resp = await self.gcs.call("KVGet", {"ns": "fn", "key": key.encode()})
            if resp["value"] is not None:
                fn = serialization.loads_func(resp["value"])
                self._fn_cache[key] = fn
                return fn
            if time.monotonic() > deadline:
                raise exc.RayTpuError(f"function {key} not found in GCS")
            await asyncio.sleep(0.05)

    # ---------- task submission (owner side) ----------

    def next_task_id(self) -> TaskID:
        # Random per-process prefix + counter: unique across all
        # submitters (incl. nested tasks in other workers) without a
        # hash per submission. Return ObjectIDs still embed the TaskID
        # (ids.for_task_return), which is all lineage recovery needs.
        return TaskID(self._task_id_prefix
                      + next(self._task_counter).to_bytes(8, "big"))

    def serialize_args(self, args: tuple, kwargs: dict):
        """Build wire args; returns (wire_args, kwargs_keys, dep_ids,
        nested_refs). nested_refs are refs pickled INSIDE value args —
        refcounted like top-level args via the borrower protocol
        (reference: reference_count.cc collects refs during arg
        serialization)."""
        from ray_tpu_torch._private.api_internal import (  # cycle-free import
            ObjectRef, collect_nested_refs)

        if not args and not kwargs:  # hot path: trivial no-arg tasks
            return [], [], [], []
        wire = []
        deps = []
        nested: list = []
        items = list(args) + list(kwargs.values())
        max_inline = self.config.max_inline_object_size
        for a in items:
            # Exact builtin scalars/strings cannot contain ObjectRefs or
            # out-of-band buffers: skip the nested-ref collector and the
            # SerializedObject machinery (the dominant per-arg cost at
            # trivial-task throughput). Size-gate str/bytes CHEAPLY first
            # so an over-inline-size value is not pickled twice (here and
            # again in the promotion path).
            if type(a) in _PRIMITIVE_TYPES and not (
                    type(a) in (str, bytes) and len(a) >= max_inline):
                meta, data = serialization.serialize_primitive(a)
                if len(data) <= max_inline:
                    wire.append(["v", meta, data])
                    continue
            if isinstance(a, ObjectRef):
                wire.append(["r", a.id.hex(), a.owner.to_wire() if a.owner else None])
                deps.append(a.id.hex())
                self._hold_for_submission(
                    a.id.hex(), a.owner.to_wire() if a.owner else None)
            else:
                with collect_nested_refs() as sink:
                    sobj = serialization.serialize(a)
                if sobj.total_size > self.config.max_inline_object_size:
                    # Large arg: promote to a put object passed by reference
                    # (reference: same promotion in submit path). The put
                    # container now holds the nested refs (tracked by
                    # put()'s own collector), so drop this sink.
                    oid, owner = self.put(a)
                    wire.append(["r", oid.hex(), owner.to_wire()])
                    deps.append(oid.hex())
                    self._hold_for_submission(oid.hex(), owner.to_wire())
                else:
                    wire.append(["v", sobj.meta, sobj.to_bytes()])
                    for oid_hex, owner_wire in sink:
                        nested.append((oid_hex, owner_wire))
                        self._hold_for_submission(oid_hex, owner_wire)
        return wire, list(kwargs.keys()), deps, nested

    def _hold_for_submission(self, oid_hex: str, owner_wire):
        """Keep a ref alive until its task completes: owned refs bump
        submitted_refs; borrowed refs bump the local borrow count (both
        released in _complete_task / _release_submitted_refs)."""
        if oid_hex in self.objects:
            self.bump_submitted_ref(oid_hex)
        else:
            owner = Address.from_wire(owner_wire) if owner_wire else None
            self.borrow_incr(oid_hex, owner)

    def _prepare_task(self, spec: TaskSpec, nested_args: list | None,
                      task_id: TaskID | None = None) -> tuple:
        n_returns = (0 if spec.num_returns == STREAMING_RETURNS
                     else spec.num_returns)
        # Hot path: build return ids by concatenation off the TaskID the
        # caller already holds (ObjectID = TaskID + BE index,
        # ids.for_task_return) instead of a hex→bytes→hex round trip.
        if task_id is None:
            task_id = TaskID.from_hex(spec.task_id)
        tb = task_id.binary()
        returns = [ObjectID._wrap(tb + (i + 1).to_bytes(4, "big"))
                   for i in range(n_returns)]
        pt = _PendingTask(spec, retries_left=spec.max_retries,
                          nested_args=nested_args)
        if spec.num_returns == STREAMING_RETURNS:
            pt.stream_q = _queue.Queue()
            self._stream_queues[spec.task_id] = pt.stream_q
        pt.return_hexes = [oid.hex() for oid in returns]
        if n_returns:
            # One live-count store per TASK (submission hot path), not a
            # read-modify-write per return object. Safe to bypass
            # _set_lineage_task here: a return ObjectID embeds THIS
            # task's id, so a pre-existing entry (early borrow, retry)
            # can only carry this same task or None — never a different
            # task whose count would need decrementing.
            self._lineage_live[spec.task_id] = n_returns
        for oid_hex in pt.return_hexes:
            o = self.objects.setdefault(oid_hex, _OwnedObject())
            o.lineage_task = spec.task_id
        self.pending_tasks[spec.task_id] = pt
        self._record_task_event(spec.task_id, spec.name, "SUBMITTED",
                                ts=pt.submitted_ts)
        return pt, returns

    def _enqueue_prepared(self, pt: _PendingTask) -> None:
        with self._submit_lock:
            self._submit_buf.append(pt)
            wake = not self._submit_scheduled
            if wake:
                self._submit_scheduled = True
        if wake:
            self.loop.call_soon_threadsafe(self._drain_submit_buf)

    def submit_task(self, spec: TaskSpec, nested_args: list | None = None,
                    task_id: TaskID | None = None) -> list[ObjectID]:
        """Submit; returns the return-object IDs (owner = this worker)."""
        pt, returns = self._prepare_task(spec, nested_args, task_id)
        self._enqueue_prepared(pt)
        return returns

    def submit_streaming_task(self, spec: TaskSpec,
                              nested_args: list | None = None,
                              task_id: TaskID | None = None):
        """Submit a num_returns="streaming" task; returns its yield
        queue. The queue is captured BEFORE the submission is enqueued —
        a fast task could complete (popping pending_tasks) before the
        caller could look the queue up afterwards."""
        pt, _ = self._prepare_task(spec, nested_args, task_id)
        q = pt.stream_q
        self._enqueue_prepared(pt)
        return q

    def _drain_submit_buf(self):
        """Loop-side: queue every buffered submission, one pump per shape.
        A burst of N submissions costs one loop wakeup + one pump, not N."""
        with self._submit_lock:
            buf, self._submit_buf = self._submit_buf, []
            self._submit_scheduled = False
        shapes: dict[str, TaskSpec] = {}
        for pt in buf:
            shape = (_shape_key(pt.spec.resources) + repr(pt.spec.strategy)
                     + pt.spec.placement_group)
            if pt.spec.strategy and pt.spec.strategy[0] == "spread":
                self._spread_shapes.add(shape)
            self._queues[shape].append(pt.spec.task_id)
            shapes.setdefault(shape, pt.spec)
        for shape, spec in shapes.items():
            self._spawn(self._pump_queue(shape, spec))

    def _enqueue_task(self, pt: _PendingTask):
        shape = _shape_key(pt.spec.resources) + repr(pt.spec.strategy) + pt.spec.placement_group
        if pt.spec.strategy and pt.spec.strategy[0] == "spread":
            self._spread_shapes.add(shape)
        q = self._queues[shape]
        # Keep the queue sorted by submission seq. Fresh submissions have
        # the highest seq so the scan exits immediately (append); only a
        # retry walks back past younger entries, restoring
        # producer-before-consumer order within a future push batch.
        i = len(q)
        while i > 0:
            prev = self.pending_tasks.get(q[i - 1])
            if prev is None or prev.seq <= pt.seq:
                break
            i -= 1
        q.insert(i, pt.spec.task_id)
        self._spawn(self._pump_queue(shape, pt.spec))

    _PUSH_BATCH_MAX = 256

    def _pop_batch(self, shape: str) -> list:
        """Pop a fair share of the queue for one worker slot.

        Batch size balances RPC amortization (big batches: a burst of
        trivial tasks costs ~2 frames per _PUSH_BATCH_MAX tasks, the key
        to the reference's 10k+ tasks/s floor, ray_perf.py:93) against
        parallelism (cap at the queue's fair share per expected worker so
        one slot can't swallow a burst that n leased workers could run
        in parallel).
        """
        q = self._queues[shape]
        if not q:
            return []
        if shape in self._spread_shapes:
            # SPREAD: one task per dispatch — a batch would pin work to
            # the first leases granted and leave late-joining nodes idle
            # (VERDICT r3: 128 spread tasks over 32 nodes used 23).
            take = 1
        else:
            # Optimism about in-flight leases is capped: counting all of
            # them (a burst spawns up to 32) would shrink batches to ~1
            # task and forfeit the RPC amortization that IS the
            # throughput win.
            n_workers = max(1, len(self._leases[shape])
                            + min(self._lease_requests_in_flight[shape], 4))
            take = min(self._PUSH_BATCH_MAX, max(1, -(-len(q) // n_workers)))
        pts = []
        while q and len(pts) < take:
            pt = self.pending_tasks.get(q.popleft())
            if pt is not None:
                pts.append(pt)
        return pts

    async def _pump_queue(self, shape: str, template_spec: TaskSpec):
        """Ensure enough leased workers for the queue; dispatch tasks.
        Lease pipelining mirrors direct_task_transport.cc
        RequestNewWorkerIfNeeded:346 / OnWorkerIdle:191."""
        q = self._queues[shape]
        slots = self._leases[shape]
        # Dispatch to idle slots first.
        for s in slots:
            if not q:
                return
            if not s.busy and not s.conn.closed:
                pts = self._pop_batch(shape)
                if pts:
                    s.busy = True
                    supervised_task(self._push_tasks(s, pts, shape))
        # Outstanding lease requests are capped in TOTAL (not per pump
        # call): extra requests just queue at the raylet and churn its
        # pending-lease timers without adding parallelism.
        in_flight = self._lease_requests_in_flight[shape]
        max_new = min(len(q), 32) - in_flight
        for _ in range(max(0, max_new)):
            self._lease_requests_in_flight[shape] += 1
            supervised_task(self._request_lease(shape, template_spec))

    async def _request_lease(self, shape: str, spec: TaskSpec):
        lease_requested_ts = time.time()
        try:
            raylet_conn = self.raylet
            _hop = 0
            _spawn_failures = 0
            while True:
                _hop += 1
                if _hop > 8:
                    # The hop budget bounds one CHAIN of spillback
                    # redirects, not the lease request's lifetime. A
                    # chain longer than the cluster diameter means the
                    # view is churning: start over from the local raylet.
                    # Exiting here instead would silently drop the lease
                    # request — with the owner itself blocked in ray.get
                    # nothing ever re-pumps its queue, wedging the whole
                    # subtree (the r4 nested-fanout deadlock #3; the
                    # retry path below used to burn hops the same way).
                    if not self._queues[shape]:
                        return
                    await asyncio.sleep(0.5)
                    raylet_conn = self.raylet
                    _hop = 1
                try:
                    resp = await raylet_conn.call("RequestWorkerLease", {
                        "resources": spec.resources,
                        "strategy": spec.strategy,
                        "placement_group": spec.placement_group,
                        "pg_bundle_index": spec.pg_bundle_index,
                        "hops": _hop - 1,
                        # Fair-share lane: the raylet round-robins queued
                        # leases across job ids under contention.
                        "job_id": self.job_id,
                    }, timeout=self.config.worker_lease_timeout_s + 10)
                except (rpc.RpcError, asyncio.TimeoutError, OSError):
                    # The raylet we were negotiating with died (node failure
                    # mid-lease). Fall back to the local raylet and retry
                    # while there is still queued work.
                    if not self._queues[shape]:
                        return
                    await asyncio.sleep(0.5)
                    raylet_conn = self.raylet
                    _hop = 0
                    continue
                if resp.get("granted"):
                    try:
                        # Short deadline: this connect doubles as the
                        # liveness probe for the leased worker.
                        conn = await rpc.dial(
                            resp["worker_host"], resp["worker_port"],
                            name=f"owner->{resp['worker_id'][:6]}",
                            timeout=2.0)
                    except (OSError, asyncio.TimeoutError):
                        # Leased worker already gone; release and retry.
                        try:
                            await raylet_conn.call(
                                "ReturnWorker",
                                {"lease_id": resp["lease_id"], "kill": True})
                        except Exception:
                            pass
                        raylet_conn = self.raylet
                        _hop = 0
                        continue
                    slot = _LeaseSlot(
                        conn, resp["lease_id"], resp["worker_id"],
                        resp["node_id"], raylet_conn,
                        worker_addr=[resp["worker_host"],
                                     resp["worker_port"],
                                     resp["worker_id"], resp["node_id"]],
                        lease_requested_ts=lease_requested_ts,
                        lease_granted_ts=time.time())
                    slot.lease_timing = resp.get("lease_timing")
                    conn.handlers["TaskDone"] = functools.partial(
                        self._handle_task_done, slot, shape)
                    conn.handlers["TasksReturned"] = functools.partial(
                        self._handle_tasks_returned, slot, shape)
                    conn.handlers["TaskYield"] = self._handle_task_yield
                    conn.on_close(functools.partial(
                        self._on_slot_conn_closed, slot, shape))
                    fp_port = resp.get("worker_fp_port") or 0
                    if fp_port and self._fp is not None:
                        pump = self._ensure_sub_pump()
                        if pump is not None:
                            try:
                                # connect() blocks in the kernel; a
                                # remote host that died post-grant would
                                # stall the whole IO loop through SYN
                                # retransmits — keep it off-loop.
                                slot.fp_id = await asyncio.get_running_loop(
                                    ).run_in_executor(
                                        None, pump.connect,
                                        resp["worker_host"], fp_port)
                                self._fp_slots[slot.fp_id] = (slot, shape)
                            except OSError:
                                slot.fp_id = None  # asyncio fallback
                    self._leases[shape].append(slot)
                    await self._on_slot_idle(slot, shape)
                    return
                if resp.get("spillback"):
                    sb = resp["spillback"]
                    try:
                        raylet_conn = await self._raylet_conn(
                            sb["host"], sb["port"])
                    except (rpc.RpcError, asyncio.TimeoutError, OSError):
                        # The spillback target died between grant and
                        # connect (node failure). Letting this escape
                        # kills the lease-request task silently and the
                        # queue never re-pumps (the flaky
                        # test_task_retry_after_node_death 120s wedge):
                        # restart from the local raylet's current view.
                        if not self._queues[shape]:
                            return
                        await asyncio.sleep(0.2)
                        raylet_conn = self.raylet
                        _hop = 0
                    continue
                if resp.get("draining"):
                    # Drain rejection: the node is evacuating and no
                    # peer fit its spillback view. Retry-elsewhere, not
                    # a permanent failure — re-resolve from the LOCAL
                    # raylet (whose next heartbeat view excludes the
                    # draining node); a task that raced the drain flag
                    # must never be failed infeasible.
                    if not self._queues[shape]:
                        return
                    await asyncio.sleep(0.2)
                    raylet_conn = self.raylet
                    _hop = 0
                    continue
                if resp.get("retry"):
                    # Raylet-side lease timeout under contention: retry
                    # for as long as there is queued work. Retries must
                    # not consume spillback hops (see the _hop > 8 note —
                    # 8 silent 30s retries was deadlock #3's signature).
                    # Not silent: a PERSISTENT cause (e.g. worker spawn
                    # failing outright) would loop here forever, so
                    # surface it at a bounded rate.
                    if not self._queues[shape]:
                        return
                    if resp.get("spawn_failure"):
                        # Spawn failures are budgeted: under load they
                        # are transient (spawn timeout), but a broken
                        # worker env (entrypoint import error, ulimit)
                        # fails every attempt — fail the queue with the
                        # cause instead of hanging the job forever.
                        _spawn_failures += 1
                        if _spawn_failures >= 5:
                            self._fail_queued_infeasible(
                                shape, resp.get("error",
                                                "worker startup failed"))
                            return
                    else:
                        _spawn_failures = 0
                    now = time.monotonic()
                    if now - self._lease_retry_logged > 30.0:
                        self._lease_retry_logged = now
                        logger.warning(
                            "lease request retrying (%s); %d task(s) still "
                            "queued", resp.get("error", "lease timeout"),
                            len(self._queues[shape]))
                    await asyncio.sleep(0.2)
                    _hop = 0
                    continue
                if resp.get("infeasible"):
                    # Reference semantics: infeasible tasks stay PENDING —
                    # the autoscaler (or a test adding a node) may satisfy
                    # them later. Back off and retry from the local raylet.
                    if not self._queues[shape]:
                        return
                    logger.warning("task demand currently infeasible: %s; "
                                   "waiting for cluster resources",
                                   resp.get("error"))
                    await asyncio.sleep(1.0)
                    raylet_conn = self.raylet
                    _hop = 0
                    continue
                logger.debug("lease failed: %s", resp.get("error"))
                self._fail_queued_infeasible(shape, resp.get("error", "lease failed"))
                return
        finally:
            self._lease_requests_in_flight[shape] -= 1

    def _fail_queued_infeasible(self, shape: str, reason: str):
        q = self._queues[shape]
        while q:
            task_id = q.popleft()
            pt = self.pending_tasks.pop(task_id, None)
            if pt is not None:
                err = serialization.serialize_exception(
                    exc.RayTpuError(f"task unschedulable: {reason}"))
                self._complete_task_error(pt, err)

    async def _raylet_conn(self, host, port):
        return await self._connect_cached(
            self._raylet_conns, (host, port), host, port,
            name="owner->raylet", kind="raylet")

    # ---------- fastpath submitter plane ----------

    def _ensure_sub_pump(self):
        """Lazily create the outbound fastpath pump + hook its recv
        eventfd into the IO loop (loop thread only)."""
        if self._fp_sub_pump is None and self._fp is not None:
            pump = self._fp.FastPump()
            pump.arm_eventfd(True)
            self.loop.add_reader(pump.eventfd, self._fp_drain_ready)
            self._fp_sub_pump = pump
        return self._fp_sub_pump

    def _fp_drain_ready(self):
        """recv eventfd became readable: batch-drain native events and
        process them in ONE loop task (ordering: the pump FIFO preserves
        per-socket frame order; processing is sequential)."""
        try:
            os.read(self._fp_sub_pump.eventfd, 8)
        except (BlockingIOError, OSError, ValueError, AttributeError):
            pass
        # Drain to EMPTY: the eventfd was just zeroed, so any event left
        # queued here would strand until unrelated future traffic.
        while True:
            evs = self._fp_sub_pump.drain(4096)
            if not evs:
                break
            self._fp_backlog.extend(evs)
        if not self._fp_processing and self._fp_backlog:
            self._fp_processing = True
            supervised_task(self._fp_process())

    async def _fp_process(self):
        from ray_tpu_torch._private.native_fastpath import EV_CLOSE, EV_FRAME
        while True:
            if not self._fp_backlog:
                # No await between this check and the flag clear: the
                # loop is single-threaded, so no event can be stranded.
                self._fp_processing = False
                return
            batch, self._fp_backlog = self._fp_backlog, []
            for kind, cid, payload in batch:
                try:
                    if kind == EV_FRAME:
                        _mt, _seq, method, pl = rpc.unpack(payload)
                        if method == "TaskDone":
                            entry = self._fp_slots.get(cid)
                            if entry is not None:
                                await self._handle_task_done(
                                    entry[0], entry[1], None, pl)
                        elif method == "TasksReturned":
                            entry = self._fp_slots.get(cid)
                            if entry is not None:
                                await self._handle_tasks_returned(
                                    entry[0], entry[1], None, pl)
                        elif method == "TaskYield":
                            await self._handle_task_yield(None, pl)
                    elif kind == EV_CLOSE:
                        entry = self._fp_slots.pop(cid, None)
                        if entry is not None:
                            slot = entry[0]
                            slot.fp_id = None
                            self._on_slot_conn_closed(slot, entry[1])
                            # Usually the worker died and the asyncio conn
                            # is closing too; if only the fp socket died,
                            # the lease must still be handed back and the
                            # (possibly mid-batch) worker retired — its
                            # tasks were just re-enqueued elsewhere.
                            if not slot.conn.closed:
                                try:
                                    await slot.raylet.call(
                                        "ReturnWorker",
                                        {"lease_id": slot.lease_id,
                                         "kill": True}, timeout=5)
                                except Exception:
                                    pass
                                await slot.conn.close()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("fastpath event handling failed")

    def _drop_slot_fp(self, slot) -> None:
        if slot.fp_id is not None:
            self._fp_slots.pop(slot.fp_id, None)
            if self._fp_sub_pump is not None:
                self._fp_sub_pump.close_conn(slot.fp_id)
            slot.fp_id = None

    async def _on_slot_idle(self, slot: _LeaseSlot, shape: str):
        if slot.outstanding or slot.conn.closed:
            # A concurrent TaskDone handler already refilled this slot
            # (or the conn died and close-handling owns the cleanup):
            # this idle notification is stale.
            return
        q = self._queues[shape]
        if q and shape in self._spread_shapes and slot.pushed_any:
            # SPREAD places EACH task, not per lease: reusing this slot
            # would lock the queue onto the first-granted nodes (and a
            # node that joined after the initial ramp would never see
            # work). After the slot has run its task, return the lease
            # and re-request against the CURRENT cluster view
            # (reference: spread_scheduling_policy.cc round-robins per
            # task). A FRESH slot (pushed_any False) takes a task below
            # first — recycling it unused would grant/return forever.
            first = self.pending_tasks.get(q[0])
            if slot in self._leases[shape]:
                self._leases[shape].remove(slot)
            try:
                await slot.raylet.call("ReturnWorker",
                                       {"lease_id": slot.lease_id})
            except Exception:
                pass
            self._drop_slot_fp(slot)
            await slot.conn.close()
            if first is not None:
                await self._pump_queue(shape, first.spec)
            return
        if q:
            pts = self._pop_batch(shape)
            if pts:
                slot.busy = True
                await self._push_tasks(slot, pts, shape)
                return
        # No work: return lease after a grace period (lease reuse window).
        slot.busy = False
        slot.idle_since = time.monotonic()
        await asyncio.sleep(self.config.idle_worker_keep_s)
        if not slot.busy and not slot.outstanding \
                and slot in self._leases[shape] and not q:
            self._leases[shape].remove(slot)
            try:
                await slot.raylet.call("ReturnWorker", {"lease_id": slot.lease_id})
            except Exception:
                pass
            self._drop_slot_fp(slot)
            await slot.conn.close()

    async def _push_tasks(self, slot: _LeaseSlot, pts: list, shape: str):
        """Push a batch of tasks to a leased worker in ONE notify frame.

        Completions STREAM back as TaskDone notifies (opportunistically
        coalesced worker-side) — required for correctness, not just
        latency: tasks later in a batch may depend on results of earlier
        ones (chain pattern), so a single end-of-batch reply would
        deadlock the worker against its own unsent results.

        No per-push deadline: user tasks may legitimately run for hours;
        worker death surfaces as a closed connection (the raylet SIGKILLs
        and we see EOF), the reference's model too (push_normal_task has
        no execution deadline).
        """
        slot.pushed_any = True
        now = time.time()
        for pt in pts:
            pt.pushed_to = slot.node_id
            slot.outstanding[pt.spec.task_id] = pt
            # Lease ladder: negotiation stamps come from the slot, clamped
            # into [task submission, now] — a warm lease granted before
            # this task existed contributes ~0 negotiation latency, which
            # is exactly what the task experienced. The executing worker
            # stamps ARGS_FETCHED/RUNNING on its side.
            req = min(max(slot.lease_requested_ts, pt.submitted_ts), now)
            granted = min(max(slot.lease_granted_ts, req), now)
            tid, name = pt.spec.task_id, pt.spec.name
            self._record_task_event(tid, name, "LEASE_REQUESTED", ts=req)
            if slot.lease_timing:
                self._record_task_event(
                    tid, name, "LEASE_GRANTED", ts=granted,
                    raylet_queue_ms=slot.lease_timing["queue_wait_ms"],
                    worker_attach_ms=slot.lease_timing["worker_attach_ms"])
            else:
                self._record_task_event(tid, name, "LEASE_GRANTED",
                                        ts=granted)
            self._record_task_event(tid, name, "DISPATCHED", ts=now,
                                    target_node=slot.node_id)
        if slot.fp_id is not None and self._fp_sub_pump is not None:
            frame = rpc.pack([rpc.MSG_NOTIFY, 0, "PushTaskBatch",
                              {"specs": [pt.spec.to_wire() for pt in pts]}])
            if self._fp_sub_pump.send(slot.fp_id, frame):
                return
            # fp conn gone mid-lease: NOT silently degraded to the asyncio
            # channel — earlier fp batches may still be queued worker-side
            # and a later asyncio push could overtake them, inverting
            # producer-before-consumer order within this worker's single
            # exec thread (dependency-chain deadlock). Treat it like the
            # connection loss it almost certainly is: retire the slot,
            # give the lease back (kill: the worker may still be running
            # half a batch we are about to retry elsewhere), and
            # fail/retry the tasks.
            self._drop_slot_fp(slot)
            for pt in pts:
                slot.outstanding.pop(pt.spec.task_id, None)
            if slot in self._leases[shape]:
                self._leases[shape].remove(slot)

            async def give_back(slot=slot):
                try:
                    await slot.raylet.call(
                        "ReturnWorker",
                        {"lease_id": slot.lease_id, "kill": True})
                except Exception:
                    pass
                await slot.conn.close()
            supervised_task(give_back())
            for pt in pts:
                await self._handle_worker_failure(
                    pt, shape, "fastpath connection lost")
            return
        try:
            await slot.conn.notify(
                "PushTaskBatch",
                {"specs": [pt.spec.to_wire() for pt in pts]})
        except (rpc.RpcError, asyncio.TimeoutError, OSError) as e:
            for pt in pts:
                slot.outstanding.pop(pt.spec.task_id, None)
            if slot in self._leases[shape]:
                self._leases[shape].remove(slot)
            for pt in pts:
                await self._handle_worker_failure(pt, shape, str(e))

    async def _handle_tasks_returned(self, slot: _LeaseSlot, shape: str,
                                     conn, payload):
        """The worker's running task blocked and handed back the
        UNSTARTED rest of its batch: re-enqueue them for fresh placement
        (no retry consumed — they never ran). The blocked task stays
        outstanding on the slot."""
        require_fields(payload, "task_ids", method="_handle_tasks_returned")
        for task_id in payload["task_ids"]:
            pt = slot.outstanding.pop(task_id, None)
            if pt is not None:
                pt.pushed_to = None
                self._enqueue_task(pt)

    async def _handle_task_done(self, slot: _LeaseSlot, shape: str,
                                conn, payload):
        require_fields(payload, "results", method="_handle_task_done")
        for task_id, result in payload["results"]:
            pt = slot.outstanding.pop(task_id, None)
            if pt is not None:
                await self._complete_task(pt, result, slot.node_id,
                                          borrower_id=slot.worker_id,
                                          borrower_addr=slot.worker_addr)
        if not slot.outstanding:
            supervised_task(self._on_slot_idle(slot, shape))

    def _on_slot_conn_closed(self, slot: _LeaseSlot, shape: str):
        """Worker connection died: drop the slot (idle or not) and
        fail/retry everything still pushed."""
        self._drop_slot_fp(slot)
        if slot in self._leases[shape]:
            self._leases[shape].remove(slot)
        if self._shutdown or not slot.outstanding:
            return
        pts = list(slot.outstanding.values())
        slot.outstanding.clear()

        async def fail_all():
            for pt in pts:
                await self._handle_worker_failure(
                    pt, shape, "worker connection lost")
        supervised_task(fail_all())

    async def _handle_worker_failure(self, pt: _PendingTask, shape: str, reason: str):
        if pt.retries_left != 0:
            pt.retries_left -= 1
            logger.warning("task %s failed (%s); retrying (%s left)",
                           pt.spec.name, reason, pt.retries_left)
            self._record_task_event(pt.spec.task_id, pt.spec.name, "RETRYING")
            self._enqueue_task(pt)
        else:
            err = serialization.serialize_exception(
                exc.WorkerCrashedError(f"worker died running {pt.spec.name}: {reason}"))
            self._complete_task_error(pt, err)

    def _return_hexes(self, pt: _PendingTask) -> list[str]:
        if pt.return_hexes is None:
            task_id = TaskID.from_hex(pt.spec.task_id)
            pt.return_hexes = [
                ObjectID.for_task_return(task_id, i + 1).hex()
                for i in range(pt.spec.num_returns)]
        return pt.return_hexes

    def _fail_reconstruction(self, pt: _PendingTask, err_meta: bytes,
                             err_data: bytes) -> None:
        """A reconstructing re-execution failed: the queue has no
        consumer, so the waiting get()s are unblocked by failing every
        still-PENDING object of this lineage directly."""
        for o in self.objects.values():
            if o.lineage_task == pt.spec.task_id and o.state == OBJ_PENDING:
                o.state = OBJ_FAILED
                o.error = (err_meta, err_data)
                if o.ready_event:
                    o.ready_event.set()

    def _complete_task_error(self, pt: _PendingTask, err):
        self.pending_tasks.pop(pt.spec.task_id, None)
        self._abandoned_streams.discard(pt.spec.task_id)
        self._record_task_event(pt.spec.task_id, pt.spec.name, "FAILED")
        if pt.reconstructing:
            self._fail_reconstruction(pt, err.meta, err.to_bytes())
        elif pt.stream_q is not None:
            pt.stream_q.put(("error", err.meta, err.to_bytes()))
        else:
            for oid_hex in self._return_hexes(pt):
                o = self.objects.setdefault(oid_hex, _OwnedObject())
                o.state = OBJ_FAILED
                o.error = (err.meta, err.to_bytes())
                if o.ready_event:
                    o.ready_event.set()
        self._release_submitted_refs(pt)

    async def _complete_task(self, pt: _PendingTask, resp: dict, node_id: str,
                             borrower_id: str = "", borrower_addr=None):
        spec = pt.spec
        if resp.get("status") == "error" and resp.get("retryable") \
                and pt.retries_left != 0 and (
                    spec.retry_exceptions or resp.get("system_retryable")):
            # system_retryable: the worker could not run the task at all
            # (e.g. CUDA is initialised there over other cards) — a
            # system condition retried like worker death, independent of
            # the user's retry_exceptions setting.
            pt.retries_left -= 1
            # The failed attempt may still hold borrows (refs it stashed
            # out-of-band before raising): the worker marked them
            # registered and waits for owner-initiated release, so they
            # must reach the owners even though the result is discarded.
            # Spawned: a slow forward must not delay the retry or the
            # rest of the reply batch (the retry keeps its arg holds, so
            # there is no release to order against).
            for oid_hex, owner_wire in resp.get("borrows") or []:
                if borrower_id:
                    self._spawn(self._forward_borrow(
                        oid_hex, owner_wire, borrower_id, borrower_addr))
            self._enqueue_task(pt)
            return
        self.pending_tasks.pop(spec.task_id, None)
        self._abandoned_streams.discard(spec.task_id)
        hexes = self._return_hexes(pt)
        if resp.get("status") == "error":
            self._record_task_event(spec.task_id, spec.name, "FAILED")
            err_meta, err_data = resp["error"]
            if pt.reconstructing:
                self._fail_reconstruction(pt, bytes(err_meta),
                                          bytes(err_data))
            elif pt.stream_q is not None:
                # Items already yielded stay valid (they were produced);
                # the generator raises at the failure point.
                pt.stream_q.put(("error", bytes(err_meta),
                                 bytes(err_data)))
            else:
                for oid_hex in hexes:
                    o = self.objects.setdefault(oid_hex, _OwnedObject())
                    o.state = OBJ_FAILED
                    o.error = (bytes(err_meta), bytes(err_data))
                    if o.ready_event:
                        o.ready_event.set()
        else:
            self._record_task_event(spec.task_id, spec.name, "FINISHED")
            # Keep lineage for reconstruction (bounded). Size estimate is
            # structural, not str(args) — str() of wire args costs more
            # than the rest of completion at trivial-task rates.
            # Streaming tasks keep lineage too (r4): a yield object lost
            # AFTER completion reconstructs by re-running the generator
            # in reconstructing mode (yields re-register, no delivery).
            if spec.task_id not in self.lineage and \
                    self._lineage_bytes < self.config.max_lineage_bytes:
                self.lineage[spec.task_id] = spec
                est = 64
                for a in spec.args:
                    est += len(a[2]) + 16 if a[0] == "v" else 80
                self._lineage_bytes += est
                self._lineage_est[spec.task_id] = est
            for i, result in enumerate(resp["results"]):
                oid_hex = hexes[i] if i < len(hexes) else \
                    ObjectID.for_task_return(
                        TaskID.from_hex(spec.task_id), i + 1).hex()
                self._register_return(spec.task_id, oid_hex, result)
            if pt.stream_q is not None and not pt.reconstructing:
                pt.stream_q.put(("end",))
        # Borrower handoff BEFORE releasing our own holds: args the worker
        # still references are registered with their owners first, on the
        # same ordered owner connections our releases use. Forwards can
        # block for seconds (retry-with-backoff against a busy owner), so
        # they run in a spawned per-task continuation — ordering only
        # matters WITHIN a task (forwards, then release), and awaiting
        # here would stall every other result in the same TaskDone batch.
        borrows = [b for b in (resp.get("borrows") or []) if borrower_id]
        if borrows:
            self._spawn(self._forward_borrows_then_release(
                pt, borrows, borrower_id, borrower_addr))
        else:
            self._release_submitted_refs(pt)

    def _refs_ready_local(self, refs) -> bool:
        """Every ref resolvable without blocking — owned READY entries,
        or borrowed refs whose data is already sealed in the local shm
        store. Drives both the blocked-credit notification and the
        batch-return decision (thread-safe enough from the exec thread:
        plain dict/store reads under the GIL, best-effort by design)."""
        for oid, _owner in refs:
            o = self.objects.get(oid.hex())
            if o is not None and o.state == OBJ_READY:
                continue
            try:
                if self.store.contains(oid):
                    continue
            except Exception:
                pass
            return False
        return True

    def _set_lineage_task(self, o, task_id_hex: "str | None") -> None:
        """Assign an owned object's creating task, keeping the per-task
        live-object count exact (spec retention is per TASK; see
        _free_object)."""
        old = o.lineage_task
        if old == task_id_hex:
            return
        if old:
            live = self._lineage_live.get(old, 0) - 1
            if live > 0:
                self._lineage_live[old] = live
            else:
                self._lineage_live.pop(old, None)
        if task_id_hex:
            self._lineage_live[task_id_hex] = \
                self._lineage_live.get(task_id_hex, 0) + 1
        o.lineage_task = task_id_hex

    def _register_return(self, task_id_hex: str, oid_hex: str, result,
                         lineage: bool = True):
        """Record one arrived return/yield entry as an owned READY
        object (shared by TaskDone results and TaskYield streams —
        streamed yields carry lineage too: a lost yield reconstructs by
        re-running the generator, which replays every yield through the
        reconstructing path)."""
        o = self.objects.setdefault(oid_hex, _OwnedObject())
        if result[0] == "v":
            o.inline = (bytes(result[1]), bytes(result[2]))
            o.size = len(o.inline[1])
        else:  # ["s", node_id, size, (nested)]
            o.locations.add(result[1])
            o.size = result[2]
        o.state = OBJ_READY
        self._set_lineage_task(o, task_id_hex if lineage else None)
        # Refs embedded in the returned payload: the executing worker
        # pre-registered us with their owners; hold them for as long as
        # this return object lives.
        if len(result) > 3 and result[3]:
            self._track_container(oid_hex, [tuple(n) for n in result[3]])
        # Device-plane descriptor: the payload is only a stub; the
        # tensors stay pinned in the executing worker until this object
        # frees (see _free_object).
        o.device = result[4] if len(result) > 4 and result[4] else None
        if o.ready_event:
            o.ready_event.set()

    async def _handle_task_yield(self, conn, payload):
        """One streamed item from a num_returns='streaming' task: give
        it a return id, register ownership, and hand the ref to the
        driver-side generator (reference: streaming ObjectRefGenerator,
        task_manager.cc HandleReportGeneratorItemReturns)."""
        require_fields(payload, "index", "result", "task_id",
                       method="_handle_task_yield")
        pt = self.pending_tasks.get(payload["task_id"])
        if pt is None or pt.stream_q is None:
            return  # task already completed/failed; late yield dropped
        index = payload["index"]
        oid_hex = ObjectID.for_task_return(
            TaskID.from_hex(pt.spec.task_id), index + 1).hex()
        if pt.reconstructing:
            # Lineage re-execution of a completed generator: a replayed
            # yield refreshes its owned object ONLY if someone still
            # holds a ref (the entry exists) — resurrecting a freed
            # yield would leak an unowned store copy and re-pin the
            # lineage spec. Unclaimed replayed copies on the executing
            # node are unreferenced and fall to LRU eviction.
            if oid_hex in self.objects:
                self._register_return(pt.spec.task_id, oid_hex,
                                      payload["result"])
            return
        # Fast-forward: a retried generator replays from index 0; items
        # below next_yield_index were already delivered (the re-computed
        # value re-registers, refreshing any lost copy, but no duplicate
        # ref is handed to the consumer).
        replay = index < pt.next_yield_index
        if not replay:
            pt.return_hexes.append(oid_hex)
            pt.next_yield_index = index + 1
        # No ref added here: the ObjectRef the generator constructs on
        # iteration registers the local ref (owned objects are not
        # collected before any ref transition occurs).
        self._register_return(pt.spec.task_id, oid_hex, payload["result"])
        if replay:
            return
        if payload["task_id"] in self._abandoned_streams:
            # Generator was closed/dropped: free the item immediately
            # instead of buffering it forever.
            self._add_local_ref_impl(oid_hex)
            self._remove_local_ref_impl(oid_hex)
            return
        pt.stream_q.put(("item", oid_hex))

    def abandon_stream(self, task_id_hex: str) -> None:
        """Mark a streaming task's remaining yields free-on-arrival and
        free already-buffered ones (called from
        ObjectRefGenerator.close)."""
        self._post(self._abandon_stream_impl, task_id_hex)

    def _abandon_stream_impl(self, task_id_hex: str) -> None:
        # The queue registry (not pending_tasks) is the lookup: a
        # generator dropped AFTER its task completed must still free
        # the buffered unconsumed items (they hold owned objects with
        # no ObjectRef ever created — leaked before this registry).
        q = self._stream_queues.pop(task_id_hex, None)
        if q is None:
            return
        self._abandoned_streams.add(task_id_hex)
        # Drain ON THE LOOP (every put happens here too): a yield whose
        # dispatch raced a caller-thread drain would otherwise land in
        # the orphaned queue after the drain saw it empty and leak.
        while True:
            try:
                item = q.get_nowait()
            except _queue.Empty:
                break
            if item[0] == "item":
                self._add_local_ref_impl(item[1])
                self._remove_local_ref_impl(item[1])
        # Wake any OTHER consumer thread still blocked in next() (e.g. a
        # client-proxy pump whose remote driver closed the stream).
        q.put(("end",))

    def stream_finished(self, task_id_hex: str) -> None:
        """Consumer saw the stream's terminal entry: drop bookkeeping
        (an exhausted stream has nothing left to free)."""
        self._post(self._stream_queues.pop, task_id_hex, None)

    async def _forward_borrows_then_release(self, pt, borrows, borrower_id,
                                            borrower_addr):
        for oid_hex, owner_wire in borrows:
            await self._forward_borrow(oid_hex, owner_wire, borrower_id,
                                       borrower_addr)
        self._release_submitted_refs(pt)

    def _release_submitted_refs(self, pt):
        """Release per-submission holds (top-level arg refs + nested refs
        inside value args). Accepts a _PendingTask or bare TaskSpec."""
        spec = pt.spec if isinstance(pt, _PendingTask) else pt
        nested = pt.nested_args if isinstance(pt, _PendingTask) else []
        for a in spec.args:
            if a[0] == "r":
                self._release_one_hold(a[1])
        for oid_hex, _owner in nested:
            self._release_one_hold(oid_hex)

    def _release_one_hold(self, oid_hex: str):
        o = self.objects.get(oid_hex)
        if o is not None:
            o.submitted_refs -= 1
            if o.submitted_refs <= 0 and o.local_refs <= 0 \
                    and not o.borrowers:
                self._free_object(oid_hex)
        else:
            self.borrow_decr(oid_hex)

    # ---------- owner-side status service ----------

    async def _handle_add_object_location(self, conn, payload):
        """A node finished pulling a copy: record it so later pullers
        stripe across all holders (reference: object directory location
        updates, ownership_based_object_directory.h)."""
        require_fields(payload, "node_id", "object_id",
                       method="_handle_add_object_location")
        o = self.objects.get(payload["object_id"])
        if o is not None and o.state == OBJ_READY:
            o.locations.add(payload["node_id"])

    async def _handle_get_object_status(self, conn, payload):
        require_fields(payload, "object_id",
                       method="_handle_get_object_status")
        oid_hex = payload["object_id"]
        wait_s = payload.get("wait_s", 0)
        o = self.objects.get(oid_hex)
        if o is not None and o.state == OBJ_PENDING and wait_s > 0:
            if o.ready_event is None:
                o.ready_event = asyncio.Event()
            try:
                await asyncio.wait_for(o.ready_event.wait(), wait_s)
            except asyncio.TimeoutError:
                pass
        o = self.objects.get(oid_hex)
        if o is None:
            # Maybe it's in our local store anyway (borrowed object).
            if self.store.contains(ObjectID.from_hex(oid_hex)):
                return {"status": "stored", "locations": [self.node_id]}
            return {"status": "unknown"}
        if o.state == OBJ_FAILED:
            return {"status": "failed", "meta": o.error[0], "data": o.error[1]}
        if o.state == OBJ_PENDING:
            return {"status": "pending"}
        # Refs embedded in this payload: pre-register the requester as
        # borrower with their owners (ordered before any release of this
        # container's own holds on the same owner connections).
        nested = self._container_nested.get(oid_hex) or []
        requester = payload.get("requester", "")
        requester_addr = payload.get("requester_addr")
        if nested and requester:
            for n_oid, n_owner in nested:
                await self._forward_borrow(n_oid, n_owner, requester,
                                           requester_addr)
        nested_wire = [[n, w] for n, w in nested]
        if o.inline is not None:
            return {"status": "inline", "meta": o.inline[0],
                    "data": o.inline[1], "nested": nested_wire}
        return {"status": "stored", "locations": sorted(o.locations),
                "nested": nested_wire}

    # ---------- device object plane (device_objects.py) ----------

    async def _handle_device_object_pull(self, conn, payload):
        from ray_tpu_torch._private import device_objects

        return await device_objects.handle_pull(self, payload)

    async def _handle_device_object_release(self, conn, payload):
        from ray_tpu_torch._private import device_objects

        return await device_objects.handle_release(self, payload)

    async def _handle_device_object_stats(self, conn, payload):
        from ray_tpu_torch._private import device_objects

        return await device_objects.handle_stats(self, payload)

    async def _handle_device_object_evacuate(self, conn, payload):
        """Drain path: the raylet asks this worker to re-home its pinned
        tensors before the node dies (see device_objects.evacuate)."""
        from ray_tpu_torch._private import device_objects

        return await device_objects.evacuate(self)

    async def _handle_device_object_repin(self, conn, payload):
        """Drain path, ref-owner side: accept evacuated tensors and pin
        them locally under their original keys."""
        from ray_tpu_torch._private import device_objects

        return await device_objects.handle_repin(self, payload)

    def _repoint_device_pin(self, prefix: str, addr_wire) -> None:
        """Loop-side: after a drain evacuation re-pinned a device
        object's arrays in THIS process, repoint the owned object's pin
        address (o.device) and rewrite an inline descriptor payload so
        future fetches hand consumers live stub addresses (a sealed
        store-resident payload cannot be rewritten; owner-side gets
        still recover via the refreshed o.device)."""
        from ray_tpu_torch._private import device_objects

        for o in self.objects.values():
            if not o.device or o.device[1] != prefix:
                continue
            o.device[0] = addr_wire
            if o.inline is not None:
                try:
                    kind, value = serialization.deserialize(*o.inline)
                    if kind == serialization.KIND_DEVICE:
                        sobj = serialization.serialize(
                            device_objects.retarget_stubs(value, addr_wire),
                            kind=serialization.KIND_DEVICE)
                        o.inline = (sobj.meta, sobj.to_bytes())
                except Exception:
                    logger.exception("device descriptor rewrite failed")
            break

    def _set_device_info(self, oid_hex: str, dev_info: list) -> None:
        """Loop-side: attach device-plane pin info to an owned object
        (device_objects.device_put posts this after storing the stub)."""
        o = self.objects.get(oid_hex)
        if o is not None:
            o.device = dev_info

    async def _release_device_object(self, dev_info: list) -> None:
        """Unpin a freed device object's tensors on its pinning worker."""
        addr_wire, prefix = dev_info[0], dev_info[1]
        try:
            from ray_tpu_torch._private import device_objects

            if addr_wire is None or addr_wire[2] == self.worker_id:
                device_objects.registry().release_prefix(prefix)
                return
            conn = await self._owner_conn(Address.from_wire(addr_wire))
            await conn.notify("DeviceObjectRelease", {"prefix": prefix})
        except Exception:
            pass  # pin worker already dead: nothing left to unpin

    def _resolve_device_value(self, oid: ObjectID, owner, value):
        """Swap DeviceObjectStubs for tensors. A gone pin (worker
        died) reports the object lost; when WE own the object the
        existing lineage reconstruction re-executes the creating task
        (which re-pins fresh tensors) and resolution retries against the
        refreshed descriptor — the device-plane twin of the store-copy
        recovery path in _fetch_object."""
        from ray_tpu_torch._private import device_objects

        oid_hex0 = oid.hex()
        o0 = self.objects.get(oid_hex0)
        if o0 is not None and o0.device and o0.device[0]:
            # The owner's pin record is authoritative: a drain
            # evacuation (or reconstruction) may have re-homed the pins
            # since the descriptor bytes were sealed — resolve against
            # the live address, not the payload's.
            value = device_objects.retarget_stubs(value, o0.device[0])
        try:
            return device_objects.resolve_value(value, self)
        except exc.DeviceObjectLostError:
            device_objects.note_lost()
            oid_hex = oid.hex()
            o = self.objects.get(oid_hex)
            owned = owner is None or owner.worker_id == self.worker_id
            if o is None or not o.lineage_task or not owned:
                raise
            recovered = self._run(self._try_reconstruct(oid_hex))
            if not recovered:
                raise
            # Re-fetch the REFRESHED descriptor through the normal path
            # (covers both inline and store-resident stub payloads; a
            # descriptor over max_inline_object_size lives in shm).
            meta, data, pin = self._run(
                self._fetch_object(oid, owner,
                                   self.config.rpc_call_timeout_s))
            data_b = bytes(data)
            if pin is not None:
                pin[0].release(oid)
            kind, fresh = serialization.deserialize(meta, data_b)
            if kind != serialization.KIND_DEVICE:
                return fresh
            # A store-resident payload may still be the pre-death copy
            # (sealed objects are not rewritten): the refreshed o.device
            # knows where the re-executed task pinned; same keys, new
            # worker.
            o = self.objects.get(oid_hex)
            if o is not None and o.device and o.device[0]:
                fresh = device_objects.retarget_stubs(fresh, o.device[0])
            return device_objects.resolve_value(fresh, self)

    # ---------- execution (worker side) ----------

    async def _handle_push_task_batch(self, conn, payload):
        """Notify sink: execute a batch of task specs sequentially,
        STREAMING each completion back as a TaskDone notify (coalesced by
        _queue_task_done). The whole batch is ONE exec-queue item so a
        burst of trivial tasks costs one thread handoff, not N."""
        require_fields(payload, "specs", method="_handle_push_task_batch")
        specs = [TaskSpec.from_wire(w) for w in payload["specs"]]
        self._exec_enqueue((specs, conn))

    def _queue_task_done(self, conn, task_id: str, result: dict):
        """Exec-thread side: buffer a completion for `conn` and schedule
        ONE loop-side flush. Results produced while the loop is busy
        coalesce into a single TaskDone frame (natural batching — no
        timers), while a lone completion flushes immediately (dependency
        chains need results visible before the batch finishes)."""
        with self._done_lock:
            self._done_buf.setdefault(conn, []).append([task_id, result])
            wake = conn not in self._done_scheduled
            if wake:
                self._done_scheduled.add(conn)
        if wake:
            try:
                self.loop.call_soon_threadsafe(self._flush_task_done, conn)
            except RuntimeError:
                pass

    def _flush_task_done(self, conn):
        with self._done_lock:
            results = self._done_buf.pop(conn, [])
            self._done_scheduled.discard(conn)
        if results and not conn.closed:
            # Owner death between the closed check and the send is an
            # expected end-state, not a daemon bug.
            supervised_task(
                conn.notify("TaskDone", {"results": results}),
                name="notify-task-done", ignore=(rpc.ConnectionLost,))

    async def _handle_profile(self, conn, payload):
        """Statistical CPU profile of THIS worker for `duration_s`
        (reference: the dashboard reporter module's per-worker py-spy/
        memray hooks — no external profiler exists in this image, so
        the worker samples its own frames). Returns aggregated
        (function, samples) hot spots per thread."""
        import sys as _sys

        duration = min(float(payload.get("duration_s", 2.0)), 30.0)
        interval = max(float(payload.get("interval_s", 0.005)), 0.001)
        depth = int(payload.get("depth", 3))
        counts: dict[str, int] = {}
        total = 0
        loop = asyncio.get_running_loop()
        deadline = loop.time() + duration
        me = threading.get_ident()
        while loop.time() < deadline:
            for tid, frame in _sys._current_frames().items():
                if tid == me:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < depth:
                    code = f.f_code
                    stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                 f"{f.f_lineno}:{code.co_name}")
                    f = f.f_back
                key = " < ".join(stack)
                counts[key] = counts.get(key, 0) + 1
                total += 1
            await asyncio.sleep(interval)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:50]
        return {"pid": os.getpid(), "worker_id": self.worker_id,
                "actor_id": self._actor_id, "duration_s": duration,
                "samples": total,
                "hot": [{"stack": k, "count": v} for k, v in top]}

    async def _handle_debug_tasks(self, conn, payload):
        """Submission-side state dump: this worker's owned pending tasks
        and lease slots (reference: the debug_state.txt task/lease
        sections node_manager.cc dumps). Served per-node via the
        raylet's NodeDebugTasks — the tool that found the nested-fanout
        wedge (see PARITY Known gaps)."""
        out = {"worker_id": self.worker_id, "pid": os.getpid(),
               "pending": [], "slots": []}
        for tid, pt in self.pending_tasks.items():
            out["pending"].append({
                "task": pt.spec.name, "task_id": tid[:12],
                "pushed_to": pt.pushed_to and pt.pushed_to[:8],
                "retries_left": pt.retries_left})
        for shape, slots in self._leases.items():
            for s in slots:
                out["slots"].append({
                    "worker": s.worker_id[:8], "busy": s.busy,
                    "outstanding": [p.spec.name for p in
                                    s.outstanding.values()],
                    "fp": s.fp_id is not None,
                    "conn_closed": s.conn.closed})
        return out

    async def _handle_dump_stack(self, conn, payload):
        """All-thread stack dump (reference: `ray stack` py-spies every
        worker, scripts.py:2453 — here the worker reports its own frames,
        no external profiler needed)."""
        import sys

        frames = sys._current_frames()
        threads = {t.ident: t for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            t = threads.get(ident)
            name = t.name if t else f"thread-{ident}"
            stack = "".join(traceback.format_stack(frame))
            out.append({"thread": name, "daemon": bool(t and t.daemon),
                        "stack": stack})
        return {"pid": os.getpid(), "worker_id": self.worker_id,
                "actor_id": self._actor_id, "threads": out}

    def _run_exec_item(self, item) -> None:
        """Execute one queued item (shared by the asyncio-fed queue path
        and fastpath injection)."""
        spec, sink = item[0], item[1]
        if isinstance(spec, list):  # batch item: sink is the owner conn
            def emit(task_id, index, entry, conn=sink):
                # Yields notify IMMEDIATELY (not coalesced like
                # TaskDone): loop FIFO keeps them ahead of the
                # task's completion on the same connection.
                self.loop.call_soon_threadsafe(
                    lambda: supervised_task(conn.notify(
                        "TaskYield",
                        {"task_id": task_id, "index": index,
                         "result": entry}),
                        name="notify-yield",
                        ignore=(rpc.ConnectionLost,)))

            remaining = _collections.deque(spec)

            def return_unstarted(conn=sink, remaining=remaining):
                # See the fastpath twin in _fp_exec_frame: a blocking
                # task hands its unstarted batch-mates back.
                ids = [s.task_id for s in remaining]
                remaining.clear()
                if ids:
                    self.loop.call_soon_threadsafe(
                        lambda: supervised_task(conn.notify(
                            "TasksReturned", {"task_ids": ids}),
                            name="notify-tasks-returned",
                            ignore=(rpc.ConnectionLost,)))

            self._exec_tls.batch_return = return_unstarted
            try:
                while remaining:
                    s = remaining.popleft()
                    self._queue_task_done(sink, s.task_id,
                                          self._execute_task(s, emit))
            finally:
                self._exec_tls.batch_return = None
        else:  # single item: sink is a future; item[2] (if present) is
            # the caller conn for streaming actor-method yields
            emit = None
            if len(item) > 2 and spec.num_returns == STREAMING_RETURNS:
                def emit(task_id, index, entry, conn=item[2]):
                    self.loop.call_soon_threadsafe(
                        lambda: supervised_task(conn.notify(
                            "TaskYield",
                            {"task_id": task_id, "index": index,
                             "result": entry}),
                            name="notify-yield",
                            ignore=(rpc.ConnectionLost,)))

            result = self._execute_task(spec, emit)
            self.loop.call_soon_threadsafe(
                lambda f=sink, r=result: (not f.done()) and
                f.set_result(r))

    def _exec_enqueue(self, item) -> None:
        """Hand an exec item to the execution thread(s): fastpath
        injection when the native pump runs the task loop, else the
        plain queue."""
        pump = self._fp_exec_pump
        if pump is not None:
            with self._inject_lock:
                token = next(self._inject_token)
                self._inject_items[token] = item
            pump.inject(token)
        else:
            self._exec_queue.put(item)

    def execution_loop(self):
        """Main thread of a pool worker: executes tasks sequentially
        (reference: _raylet.pyx:3044 run_task_loop)."""
        if self._fp_exec_pump is not None:
            return self._execution_loop_fastpath(self._fp_exec_pump)
        while not self._shutdown:
            try:
                item = self._exec_queue.get(timeout=0.5)
            except _queue.Empty:
                continue
            if item is None:
                break
            self._run_exec_item(item)

    def _execution_loop_fastpath(self, pump):
        """Native task loop: block in C (GIL released) for the next
        event — an inbound PushTaskBatch frame from an owner's fastpath
        socket, or an injected loop-side item (actor calls, assigns).
        Completions coalesce into TaskDone frames (flushed at batch end,
        every 64 results, once the task running after them has taken
        FP_HOLD_S (_HeldDoneWatch), and — the deadlock-safe rule —
        whenever THIS exec thread is about to block in get()/wait(),
        since a task consuming an earlier buffered result in the same
        batch is the only way a held completion could stall progress;
        see get()).
        Yields go immediately; the socket FIFO is the ordering guarantee
        (reference: the worker main loop in _raylet.pyx:3044 runs inside
        the C++ CoreWorker the same way)."""
        from ray_tpu_torch._private.native_fastpath import EV_FRAME, EV_INJECT
        while not self._shutdown:
            ev = pump.next(0.5)
            if ev is None:
                continue
            kind, cid, payload = ev
            if kind == EV_FRAME:
                try:
                    self._fp_exec_frame(pump, cid, payload)
                except Exception:
                    # Must not escape: this is the worker's only task
                    # loop — an owner bug (malformed spec) would
                    # otherwise kill it silently with sockets left open.
                    logger.exception("fastpath: frame handling failed")
            elif kind == EV_INJECT:
                with self._inject_lock:
                    item = self._inject_items.pop(cid, None)
                if item is None:
                    continue
                self._run_exec_item(item)
            # EV_ACCEPT / EV_CLOSE: connection registry lives in C; the
            # owner side drives retries, nothing to do here.

    def _fp_exec_frame(self, pump, cid, payload):
        """Handle one inbound fastpath frame on the exec thread."""
        _mt, _seq, method, pl = rpc.unpack(payload)
        if method != "PushTaskBatch":
            logger.warning("fastpath: unexpected method %r", method)
            return
        buffered: list = []
        # The held-completion watch flushes from its own thread: every
        # send on this conn and every change to `buffered` is under it.
        lock = threading.Lock()

        def send_held(cid=cid, buffered=buffered):
            if buffered:
                pump.send(cid, rpc.pack(
                    [rpc.MSG_NOTIFY, 0, "TaskDone",
                     {"results": buffered}]))
                buffered.clear()

        def flush(lock=lock, send_held=send_held):
            with lock:
                send_held()

        def emit(task_id, index, entry, cid=cid, lock=lock,
                 send_held=send_held):
            # A yield must not overtake completions of
            # EARLIER tasks buffered on this conn.
            with lock:
                send_held()
                pump.send(cid, rpc.pack(
                    [rpc.MSG_NOTIFY, 0, "TaskYield",
                     {"task_id": task_id, "index": index,
                      "result": entry}]))

        self._exec_tls.fp_flush = flush
        # Remaining-specs deque: if the RUNNING task blocks in get(),
        # the unstarted rest of this batch is handed BACK to the owner
        # (get() calls batch_return) — a blocked task must not serialize
        # its batch-mates behind it (nested fan-outs deadlock otherwise:
        # the mate's subtree is what the blocked task waits for, at
        # sufficient depth).
        remaining = _collections.deque(pl["specs"])

        def return_unstarted(pump=pump, cid=cid, remaining=remaining,
                             lock=lock, send_held=send_held):
            ids = []
            while remaining:
                # task_id is wire element 0 (TaskSpec.to_wire) — no need
                # to materialize the full spec on this latency-critical
                # about-to-block path.
                ids.append(remaining.popleft()[0])
            if ids:
                with lock:
                    send_held()  # completions of earlier batch-mates first
                    pump.send(cid, rpc.pack(
                        [rpc.MSG_NOTIFY, 0, "TasksReturned",
                         {"task_ids": ids}]))

        self._exec_tls.batch_return = return_unstarted
        watch = self._fp_held_watch
        try:
            while remaining:
                s = TaskSpec.from_wire(remaining.popleft())
                watch.hold(flush if buffered else None)
                try:
                    result = self._execute_task(s, emit)
                finally:
                    watch.hold(None)
                with lock:
                    buffered.append([s.task_id, result])
                    if len(buffered) >= 64:
                        send_held()
        finally:
            self._exec_tls.batch_return = None
            self._exec_tls.fp_flush = None
            flush()

    def _start_actor_concurrency(self, max_concurrency: int) -> None:
        """Spawn extra execution threads so up to max_concurrency actor
        tasks run at once (reference: threaded actors / concurrency
        groups). Delivery order from each caller is still FIFO — tasks are
        STARTED in order and may then overlap, the reference's semantics
        for concurrent actors."""
        n = min(int(max_concurrency or 1), 64)
        if n <= 1 or getattr(self, "_extra_exec_threads", None):
            return
        self._extra_exec_threads = []
        for i in range(n - 1):
            t = threading.Thread(target=self.execution_loop, daemon=True,
                                 name=f"actor-exec-{i}")
            t.start()
            self._extra_exec_threads.append(t)

    _actor_loop_lock = threading.Lock()

    def _actor_async_loop(self) -> asyncio.AbstractEventLoop:
        # Locked lazy init: concurrent first async calls must share ONE
        # loop (async-actor code relies on single-loop interleaving).
        with self._actor_loop_lock:
            loop = getattr(self, "_actor_loop", None)
            if loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever, daemon=True,
                                     name="actor-asyncio")
                t.start()
                self._actor_loop = loop
            return loop

    def _resolve_args(self, spec: TaskSpec):
        """Materialize arg values. Borrowed refs rebuilt from value args
        are collected: those still held when the task finishes are
        reported in the reply so the submitter can register this worker
        with their owners (reference: reference_count.cc borrows returned
        in the PushTask reply)."""
        from ray_tpu_torch._private.api_internal import deser_context

        values = []
        collected: list = []
        for a in spec.args:
            if a[0] == "v":
                with deser_context() as dsink:
                    _, value = serialization.deserialize(
                        bytes(a[1]), bytes(a[2]))
                collected.extend(dsink)
                values.append(value)
            else:
                oid = ObjectID.from_hex(a[1])
                owner = Address.from_wire(a[2]) if a[2] else None
                values.append(self.get([(oid, owner)])[0])
        nkw = len(spec.kwargs_keys)
        if nkw:
            pos, kw_vals = values[:-nkw], values[-nkw:]
            kwargs = dict(zip(spec.kwargs_keys, kw_vals))
        else:
            pos, kwargs = values, {}
        self._exec_tls.arg_borrows = collected
        return pos, kwargs

    def _surviving_borrows(self) -> list:
        """Borrowed arg refs the user code still holds at completion
        (count > 0): reported in the reply; the submitter forwards them to
        the owners before releasing its own submission holds."""
        collected = getattr(self._exec_tls, "arg_borrows", None) or []
        self._exec_tls.arg_borrows = None
        out = []
        for oid_hex, owner in collected:
            if self.borrow_mark_registered(oid_hex):
                out.append([oid_hex,
                            owner.to_wire() if owner is not None else None])
        return out

    def _execute_task(self, spec: TaskSpec, yield_emit=None) -> dict:
        from ray_tpu_torch.runtime_env import runtime_env_context

        prev_task_id = self._current_task_id
        self._current_task_id = TaskID.from_hex(spec.task_id)
        if not self.is_driver and (spec.actor_creation or not spec.actor_id):
            # Accelerator isolation: the worker sees exactly the cards
            # its lease holds, "" for none (reference: CUDA_VISIBLE_DEVICES
            # / TPU_VISIBLE_CHIPS per lease). Actors pin the worker for
            # life, so the constructor's lease decides — actor METHOD
            # specs run under the same lease and must not re-pin.
            from ray_tpu_torch._private import accelerator

            accelerator.set_current_task_gpus(self._lease_gpu_ids)
            accelerator.pin_cuda_visible_devices()
            if accelerator.current_task_needs_fresh_worker():
                # CUDA is already initialised here over other cards and
                # cannot switch; running the task here would compute on
                # the wrong card (or none). Fail retryable and retire
                # this worker so the retry lands on a fresh process.
                self._current_task_id = prev_task_id
                self.loop.call_later(0.5, lambda: os._exit(0))
                err = serialization.serialize_exception(RuntimeError(
                    "worker CUDA is initialised over cards "
                    f"{accelerator.pinned_visible()!r}; a task leasing "
                    f"{accelerator.current_task_visible()!r} must run on a "
                    "fresh worker (will retry)"))
                return {"status": "error",
                        "error": [err.meta, err.to_bytes()],
                        "retryable": True, "system_retryable": True}
        from ray_tpu_torch.util import tracing

        try:
            if spec.actor_creation:
                cls = self._run(self._fetch_function(spec.func_key))
                args, kwargs = self._resolve_args(spec)
                self._record_task_event(spec.task_id, spec.name,
                                        "ARGS_FETCHED")
                # Actor envs persist: the process is dedicated to the actor
                # (reference: runtime-env-keyed workers, worker_pool.cc).
                with runtime_env_context(spec.runtime_env, persistent=True,
                                         job_id=spec.job_id):
                    with tracing.execute_span(spec.name, spec.task_id,
                                              spec.trace_ctx):
                        # RUNNING after env activation: the startup
                        # stage (ARGS_FETCHED → RUNNING) is the
                        # runtime-env build, not 0 by construction.
                        self._record_task_event(spec.task_id, spec.name,
                                                "RUNNING")
                        self._actor_instance = cls(*args, **kwargs)
                self._start_actor_concurrency(spec.max_concurrency)
                return {"status": "ok", "results": []}
            if spec.actor_id:
                fn = getattr(self._actor_instance, spec.name.split(".")[-1])
                args, kwargs = self._resolve_args(spec)
                self._record_task_event(spec.task_id, spec.name,
                                        "ARGS_FETCHED")
                self._record_task_event(spec.task_id, spec.name, "RUNNING")
                with tracing.execute_span(spec.name, spec.task_id,
                                          spec.trace_ctx):
                    result = fn(*args, **kwargs)
                    # inspect (not asyncio): on Python <= 3.10
                    # asyncio.iscoroutine also matches plain GENERATORS
                    # (legacy @asyncio.coroutine support), which would
                    # misroute streaming actor methods onto the event
                    # loop ("Task got bad yield").
                    if inspect.iscoroutine(result):
                        # async actor method: run on the actor's event
                        # loop; concurrent calls (one per exec thread)
                        # interleave at await points (reference: asyncio
                        # actors, fiber.h).
                        result = asyncio.run_coroutine_threadsafe(
                            result, self._actor_async_loop()).result()
                    if spec.num_returns == STREAMING_RETURNS:
                        # Streaming actor method: iterate HERE so the
                        # generator body runs in the actor's contexts;
                        # yields flow back over the caller conn.
                        result = self._drain_stream(spec, result,
                                                    yield_emit)
            else:
                # Plain-dict cache hit avoids a cross-thread loop
                # round-trip per task (hot path: every task execution).
                fn = self._fn_cache.get(spec.func_key)
                if fn is None:
                    fn = self._run(self._fetch_function(spec.func_key))
                args, kwargs = self._resolve_args(spec)
                self._record_task_event(spec.task_id, spec.name,
                                        "ARGS_FETCHED")

                def run_fn():
                    # Stamped here — inside the runtime_env/tracing
                    # contexts when they apply — so the startup stage
                    # (ARGS_FETCHED → RUNNING) measures env activation
                    # instead of being structurally 0.
                    self._record_task_event(spec.task_id, spec.name,
                                            "RUNNING")
                    result = fn(*args, **kwargs)
                    if spec.num_returns != STREAMING_RETURNS:
                        return result
                    # Streaming generator task (reference: num_returns=
                    # "streaming" / ObjectRefGenerator): each yielded
                    # item packages like a return and flows back
                    # IMMEDIATELY as a TaskYield. The iteration runs
                    # HERE so the generator body executes inside the
                    # same runtime_env/tracing contexts as the call.
                    return self._drain_stream(spec, result, yield_emit)

                if not spec.runtime_env and not spec.trace_ctx \
                        and not tracing.enabled():
                    # Hot path: no env to activate, no span to open —
                    # skip both contextmanagers.
                    result = run_fn()
                else:
                    with runtime_env_context(spec.runtime_env,
                                             job_id=spec.job_id):
                        with tracing.execute_span(spec.name, spec.task_id,
                                                  spec.trace_ctx):
                            result = run_fn()
            if spec.num_returns == STREAMING_RETURNS:
                return {"status": "ok", "results": [],
                        "stream_count": result,
                        "borrows": self._surviving_borrows()}
            return {"status": "ok",
                    "results": self._package_results(spec, result),
                    "borrows": self._surviving_borrows()}
        except Exception as e:
            tb = traceback.format_exc()
            err = serialization.serialize_exception(e)
            return {"status": "error", "error": [err.meta, err.to_bytes()],
                    "retryable": not isinstance(e, exc.RayTpuError),
                    "borrows": self._surviving_borrows()}
        finally:
            self._current_task_id = prev_task_id

    def _drain_stream(self, spec: TaskSpec, iterable, yield_emit) -> int:
        """Iterate a streaming task's generator, emitting each packaged
        yield immediately; returns the yield count (shared by plain
        tasks and actor methods)."""
        if yield_emit is None:
            raise exc.RayTpuError(
                "streaming tasks require a yield-capable dispatch path")
        count = 0
        pctx = self._task_packaging_ctx(spec)
        for value in iterable:
            yield_emit(spec.task_id, count,
                       self._package_one(spec, count, value, pctx))
            count += 1
        return count

    def _task_packaging_ctx(self, spec: TaskSpec) -> tuple:
        """Per-task constants for _package_one, computed ONCE (a
        streaming task calls _package_one per yield — re-parsing the
        owner address per item would sit on the emit hot path)."""
        caller = Address.from_wire(spec.owner).worker_id if spec.owner else ""
        return caller, self.config.max_inline_object_size

    def _package_one(self, spec: TaskSpec, index: int, value,
                     ctx: tuple | None = None) -> list:
        """Package ONE return value as a wire entry — ["v", meta, data,
        nested] inline or ["s", node_id, size, nested] via the store at
        the return object id (task_id, index+1). Shared by fixed-arity
        returns and streaming yields."""
        from ray_tpu_torch._private.api_internal import collect_nested_refs

        caller, max_inline = ctx if ctx is not None \
            else self._task_packaging_ctx(spec)
        if getattr(spec, "tensor_transport", "") == "device":
            packaged = self._package_device_return(spec, index, value)
            if packaged is not None:
                return packaged
            # No tensor leaves in this return: normal host path.
        # Mirror of the submit-side primitive fast path: ref-free
        # builtin returns skip the collector + SerializedObject.
        if type(value) in _PRIMITIVE_TYPES and not (
                type(value) in (str, bytes)
                and len(value) >= max_inline):
            meta, data = serialization.serialize_primitive(value)
            if len(data) <= max_inline:
                return ["v", meta, data, []]
        with collect_nested_refs() as sink:
            sobj = serialization.serialize(value)
        if sink and caller:
            # Refs embedded in the return payload: register the CALLER
            # as borrower with each owner NOW (on our ordered owner
            # connections), before our own holds can be released —
            # this is what makes the return handoff race-free.
            for oid_hex, owner_wire in sink:
                self._run(self._forward_borrow(oid_hex, owner_wire,
                                               caller, spec.owner))
        nested = [[oid_hex, owner_wire] for oid_hex, owner_wire in sink]
        if sobj.total_size <= self.config.max_inline_object_size:
            return ["v", sobj.meta, sobj.to_bytes(), nested]
        oid = ObjectID.for_task_return(TaskID.from_hex(spec.task_id),
                                       index + 1)
        self._run(self._write_to_store_safe(oid, sobj))
        return ["s", self.node_id, sobj.total_size, nested]

    def _package_device_return(self, spec: TaskSpec, index: int, value):
        """tensor_transport="device" packaging: pin every tensor leaf
        of the return value in this process's device registry and ship
        only a stub payload (serialization.KIND_DEVICE) plus the pin
        descriptor; the tensor bytes stay where they are. Returns None
        when the value has no tensor leaves (host path applies).

        ObjectRefs embedded beside the arrays get the same borrower
        handoff as _package_one: the caller is registered with each
        owner BEFORE this worker's own holds can release."""
        from ray_tpu_torch._private import device_objects
        from ray_tpu_torch._private.api_internal import collect_nested_refs

        prefix = f"{spec.task_id}:{index + 1}"
        stubbed, dev_bytes, n_leaves = device_objects.extract_arrays(
            value, prefix, self)
        if not n_leaves:
            return None
        # The submitting caller owns the return ref: record it with the
        # pins so a drain evacuation knows where to re-home the arrays.
        device_objects.registry().note_ref_owner(prefix, spec.owner)
        with collect_nested_refs() as sink:
            sobj = serialization.serialize(stubbed,
                                           kind=serialization.KIND_DEVICE)
        caller = Address.from_wire(spec.owner).worker_id if spec.owner \
            else ""
        if sink and caller:
            for oid_hex, owner_wire in sink:
                self._run(self._forward_borrow(oid_hex, owner_wire,
                                               caller, spec.owner))
        nested = [[oid_hex, owner_wire] for oid_hex, owner_wire in sink]
        dev_info = [self.address.to_wire(), prefix, dev_bytes, n_leaves]
        if sobj.total_size <= self.config.max_inline_object_size:
            return ["v", sobj.meta, sobj.to_bytes(), nested, dev_info]
        oid = ObjectID.for_task_return(TaskID.from_hex(spec.task_id),
                                       index + 1)
        self._run(self._write_to_store_safe(oid, sobj))
        return ["s", self.node_id, sobj.total_size, nested, dev_info]

    def _package_results(self, spec: TaskSpec, result) -> list:
        if spec.num_returns == 0:
            return []
        if spec.num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {len(results)} values")
        pctx = self._task_packaging_ctx(spec)
        return [self._package_one(spec, i, v, pctx)
                for i, v in enumerate(results)]

    async def _write_to_store_safe(self, oid, sobj):
        await self._write_to_store(oid, sobj)

    # ---------- actors: worker side ----------

    async def _handle_set_lease_devices(self, conn, payload):
        """The raylet names the cards this worker's next lease holds,
        before the lease is handed to anyone; _execute_task pins them."""
        self._lease_gpu_ids = [str(g) for g in payload.get("gpu_ids") or []]
        return {"ok": True}

    async def _handle_assign_actor(self, conn, payload):
        require_fields(payload, "spec", method="_handle_assign_actor")
        spec = TaskSpec.from_wire(payload["spec"])
        self._actor_id = spec.actor_id
        fut = asyncio.get_running_loop().create_future()
        self._exec_enqueue((spec, fut))
        result = await fut
        # Creation tasks complete here (no owner-side TaskDone), so the
        # executing worker closes their lifecycle ladder itself.
        self._record_task_event(
            spec.task_id, spec.name,
            "FINISHED" if result["status"] == "ok" else "FAILED")
        if result["status"] != "ok":
            err = result.get("error")
            reason = "actor constructor failed"
            try:
                _, (cause, tb) = serialization.deserialize(
                    bytes(err[0]), bytes(err[1]))
                reason = f"{type(cause).__name__}: {cause}\n{tb}"
            except Exception:
                # Keep the generic reason; losing the pretty traceback
                # must not lose the death report itself.
                logger.warning("assign_actor(%s): could not deserialize "
                               "constructor error", spec.actor_id,
                               exc_info=True)
            await self.gcs.call("ReportActorDeath", {
                "actor_id": spec.actor_id, "reason": reason, "intended": True})
            self.loop.call_later(0.2, lambda: os._exit(1))
            return {"ok": False, "reason": reason}
        await self.gcs.call("ActorReady", {
            "actor_id": spec.actor_id, "address": self.address.to_wire()})
        return {"ok": True}

    async def _handle_actor_call(self, conn, payload):
        """Ordered per-caller actor task execution (reference:
        direct_actor_task_submitter.h:68 client seq-nos + server
        actor_scheduling_queue)."""
        require_fields(payload, "caller_id", "spec",
                       method="_handle_actor_call")
        spec = TaskSpec.from_wire(payload["spec"])
        caller = payload["caller_id"]
        state = self._actor_callers.setdefault(
            caller, {"next_seq": 0, "buffer": {}})
        fut = asyncio.get_running_loop().create_future()
        # conn rides along so streaming methods can push TaskYield
        # notifies back over the caller's ordered connection.
        state["buffer"][spec.actor_seq] = (spec, fut, conn)
        self._drain_actor_queue(state)
        return await fut

    def _drain_actor_queue(self, state) -> None:
        while state["next_seq"] in state["buffer"]:
            item = state["buffer"].pop(state["next_seq"])
            state["next_seq"] += 1
            if item is not None:  # None = abandoned seq (see ActorSeqSkip)
                self._exec_enqueue(item)

    async def _handle_actor_seq_skip(self, conn, payload):
        """A caller abandoned a seq-no it was assigned (its task failed
        terminally without ever being sent, e.g. retries exhausted across
        an actor restart).  Mark the slot so the ordered queue can advance
        — otherwise every later task from that caller waits forever."""
        require_fields(payload, "caller_id", "seq",
                       method="_handle_actor_seq_skip")
        state = self._actor_callers.setdefault(
            payload["caller_id"], {"next_seq": 0, "buffer": {}})
        seq = payload["seq"]
        if seq >= state["next_seq"] and seq not in state["buffer"]:
            state["buffer"][seq] = None
        self._drain_actor_queue(state)
        return {"ok": True}

    # ---------- actors: caller side ----------

    def create_actor(self, spec: TaskSpec, *, name: str, namespace: str,
                     class_name: str, detached: bool, get_if_exists: bool = False):
        return self._run(self.gcs.call("RegisterActor", {
            "actor_id": spec.actor_id,
            "job_id": self.job_id,
            "spec": spec.to_wire(),
            "name": name, "namespace": namespace,
            "class_name": class_name,
            "resources": spec.resources,
            "max_restarts": spec.max_restarts,
            "detached": detached,
            "get_if_exists": get_if_exists,
            "owner": self.address.to_wire(),
            "strategy": spec.strategy,
            "placement_group": spec.placement_group,
            "pg_bundle_index": spec.pg_bundle_index,
        }))

    async def _on_gcs_publish(self, conn, payload):
        if payload.get("channel") == "LOGS":
            # Worker stdout/stderr streamed to the driver (reference:
            # log_monitor lines are printed with (pid=..., ip=...) prefixes).
            msg = payload["message"]
            prefix = f"(pid={msg.get('pid')}, node={msg.get('node_id', '')[:8]})"
            for line in msg.get("lines", []):
                print(f"{prefix} {line}", flush=True)
            return
        if payload.get("channel") == "PG":
            msg = payload["message"]
            if msg.get("state") in ("CREATED", "REMOVED"):
                self._settle_pg_waiters(msg["pg_id"], msg["state"])
            return
        if payload.get("channel") == "NODE":
            # Node state transitions (alive/draining/drained/dead) fanned
            # out to interested owners — the elastic trainer's pre-death
            # signal. Listener errors must never poison the GCS conn.
            msg = payload["message"]
            for fn in list(self._node_event_listeners):
                try:
                    fn(msg)
                except Exception:
                    logger.exception("node event listener failed")
            return
        if payload.get("channel") != "ACTOR":
            return
        msg = payload["message"]
        st = self.actor_handles_state.get(msg["actor_id"])
        if st is None:
            return
        if msg["state"] == "ALIVE":
            self._note_actor_incarnation(st, msg.get("restarts", 0))
            st["address"] = msg["address"]
            self._drop_actor_conn(st)
            ev = st.get("alive_event")
            if ev:
                ev.set()
        elif msg["state"] in ("DEAD", "RESTARTING"):
            st["address"] = None
            self._drop_actor_conn(st)
            if msg["state"] == "DEAD":
                st["dead"] = True
                st["death_reason"] = msg.get("reason", "")
                ev = st.get("alive_event")
                if ev:
                    ev.set()

    def _drop_actor_conn(self, st) -> None:
        """Retire a handle's cached conn on an actor state change. Just
        nulling the slot leaked the conn's PENDING recv task as a
        garbage cycle — 'Task was destroyed but it is pending!' when the
        state publish beat the socket EOF (the r4 ES-test teardown
        flake); close() cancels and awaits it. The close task itself is
        strongly held (the loop keeps tasks weakly)."""
        old = st.get("conn")
        st["conn"] = None
        if old is not None and not old.closed:
            supervised_task(old.close(), name="retire-actor-conn",
                            tasks=self._bg_tasks)

    def _actor_state(self, actor_id: str):
        st = self.actor_handles_state.get(actor_id)
        if st is None:
            st = self.actor_handles_state[actor_id] = {
                "address": None, "conn": None, "seq": 0, "dead": False,
                "death_reason": "", "alive_event": None,
                "incarnation": 0, "inflight": []}
            # Pool workers subscribe to ACTOR state lazily, on their
            # FIRST actor handle: an eager per-worker subscription made
            # every ActorReady publish fan out to all ~N already-started
            # workers — O(N^2) notifies during an actor-creation burst
            # (the r4 many_actors ceiling had 160k of them at N=400).
            if "ACTOR" not in self._gcs_channels:
                self._gcs_channels.append("ACTOR")
                self._spawn(self._subscribe_channel("ACTOR"))
        return st

    async def _subscribe_channel(self, channel: str):
        try:
            await self.gcs.call("Subscribe", {"channels": [channel]})
        except Exception:
            # Reconnect resubscribes _gcs_channels; a failure here means
            # the GCS conn is already cycling.
            pass

    def add_node_event_listener(self, fn) -> None:
        """Subscribe `fn(msg)` to GCS NODE state transitions
        ({"event": "alive"|"draining"|"drained"|"dead", ...}). The NODE
        channel is joined lazily on the first listener (same pattern as
        the per-handle ACTOR subscription) and resubscribed across GCS
        reconnects via _gcs_channels."""
        self._node_event_listeners.append(fn)
        if "NODE" not in self._gcs_channels:
            self._gcs_channels.append("NODE")
            self._spawn(self._subscribe_channel("NODE"))

    def remove_node_event_listener(self, fn) -> None:
        try:
            self._node_event_listeners.remove(fn)
        except ValueError:
            pass

    def add_drain_notice_listener(self, fn) -> None:
        """Subscribe `fn(payload)` to this node's own drain notice (the
        raylet fans DrainNotice to its workers at the top of
        _run_drain) — lets in-process sessions park themselves even if
        the GCS publish to their owner is still in flight."""
        self._drain_notice_listeners.append(fn)

    async def _handle_drain_notice(self, conn, payload):
        for fn in list(self._drain_notice_listeners):
            try:
                fn(payload)
            except Exception:
                logger.exception("drain notice listener failed")
        return {"ok": True}

    @staticmethod
    def _note_actor_incarnation(st, restarts: int):
        """A restarted actor process has fresh per-caller ordering state, so
        the caller's sequence numbers restart from 0 for the new
        incarnation (otherwise the new process would buffer forever
        waiting for seq 0).  All in-flight tasks are renumbered HERE, in
        original submission order — renumbering lazily in each send
        coroutine would assign new seq-nos in wake order and could invert
        per-caller ordering across the restart."""
        if restarts != st.get("incarnation", 0):
            st["incarnation"] = restarts
            st["seq"] = 0
            for spec in st.get("inflight", []):
                spec.actor_seq = st["seq"]
                st["seq"] += 1
                spec.actor_incarnation = restarts

    def submit_actor_task(self, actor_id: str, spec: TaskSpec,
                          max_task_retries: int = 0,
                          nested_args: list | None = None):
        """Submit an actor method call. Fixed-arity calls return the
        return ObjectIDs; streaming calls (num_returns=-1) return the
        yield queue for the caller-side ObjectRefGenerator (reference:
        actor-method streaming generators)."""
        st = self._actor_state(actor_id)
        if nested_args:
            self._actor_task_nested[spec.task_id] = nested_args
        spec.actor_seq = st["seq"]
        spec.actor_incarnation = st["incarnation"]
        st["seq"] += 1
        st["inflight"].append(spec)
        self._record_task_event(spec.task_id, spec.name, "SUBMITTED")
        stream_q = None
        if spec.num_returns == STREAMING_RETURNS:
            # Register the pending entry BEFORE the call goes out so
            # mid-call TaskYield notifies find their queue; completion
            # pops it (same lifecycle as plain streamed tasks).
            pt = _PendingTask(spec, 0)
            pt.stream_q = stream_q = _queue.Queue()
            pt.return_hexes = []
            self._stream_queues[spec.task_id] = stream_q
            self.pending_tasks[spec.task_id] = pt
            returns = []
        else:
            returns = [ObjectID.for_task_return(
                TaskID.from_hex(spec.task_id), i + 1)
                for i in range(spec.num_returns)]
            for oid in returns:
                self.objects.setdefault(oid.hex(), _OwnedObject())
        self._spawn(self._submit_actor_task_async(actor_id, spec, max_task_retries))
        return stream_q if stream_q is not None else returns

    async def _actor_conn(self, actor_id: str, st) -> rpc.Connection:
        while True:
            if st["dead"]:
                raise exc.ActorDiedError(
                    f"actor {actor_id[:8]} is dead: {st['death_reason']}")
            if st["address"] is None:
                resp = await self.gcs.call("GetActorInfo", {"actor_id": actor_id})
                if not resp.get("found"):
                    raise exc.ActorDiedError(f"actor {actor_id[:8]} not found")
                if resp["state"] == "ALIVE":
                    self._note_actor_incarnation(st, resp.get("restarts", 0))
                    st["address"] = resp["address"]
                elif resp["state"] == "DEAD":
                    st["dead"] = True
                    st["death_reason"] = resp.get("death_cause") or ""
                    continue
                else:
                    if st["alive_event"] is None:
                        st["alive_event"] = asyncio.Event()
                    st["alive_event"].clear()
                    try:
                        await asyncio.wait_for(st["alive_event"].wait(), 1.0)
                    except asyncio.TimeoutError:
                        pass
                    continue
            if st["conn"] is None or st["conn"].closed:
                # Serialize connects: concurrent submits racing here would
                # each open a connection and overwrite st["conn"], leaking
                # the losers' sockets + recv tasks ("Task was destroyed
                # but it is pending!" mid-run).
                lock = st.get("conn_lock")
                if lock is None:
                    lock = st["conn_lock"] = asyncio.Lock()
                async with lock:
                    if st["dead"] or st["address"] is None:
                        continue   # state changed while waiting; re-resolve
                    if st["conn"] is None or st["conn"].closed:
                        addr = Address.from_wire(st["address"])
                        # dial, not a session: this conn's death is the
                        # signal to re-resolve the actor's address from
                        # the GCS (it may have restarted elsewhere).
                        st["conn"] = await rpc.dial(
                            addr.host, addr.port,
                            # Streaming actor methods push their yields
                            # back over this same ordered connection.
                            handlers={"TaskYield": self._handle_task_yield},
                            name=f"->actor{actor_id[:6]}",
                            timeout=self.config.rpc_connect_timeout_s)
            if st["conn"] is None or st["conn"].closed:
                continue
            return st["conn"]

    async def _submit_actor_task_async(self, actor_id: str, spec: TaskSpec,
                                       max_task_retries: int):
        attempts = max_task_retries + 1
        last_reason = ""
        st = self._actor_state(actor_id)
        try:
            for _ in range(max(1, attempts)):
                conn = None
                try:
                    conn = await self._actor_conn(actor_id, st)
                    self._record_task_event(spec.task_id, spec.name,
                                            "DISPATCHED")
                    resp = await conn.call("ActorCall", {
                        "spec": spec.to_wire(), "caller_id": self.worker_id},
                        timeout=None)
                    # Streaming calls pre-registered their pending entry
                    # (carrying the yield queue); reuse it so completion
                    # closes the stream.
                    pt = self.pending_tasks.get(spec.task_id)
                    if pt is None:
                        pt = _PendingTask(spec, 0)
                    pt.nested_args = self._actor_task_nested.pop(
                        spec.task_id, None) or []
                    actor_wid = (Address.from_wire(st["address"]).worker_id
                                 if st.get("address") else "")
                    await self._complete_task(pt, resp, "",
                                              borrower_id=actor_wid,
                                              borrower_addr=st.get("address"))
                    return
                except exc.ActorDiedError as e:
                    last_reason = str(e)
                    break
                except (rpc.RpcError, OSError, asyncio.TimeoutError) as e:
                    last_reason = str(e)
                    # Never close the SHARED conn here — other submits
                    # may have calls in flight on it. Drop the cache
                    # entry only when the transport actually died, and
                    # only if it still holds the conn THIS call used (a
                    # concurrent submit may have reconnected already).
                    if conn is None:
                        st["address"] = None       # connect failed: re-resolve
                    elif conn.closed and st["conn"] is conn:
                        st["conn"] = None
                        st["address"] = None
                    await asyncio.sleep(0.2)
                    continue
            err = serialization.serialize_exception(
                exc.ActorDiedError(f"actor task {spec.name} failed: {last_reason}"))
            pt = self.pending_tasks.get(spec.task_id)
            if pt is None:
                pt = _PendingTask(spec, 0)
            pt.nested_args = self._actor_task_nested.pop(
                spec.task_id, None) or []
            self._complete_task_error(pt, err)
            # This task holds a seq-no under the current incarnation that
            # will never be sent; tell the actor to skip it, or every later
            # task from this caller stalls in the ordered queue.
            if not st["dead"] and \
                    getattr(spec, "actor_incarnation", 0) == st["incarnation"]:
                try:
                    conn = await asyncio.wait_for(
                        self._actor_conn(actor_id, st), timeout=10)
                    await conn.call("ActorSeqSkip", {
                        "caller_id": self.worker_id,
                        "seq": spec.actor_seq})
                except Exception:
                    pass
        finally:
            try:
                st["inflight"].remove(spec)
            except ValueError:
                pass

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        st = self._actor_state(actor_id)
        st["dead"] = st["dead"] or no_restart
        return self._run(self.gcs.call("KillActor", {
            "actor_id": actor_id, "no_restart": no_restart}))


def _has_buffers(meta: bytes) -> bool:
    from ray_tpu_torch._vendor import msgpack

    try:
        _, _, offsets = msgpack.unpackb(meta)
        return bool(offsets)
    except Exception:
        return False


# ---------------- pool worker process entrypoint ----------------


def main():
    logging.basicConfig(level=logging.INFO,
                        format="[worker] %(asctime)s %(levelname)s %(message)s")
    env = os.environ
    from ray_tpu_torch.util import tracing

    tracing.maybe_setup_from_env()
    config = None
    if env.get("RAY_TPU_TORCH_CONFIG_JSON"):
        try:
            config = Config.from_json(env["RAY_TPU_TORCH_CONFIG_JSON"])
        except Exception:
            logging.getLogger(__name__).warning(
                "bad RAY_TPU_TORCH_CONFIG_JSON; using defaults", exc_info=True)
    cw = CoreWorker(
        gcs_host=env["RAY_TPU_TORCH_GCS_HOST"], gcs_port=int(env["RAY_TPU_TORCH_GCS_PORT"]),
        raylet_host=env["RAY_TPU_TORCH_RAYLET_HOST"],
        raylet_port=int(env["RAY_TPU_TORCH_RAYLET_PORT"]),
        store_path=env["RAY_TPU_TORCH_STORE_PATH"], node_id=env["RAY_TPU_TORCH_NODE_ID"],
        is_driver=False, worker_id=env["RAY_TPU_TORCH_WORKER_ID"], config=config)
    # Make the worker's core worker available to executing user code
    # (ray_tpu_torch.get/put/remote work inside tasks).
    from ray_tpu_torch._private import api_internal

    api_internal.set_core_worker(cw)
    try:
        cw.execution_loop()
    finally:
        cw.shutdown()


if __name__ == "__main__":
    main()
