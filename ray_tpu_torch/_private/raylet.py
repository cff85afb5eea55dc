"""Raylet: per-node daemon — worker pool, leases, local scheduling, object pulls.

Re-design of the reference's raylet (reference: src/ray/raylet/raylet.h:37,
node_manager.cc — lease handler at :1778 HandleRequestWorkerLease, PG
prepare/commit at :1832/:1848, drain at :1940; worker_pool.cc — runtime-env
keyed worker cache + prestart; local_task_manager.cc; and the object-manager
pull/push path, src/ray/object_manager/pull_manager.h:52 / push_manager.h:30).

One asyncio process per node:
- owns the node's shm object-store arena (creates it at startup)
- spawns/recycles worker processes; grants worker *leases* to task owners,
  who then push tasks directly to the leased worker (the reference's
  direct task transport — the raylet never sits in the data path)
- two-level scheduling: grants locally when resources fit, otherwise answers
  with a spillback hint from the GCS-fed cluster view (reference:
  raylet/scheduling/policy/hybrid_scheduling_policy.h top-k policy)
- placement-group bundle reservation (prepare/commit) with dedicated pools
- serves object chunks to peer raylets and pulls remote objects into the
  local store on behalf of its workers (5 MiB chunks, reference:
  ray_config_def.h:355)
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import signal
import subprocess
import sys
import time
from collections import deque

from ray_tpu_torch._private import accelerator, rpc
from ray_tpu_torch._private.common import (_maybe_attach_daemon_profiler,
                                           loaded_packages,
                                           normalize_resources,
                                           require_fields, resources_fit,
                                           supervised_task)
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreClient, ObjectStoreFullError

logger = logging.getLogger(__name__)

# EV_INJECT token the native lease plane stamps on its mirror events
# (arrives in the conn_id slot; see fast_rpc.FastRpcServer.inject_handler).
_LEASE_PLANE_TOKEN = 2


class _GateDeque(deque):
    """pending_leases with a change hook: the native lease plane's FIFO
    fairness gate must close the instant anything queues (a fresh request
    granted natively ahead of the queue would reintroduce the
    grant/return carousel starvation) and reopen when it drains."""

    def __init__(self, on_change):
        super().__init__()
        self._on_change = on_change

    def append(self, item):
        super().append(item)
        self._on_change()

    def appendleft(self, item):
        super().appendleft(item)
        self._on_change()

    def popleft(self):
        item = super().popleft()
        self._on_change()
        return item

    def pop(self):
        item = super().pop()
        self._on_change()
        return item

    def remove(self, item):
        super().remove(item)
        self._on_change()

    def clear(self):
        super().clear()
        self._on_change()


def _cgroup_memory_fraction() -> float:
    """Usage fraction of the enclosing cgroup limit (v2 then v1), or 0.0
    when unlimited/unavailable. Containers hit their cgroup limit long
    before the host's (reference: memory_monitor reads cgroup usage)."""
    for usage_p, limit_p in (
        ("/sys/fs/cgroup/memory.current", "/sys/fs/cgroup/memory.max"),
        ("/sys/fs/cgroup/memory/memory.usage_in_bytes",
         "/sys/fs/cgroup/memory/memory.limit_in_bytes"),
    ):
        try:
            with open(limit_p) as f:
                limit_s = f.read().strip()
            if limit_s == "max":
                continue
            limit = int(limit_s)
            if limit <= 0 or limit > 1 << 60:  # effectively unlimited
                continue
            with open(usage_p) as f:
                usage = int(f.read().strip())
            return usage / limit
        except (OSError, ValueError):
            continue
    return 0.0


def system_memory_fraction() -> float:
    """Used fraction of available memory: the tighter of the host
    (/proc/meminfo, reference: memory_monitor.h:52) and the enclosing
    cgroup limit."""
    host = 0.0
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                info[key] = int(val.strip().split()[0]) * 1024
        total = info["MemTotal"]
        avail = info.get("MemAvailable", info.get("MemFree", 0))
        host = (total - avail) / max(total, 1)
    except Exception:
        pass
    return max(host, _cgroup_memory_fraction())


def pick_oom_victim(workers) -> "WorkerHandle | None":
    """Worker-killing policy: newest-leased task worker first (its task is
    retriable and lost the least progress — reference retriable-FIFO policy,
    worker_killing_policy.h retriable_fifo); actors only as a last resort
    (restart costs more), newest first."""
    tasks = [w for w in workers
             if w.leased and w.actor_id is None and not w.dead]
    if tasks:
        return max(tasks, key=lambda w: w.leased_at)
    actors = [w for w in workers if w.actor_id is not None and not w.dead]
    if actors:
        return max(actors, key=lambda w: w.leased_at)
    return None


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, worker_id: str):
        self.proc = proc
        self.worker_id = worker_id
        self.conn: rpc.Connection | None = None   # worker -> raylet channel
        self.address: tuple[str, int] | None = None  # worker's own rpc server
        self.fp_port = 0  # native fastpath listener (0 = asyncio only)
        # Spawned on behalf of a specific in-flight grant: must NOT enter
        # the idle pool at registration, or a concurrent grant pops it
        # and the same process gets assigned twice (double AssignActor =
        # the second actor's calls stall in its ordered queues).
        self.reserved = False
        # CUDA_VISIBLE_DEVICES the worker was last told to pin ("" at
        # spawn: accelerator.worker_env).
        self.device_pin = ""
        self.registered = asyncio.Event()
        self.leased = False
        self.lease_id: str | None = None
        self.lease_resources: dict = {}
        self.lease_pg: tuple[str, int] | None = None
        self.blocked = False  # in ray.get: CPU returned to the pool
        self.actor_id: str | None = None
        self.idle_since = time.monotonic()
        self.leased_at = 0.0
        self.dead = False


class _PendingProc:
    """Placeholder while a worker materializes asynchronously (zygote
    warm-up / fork in flight): reads as alive, remembers a kill."""

    pid = 0
    returncode = None

    def __init__(self):
        self.kill_requested = False

    def poll(self):
        return None

    def kill(self):
        self.kill_requested = True


class _PidProc:
    """Popen-shaped handle for a zygote-forked worker. The raylet is not
    its parent (the zygote reaps it), so liveness is signal-0."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode = None

    def poll(self):
        if self.returncode is None:
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                self.returncode = -1
            except PermissionError:
                pass
        return self.returncode

    def kill(self):
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class _ZygoteClient:
    """Client side of the fork-server worker factory
    (_private/worker_zygote.py), pure asyncio and PIPELINED: spawn
    requests go out immediately and the newline-framed replies resolve
    FIFO futures from one reader task. The old sync client held a lock
    across each ~10-25ms fork round-trip, serializing every worker
    bring-up behind it (the r4 many_actors ceiling); responses are
    strictly ordered on the one socket, so pipelining needs no request
    ids."""

    def __init__(self, session_dir: str, node_id: str):
        self.sock_path = os.path.join(session_dir,
                                      f"zygote-{node_id[:8]}.sock")
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ZYGOTE_SOCKET"] = self.sock_path
        env["PYTHONUNBUFFERED"] = "1"
        log_path = os.path.join(session_dir, "logs",
                                f"zygote-{node_id[:8]}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        with open(log_path, "ab") as log_file:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.worker_zygote"],
                env=env, stdout=log_file, stderr=subprocess.STDOUT,
                start_new_session=True)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: deque[asyncio.Future] = deque()
        self._reader_task: asyncio.Task | None = None
        self._connect_lock = asyncio.Lock()

    async def connect(self, timeout: float = 0.2) -> bool:
        """True once the zygote accepted our control connection. Guarded:
        concurrent callers after a dropped conn would otherwise open
        parallel sockets and stack two read loops on one reader."""
        if self._writer is not None:
            return True
        if self.proc.poll() is not None:
            return False
        async with self._connect_lock:
            if self._writer is not None:
                return True
            try:
                self._reader, self._writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(self.sock_path), timeout)
            except (OSError, asyncio.TimeoutError):
                return False
            self._reader_task = supervised_task(self._read_loop(),
                                                name="zygote-read-loop")
            return True

    async def _read_loop(self):
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                fut = self._pending.popleft() if self._pending else None
                if fut is not None and not fut.done():
                    fut.set_result(json.loads(line))
        except (OSError, ValueError, asyncio.CancelledError):
            pass
        finally:
            self._fail_pending()

    def _fail_pending(self):
        while self._pending:
            fut = self._pending.popleft()
            if not fut.done():
                fut.set_result(None)

    async def spawn(self, env: dict, log_path: str,
                    timeout: float = 10.0) -> int | None:
        """Fork a worker; returns its pid, or None (caller cold-spawns).
        Concurrent callers pipeline on the socket instead of queueing."""
        try:
            if not await self.connect(min(timeout, 0.5)):
                return None
            fut = asyncio.get_running_loop().create_future()
            self._pending.append(fut)
            self._writer.write((json.dumps(
                {"env": env, "log_path": log_path}) + "\n").encode())
            await self._writer.drain()
            resp = await asyncio.wait_for(fut, timeout)
            if resp is None:
                raise OSError("zygote hung up")
            if "pid" not in resp:
                # Per-request failure (e.g. fork EAGAIN): the template
                # itself is fine, keep the connection.
                logger.warning("zygote spawn error: %s; cold-spawning",
                               resp.get("error"))
                return None
            return resp["pid"]
        except (OSError, ValueError, KeyError, asyncio.TimeoutError) as e:
            logger.warning("zygote spawn failed (%s); cold-spawning", e)
            await self._drop_conn()
            return None

    async def _drop_conn(self):
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reader_task = None
        if self._writer is not None:
            try:
                self._writer.close()
            except OSError:
                pass
            self._reader = self._writer = None
        self._fail_pending()

    async def aclose(self):
        await self._drop_conn()
        await asyncio.to_thread(self.close)  # proc.wait can block 2s

    def close(self):
        # SIGTERM first: the zygote's handler kills its forked workers
        # (they setsid'd, so killing the zygote alone leaks them), then a
        # hard kill as backstop.
        try:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                pass
        except Exception:
            pass
        try:
            self.proc.kill()
        except Exception:
            pass
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


class Raylet:
    def __init__(self, gcs_host: str, gcs_port: int, *,
                 resources: dict | None = None, labels: dict | None = None,
                 session_dir: str, node_id: str | None = None,
                 is_head: bool = False, config: Config | None = None):
        self.config = config or Config()
        self.gcs_host = gcs_host
        self.gcs_port = gcs_port
        self.node_id = node_id or NodeID.from_random().hex()
        self.is_head = is_head
        self.session_dir = session_dir
        self.labels = labels or {}
        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        # GPUs: counted without creating a CUDA context (this process
        # forks the zygote), honouring CUDA_VISIBLE_DEVICES.
        self._gpu_ids = accelerator.detect_gpu_ids()
        if "GPU" not in resources and self._gpu_ids:
            resources = {**resources, "GPU": float(len(self._gpu_ids))}
        self.total_resources = normalize_resources(resources)
        # ALL node-local accounting (resource pool, PG bundle pools,
        # lease records, blocked-worker credits, the GPU card free list)
        # lives in the native core (csrc/raylet_core.cc) — there is no
        # Python shadow copy.
        from ray_tpu_torch._private.native_raylet_core import RayletResourceCore

        self.rcore = RayletResourceCore(self.total_resources,
                                        gpu_ids=self._gpu_ids)
        # Arena on tmpfs when possible (reference: plasma allocates on
        # /dev/shm; a disk-backed mmap makes every put run at disk speed).
        store_dir = self.config.object_store_dir
        if not store_dir:
            # tmpfs must actually FIT the arena: a sparse file larger than
            # /dev/shm SIGBUSes on first write past capacity (containers
            # often cap /dev/shm at 64MB).
            arena_size = int(self.total_resources.get(
                "object_store_memory", self.config.object_store_memory))
            store_dir = session_dir
            try:
                if os.access("/dev/shm", os.W_OK):
                    st = os.statvfs("/dev/shm")
                    if st.f_bavail * st.f_frsize >= arena_size + (64 << 20):
                        store_dir = "/dev/shm"
            except OSError:
                pass
        self.store_path = os.path.join(store_dir,
                                       f"ray_tpu_torch-store-{self.node_id[:12]}")
        self.store: ObjectStoreClient | None = None
        self.workers: dict[str, WorkerHandle] = {}
        self._log_tails: dict[str, Raylet._LogTail] = {}
        self.idle_workers: deque[WorkerHandle] = deque()
        self.pending_leases: deque = _GateDeque(self._sync_lease_gate)
        # Per-job fair share (issue 20): the pump visits queued leases
        # round-robin across job ids (per-job FIFO within a lane), so one
        # tenant's burst cannot starve peers queued behind it. The
        # starvation counter records grants that sat queued past the
        # threshold — 0 is the multi-tenant release-gate invariant.
        self._lease_rr_last: str = ""
        self._lease_starvation = 0
        self._lease_grants_by_job: dict[str, int] = {}
        self._starvation_threshold_s = float(
            os.environ.get("RAY_TPU_TORCH_LEASE_STARVATION_S", "5.0"))
        self.cluster_view: dict = {}
        self.gcs_conn: rpc.Connection | None = None
        # Native-pump server when available (csrc/fastpath.cc): the
        # lease/return/pin cycle's accept/framing/writev all ride the C++
        # epoll thread (reference: node_manager.cc:1778 handles leases on
        # a C++ asio loop); Python keeps only the protocol logic.
        from ray_tpu_torch._private.fast_rpc import make_server

        self.server = make_server(self._handlers(),
                                  name=f"raylet-{self.node_id[:8]}")
        # Native lease plane (csrc/raylet_lease.cc, RAY_TPU_TORCH_NATIVE_CONTROL=1):
        # simple-shape RequestWorkerLease grants and native-lease returns
        # run on the pump thread against the SAME rcore; Python mirrors
        # bookkeeping off EV_INJECT events and arbitrates worker identity
        # through the plane's pool (push/claim). Installed by
        # _native_service_factory at server start.
        self._lease_plane = None
        from ray_tpu_torch._private.fast_rpc import FastRpcServer

        if isinstance(self.server, FastRpcServer):
            self.server.service_factory = self._native_service_factory
        self.host = "127.0.0.1"
        self.port: int | None = None
        self.draining = False
        # Drain/evacuation state (reference: node_manager.cc
        # HandleDrainRaylet, grown into a full evacuation pipeline —
        # see _run_drain). drain_done fires once DrainComplete reported.
        self.drain_reason = ""
        self.drain_deadline_s = 0.0
        # Absolute (monotonic) evacuation cutoff; a superseding, more
        # urgent DrainNode tightens it mid-pipeline (handle_drain).
        self._drain_deadline_mono = float("inf")
        self._drain_task: asyncio.Task | None = None
        self._drain_stats: dict = {}
        self._drain_done = asyncio.Event()
        self._peer_conns: dict[tuple[str, int], rpc.Connection] = {}
        self._pull_locks: dict[str, asyncio.Lock] = {}
        # Objects this raylet PULLED from peers (secondary copies),
        # oid_hex -> source node id: the drain evacuation pushes
        # primaries first — the bounded window must not be spent
        # re-shipping redundant copies while an object whose only copy
        # lives here waits its turn. An entry only counts as secondary
        # while its source node is still alive (rolling preemptions
        # promote relocated copies to primaries).
        self._pulled_copies: dict[str, str] = {}
        self._tasks: list[asyncio.Task] = []
        # Divergence breaker bookkeeping (mirrors gcs.py): a tripped
        # breaker degrades the plane's owned methods to Python for the
        # life of the process.
        self._native_degraded_reason = ""
        self._native_divergence_trips = 0
        self._audit_proto_seen = 0
        self._lease_seq = 0
        self._num_leases_granted = 0
        # Completed (re-)registrations with the GCS: a restarted GCS shows
        # as one more (GetState "gcs_registrations").
        self._gcs_registrations = 0
        self._last_spawn_failure = "worker startup failed"
        # Recently-rejected infeasible demands, kept ~10s for the autoscaler.
        self._infeasible_demand: list[tuple[float, dict]] = []
        # Actor deaths observed while the GCS was unreachable; replayed
        # after reconnection (the snapshot restores such actors as ALIVE).
        self._pending_death_reports: list[dict] = []
        # Fork-server worker factory (started in start(); None = disabled).
        self._zygote: _ZygoteClient | None = None
        self._zygote_lock = asyncio.Lock()
        self._zygote_strikes = 0
        # Startup concurrency bound (reference: worker_pool.cc
        # maximum_startup_concurrency_): zygote spawns are pipelined, so
        # without a bound a 400-worker burst forks 400 children that ALL
        # initialize at once — every registration then completes at the
        # END of the convoy and creation RPC timeouts fire. Hold a slot
        # from fork until the worker registers (or dies) so a bounded
        # cohort initializes at a time. Sized 4x CPUs (min 32): worker
        # init is IO-heavy (connects/registration round trips), so
        # cohorts several times the core count still converge fast, and
        # a burst at typical pool sizes (~30) isn't serialized at all.
        self._spawn_slots = asyncio.Semaphore(
            max(32, 4 * int(self.total_resources.get("CPU", 4))))
        # Native C++ scheduling core mirrors the GCS-fed cluster view for
        # spillback decisions (csrc/scheduler.cc; the Python policy runs
        # only with RAY_TPU_TORCH_NATIVE_CONTROL=0).
        from ray_tpu_torch._private import native_scheduler

        self._native_sched = None
        self._native_known: set[str] = set()
        if native_scheduler.available():
            self._native_sched = native_scheduler.ClusterScheduler()

    def _handlers(self):
        return {
            # worker-facing
            "RegisterWorker": self.handle_register_worker,
            "RequestWorkerLease": self.handle_request_worker_lease,
            "ReturnWorker": self.handle_return_worker,
            "PullObject": self.handle_pull_object,
            "FreeObjects": self.handle_free_objects,
            "MakeRoom": self.handle_make_room,
            "EnsureRuntimeEnv": self.handle_ensure_runtime_env,
            "NodeStoreInfo": self.handle_node_store_info,
            "WorkerBlocked": self.handle_worker_blocked,
            "WorkerUnblocked": self.handle_worker_unblocked,
            # peer-raylet-facing
            "FetchChunk": self.handle_fetch_chunk,
            # gcs-facing
            "CreateActor": self.handle_create_actor,
            "KillActorWorker": self.handle_kill_actor_worker,
            "PreparePGBundle": self.handle_prepare_pg_bundle,
            "CommitPGBundle": self.handle_commit_pg_bundle,
            "ReturnPGBundle": self.handle_return_pg_bundle,
            "Drain": self.handle_drain,
            "GetState": self.handle_get_state,
            "GetEventLoopStats": self.handle_get_event_loop_stats,
            "NodeStacks": self.handle_node_stacks,
            "NodeDebugTasks": self.handle_node_debug_tasks,
            "NodeProfile": self.handle_node_profile,
            "ListLogs": self.handle_list_logs,
            "TailLog": self.handle_tail_log,
            "WorkerStats": self.handle_worker_stats,
            "NodeDeviceObjects": self.handle_node_device_objects,
        }

    # ---------- native lease plane ----------

    def _native_service_factory(self, pump):
        """Install the native lease plane into the raylet pump (called
        by FastRpcServer.start between pump creation and listen). With
        RAY_TPU_TORCH_NATIVE_CONTROL=0 the Python lease handlers answer
        every lease. A plane that fails to install raises, after the
        half-constructed plane is destroyed (never left installed)."""
        from ray_tpu_torch._private import native_lease_plane

        if not native_lease_plane.available():
            return None
        plane = None
        try:
            plane = native_lease_plane.RayletLeasePlane(
                pump, inject_token=_LEASE_PLANE_TOKEN, rcore=self.rcore)
            plane.set_node(self.node_id)
            # Restart handshake: stamp the server incarnation epoch so a
            # stamped request replayed from before a raylet restart (its
            # reply cache died with the process) is rejected as stale
            # instead of silently re-executed (a replayed CreateActor
            # re-run would fork the actor).
            plane.set_epoch(rpc._server_sessions.epoch)
            if self.draining:
                plane.set_draining(True)
                plane.set_node_state(2)  # native_policy.NODE_DRAINING
            # Replay the live lease ledger: any natively-granted lease
            # already in the worker mirror (no-op at boot; keeps the
            # plane's ReturnWorker ownership exact if the factory ever
            # runs against live state).
            native_prefix = f"{self.node_id[:8]}-n"
            for w in self.workers.values():
                if w.leased and (w.lease_id or "").startswith(
                        native_prefix):
                    plane.restore_lease(w.lease_id, w.worker_id)
            # install() is the LAST step: a half-wired plane must never
            # answer frames (close-on-failure below stays safe because
            # the pump hook was never pointed at it).
            plane.install()
            self.server.inject_handler = self._on_native_inject
            self._lease_plane = plane
            logger.info("native lease plane active (grant/return in-pump)")
            return plane
        except Exception:
            logger.exception("native lease plane failed to install")
            if plane is not None:
                try:
                    plane.close()
                except Exception:
                    logger.exception("native lease plane close failed")
            raise

    def _sync_lease_gate(self):
        plane = getattr(self, "_lease_plane", None)
        if plane is not None:
            plane.set_gate(not self.pending_leases)

    def _pool_worker(self, w: WorkerHandle) -> None:
        """Land a worker in the idle pool — and mirror it into the
        native plane's grant pool. Every idle_workers entry must exist
        in the mirror, or the claim arbitration in _take_idle_worker
        would treat it as natively-granted and skip it forever. A worker
        that held a card stays out of the mirror: the plane grants only
        CPU leases, and such a worker serves only leases of its cards."""
        w.idle_since = time.monotonic()
        self.idle_workers.append(w)
        if self._lease_plane is not None and not w.device_pin:
            self._lease_plane.push(w.worker_id, w.address[0],
                                   w.address[1], getattr(w, "fp_port", 0))

    def _take_idle_worker(self, visible: str = "") -> WorkerHandle | None:
        """An idle worker for a lease whose cards are `visible`
        (CUDA_VISIBLE_DEVICES form): one already pinned to them, else one
        that never held a card. A worker that held other cards may have
        initialised CUDA over them and could not switch (it would fail
        the task and exit), so it stays idle for a lease like its last.

        Only workers that never held a card are in the native plane's
        pool (_pool_worker), and claim() is the arbitration point with
        the pump thread: such a worker the plane already granted fails
        the claim and is skipped (its lease_granted event is in
        flight)."""
        if visible:
            for w in self.idle_workers:
                if w.device_pin == visible:
                    self.idle_workers.remove(w)
                    return w
        for w in list(self.idle_workers):
            if w.device_pin:
                continue
            self.idle_workers.remove(w)
            if not self._claim(w):
                continue
            return w
        return None

    def _claim(self, w: WorkerHandle) -> bool:
        """Take an idle worker out of the native plane's pool; False if
        the plane granted it first. A worker that held a card was never
        pooled there (_pool_worker): Python owns it."""
        return (self._lease_plane is None or bool(w.device_pin)
                or self._lease_plane.claim(w.worker_id))

    def _unpool_worker(self, w: WorkerHandle) -> None:
        if self._lease_plane is not None:
            self._lease_plane.remove(w.worker_id)

    def _on_native_inject(self, token, body):
        if token != _LEASE_PLANE_TOKEN:
            return
        try:
            event, payload = rpc.unpack(body)
        except Exception:
            logger.exception("native lease plane: bad inject event")
            return
        w = self.workers.get(payload.get("worker_id", ""))
        if event == "lease_granted":
            self._num_leases_granted += 1
            if w is not None:
                try:
                    self.idle_workers.remove(w)
                except ValueError:
                    pass
                w.leased = True
                w.leased_at = time.monotonic()
                w.lease_id = payload["lease_id"]
                w.lease_resources = {}
                w.lease_pg = None
        elif event == "worker_returned":
            # The plane already released the rcore lease; only the
            # Python-side worker bookkeeping happens here.
            if w is not None:
                w.blocked = False
                w.leased = False
                w.lease_id = None
                w.lease_resources = {}
                w.lease_pg = None
                if payload.get("kill"):
                    self._kill_worker(w)
                else:
                    self._pool_worker(w)
            self._pump_pending_leases()

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = await self.server.start(host, port)
        os.makedirs(self.session_dir, exist_ok=True)
        from ray_tpu_torch.util import events

        events.configure(self.session_dir, f"raylet-{self.node_id[:8]}")
        events.record("INFO", "raylet", "node started",
                      node_id=self.node_id, resources=self.total_resources)
        # Fetch the cluster config BEFORE sizing the arena: store size and
        # spill backend are config-driven, and the later RegisterNode
        # response arrives only after the store must already exist
        # (reference: raylets load the system config from the GCS at boot,
        # node_manager.cc HandleGetSystemConfig).
        try:
            boot = await rpc.dial(
                self.gcs_host, self.gcs_port, name="raylet-boot->gcs",
                timeout=self.config.rpc_connect_timeout_s)
            resp = await boot.call("GetConfig", {}, timeout=10)
            if resp.get("config"):
                self.config = Config.from_json(resp["config"])
            await boot.close()
        except Exception:
            logger.warning("config fetch from GCS failed; using defaults",
                           exc_info=True)
        if self.config.use_worker_zygote:
            # Started only after the GCS config lands (a cluster-level
            # use_worker_zygote=false must actually disable it); still
            # eager relative to leases, so the template's heavy imports
            # overlap the rest of cluster bring-up.
            try:
                self._zygote = _ZygoteClient(self.session_dir, self.node_id)
            except OSError as e:
                logger.warning("zygote unavailable (%s); workers will "
                               "cold-spawn", e)
        self.store = ObjectStoreClient(
            self.store_path, create=True,
            size=int(self.total_resources.get(
                "object_store_memory", self.config.object_store_memory)),
            table_capacity=self.config.object_store_table_capacity)
        # Spilling: the raylet (not the store) handles memory pressure —
        # idle objects go to disk and restore on demand (reference:
        # local_object_manager.h:110 SpillObjects / :122 restore).
        self.store.set_auto_evict(False)
        self.spill_dir = os.path.join(self.session_dir,
                                      f"spilled-{self.node_id[:12]}")
        # External spill backend (reference: external_storage.py:72):
        # object_spilling_uri routes spills to a URI store instead of the
        # node-local dir; entries in self.spilled then hold full URIs.
        self._ext_storage = None
        if self.config.object_spilling_uri:
            from ray_tpu_torch._private.external_storage import storage_for

            self._ext_storage = storage_for(self.config.object_spilling_uri)
        self.spilled: dict[str, tuple[str, int, int]] = {}  # oid -> (path, meta_size, size)
        self._spill_lock = asyncio.Lock()
        self._spilled_bytes = 0
        self._num_spilled = 0
        self._num_restored = 0
        # The GCS issues calls (CreateActor, PG prepare/commit, Drain) back
        # over this same connection, so it gets the full handler table.
        # A resilient session: socket death redials under
        # gcs_reconnect_timeout_s and re-runs _gcs_handshake (RegisterNode
        # + Subscribe + queued death reports) before any stamped call is
        # replayed — a flap is a non-event, not a raylet death.
        self.gcs_conn = await rpc.connect_session(
            self.gcs_host, self.gcs_port,
            handlers={**self._handlers(), "Publish": self._on_publish},
            name=f"raylet-{self.node_id[:8]}->gcs",
            grace_s=self.config.gcs_reconnect_timeout_s,
            connect_timeout_s=self.config.rpc_connect_timeout_s,
            on_reconnect=self._gcs_handshake)
        self.gcs_conn.on_close(self._on_gcs_session_failed)
        # Native data plane: serve this store's objects to peers from C++
        # (payload bytes never cross the Python daemons).
        from ray_tpu_torch._private.native_transfer import TransferServer

        self.transfer_server = TransferServer(self.store_path)
        resp = await self.gcs_conn.call("RegisterNode", {
            "node_id": self.node_id,
            "host": self.host,
            "raylet_port": self.port,
            "total_resources": self.total_resources,
            "labels": self.labels,
            "store_path": self.store_path,
            "is_head": self.is_head,
            "transfer_port": self.transfer_server.port,
        })
        if resp.get("config"):
            self.config = Config.from_json(resp["config"])
        await self.gcs_conn.call("Subscribe", {"channels": ["NODE", "JOB"]})
        # Node-side runtime-env provisioning (reference: per-node
        # RuntimeEnvAgent, agent_manager.cc): pip envs + package URIs,
        # cached per node, ref-counted per job, GC'd on job finish.
        from ray_tpu_torch._private.runtime_env_manager import RuntimeEnvManager

        async def _kv_get(ns, key):
            r = await self.gcs_conn.call(
                "KVGet", {"ns": ns, "key": key.encode()})
            return r.get("value")

        self.runtime_env_manager = RuntimeEnvManager(
            os.path.join(self.session_dir, f"node-{self.node_id[:8]}"),
            kv_get=_kv_get)
        self._tasks.append(supervised_task(self._heartbeat_loop(),
                                           name="heartbeat-loop"))
        self._tasks.append(supervised_task(self._reap_loop(),
                                           name="reap-loop"))
        if self._lease_plane is not None:
            self._tasks.append(supervised_task(
                self._native_audit_loop(), name="native-audit-loop"))
        self._tasks.append(supervised_task(self._log_tail_loop(),
                                           name="log-tail-loop"))
        if self.config.memory_usage_threshold > 0:
            self._tasks.append(supervised_task(self._memory_monitor_loop(),
                                               name="memory-monitor-loop"))
        # Prestart (reference: worker_pool.cc PrestartWorkers): warm the
        # pool concurrently with the rest of cluster bring-up — each
        # registration lands the worker in idle_workers and pumps leases.
        n_pre = self.config.prestart_workers
        if n_pre < 0:
            n_pre = int(self.total_resources.get("CPU", 0))
        # The reap loop trims idle workers above the soft limit — spawning
        # past it would pay the interpreter cost and be killed on arrival.
        for _ in range(min(n_pre, self._idle_soft_limit())):
            self._spawn_worker()
        logger.info("raylet %s on %s:%s resources=%s", self.node_id[:8], self.host,
                    self.port, self.total_resources)
        return self.host, self.port

    async def stop(self):
        for t in self._tasks:
            t.cancel()
        for w in list(self.workers.values()):
            self._kill_worker(w)
        if self._zygote is not None:
            zygote, self._zygote = self._zygote, None
            await zygote.aclose()
        if getattr(self, "transfer_server", None) is not None:
            await asyncio.to_thread(self.transfer_server.stop)
        # server.stop() joins the pump thread, then destroys the native
        # lease plane — which must precede rcore.close() below (the
        # plane books resources through rcore's entry points).
        self._lease_plane = None
        await self.server.stop()
        if self.gcs_conn:
            await self.gcs_conn.close()
        if self.store:
            self.store.close()
            # The arena may live on /dev/shm — unlink it so dead clusters
            # don't pin tmpfs memory.
            try:
                os.unlink(self.store_path)
            except OSError:
                pass
        self.rcore.close()

    async def _reconcile_actors(self, conn) -> None:
        """After an outage the GCS may have failed our actors over
        elsewhere (restored-node reaper). Kill any local actor worker the
        directory no longer maps to THIS worker — otherwise two live
        copies of a stateful actor serve callers (actor forking)."""
        for w in list(self.workers.values()):
            if not w.actor_id or w.dead:
                continue
            try:
                resp = await conn.call("GetActorInfo",
                                       {"actor_id": w.actor_id})
            except Exception:
                continue
            addr = resp.get("address") if resp.get("found") else None
            # Address wire = [host, port, worker_id, node_id]; the actor's
            # CoreWorker id equals our WorkerHandle id (set via env).
            ours = bool(addr) and addr[2] == w.worker_id
            if resp.get("found") and resp.get("state") == "ALIVE" and ours:
                continue
            logger.warning(
                "killing stale actor worker %s (actor %s now %s elsewhere)",
                w.worker_id[:8], w.actor_id[:8],
                resp.get("state", "unknown"))
            self._release_lease_resources(w)
            self._kill_worker(w)

    # ---------- gcs sync ----------

    async def _heartbeat_loop(self):
        period = min(0.2, self.config.health_check_period_s)
        # Fixed intervals synchronize across the fleet into periodic
        # heartbeat bursts (every raylet booted by the same autoscaler
        # wave ticks in phase), which at 256-node width turns into GCS
        # tick spikes. Seed per-node so the schedule is deterministic
        # for a given node id: a randomized initial phase de-correlates
        # boot waves, +-20% per-tick jitter keeps them de-correlated.
        hb_rng = random.Random(f"hb:{self.node_id}")
        await asyncio.sleep(hb_rng.uniform(0.0, period))
        while True:
            try:
                now = time.monotonic()
                self._infeasible_demand = [
                    (ts, d) for ts, d in self._infeasible_demand
                    if now - ts < 10.0]
                resp = await self.gcs_conn.call("Heartbeat", {
                    "node_id": self.node_id,
                    "available_resources": self.available,
                    # Demand signal for the autoscaler (reference: raylets
                    # report resource load via ray_syncer →
                    # gcs_autoscaler_state_manager).
                    "pending_demand": [item[0] for item in
                                       list(self.pending_leases)[:100]]
                    + [d for _ts, d in self._infeasible_demand],
                }, timeout=self.config.health_check_timeout_s)
                if resp.get("ok"):
                    self.cluster_view = resp.get("cluster", {})
                    self._sync_native_view()
                    # A fresher view may unblock queued leases via spillback.
                    self._pump_pending_leases()
                elif resp.get("reregister"):
                    # One-way partition: this side's socket looks healthy
                    # but the GCS-side conn died and marked the node
                    # SUSPECT. Re-run the handshake over the live session
                    # to rebind — do NOT exit; nothing was failed over.
                    logger.warning("GCS marked node %s SUSPECT; "
                                   "re-registering over live connection",
                                   self.node_id[:8])
                    await self._gcs_handshake(self.gcs_conn)
                else:
                    # A LIVE GCS answering not-ok has declared this node
                    # dead (SUSPECT grace expired / missed heartbeats) and
                    # may already have failed actors over; resurrecting
                    # would fork them. Exit like the reference's stale
                    # raylet. (A RESTARTED GCS is reached via the session
                    # reconnect + re-registration path instead.)
                    logger.error("GCS declared node %s dead; raylet exiting",
                                 self.node_id[:8])
                    os._exit(1)
            except (rpc.ConnectionLost, asyncio.TimeoutError) as e:
                # The resilient session redials and re-runs the handshake
                # underneath; heartbeats just resume when it's back. The
                # session's on_close (grace exhausted) is what exits.
                logger.debug("heartbeat deferred (%s); session redialing", e)
            except Exception:
                logger.debug("heartbeat error", exc_info=True)
            await asyncio.sleep(period * hb_rng.uniform(0.8, 1.2))

    async def _gcs_handshake(self, conn):
        """Re-attach this raylet to the GCS over a fresh (or live) conn:
        re-register under the SAME node id (leases, PG bundles, and the
        object store all survive in this process), re-subscribe, flush
        queued death reports, reconcile actor ground truth. Runs as the
        session's on_reconnect BEFORE any replayed request, so the GCS
        rebinds node_conns first (reference: NotifyGCSRestart resync,
        node_manager.cc:1168)."""
        resp = await conn.call("RegisterNode", {
            "node_id": self.node_id,
            "host": self.host,
            "raylet_port": self.port,
            "total_resources": self.total_resources,
            "labels": self.labels,
            "store_path": self.store_path,
            "is_head": self.is_head,
            "transfer_port": getattr(self, "transfer_server", None)
            and self.transfer_server.port or 0,
        }, timeout=self.config.rpc_call_timeout_s)
        if not resp.get("ok"):
            # Permanent rejection (the GCS knows this identity is dead):
            # a non-transient error fails the session -> _on_gcs_session_failed.
            raise rpc.RpcError(
                f"GCS refused re-registration: {resp.get('reason', resp)}")
        await conn.call("Subscribe", {"channels": ["NODE", "JOB"]})
        while self._pending_death_reports:
            report = self._pending_death_reports.pop(0)
            try:
                await conn.call("ReportActorDeath", report)
            except Exception:
                self._pending_death_reports.insert(0, report)
                break
        await self._reconcile_actors(conn)
        self._gcs_registrations += 1
        logger.info("raylet %s re-registered with GCS", self.node_id[:8])

    def _on_gcs_session_failed(self):
        logger.error("GCS unreachable for %.0fs; raylet %s exiting",
                     self.config.gcs_reconnect_timeout_s, self.node_id[:8])
        os._exit(1)

    async def handle_ensure_runtime_env(self, conn, payload):
        require_fields(payload, "env", method="handle_ensure_runtime_env")
        ctx = await self.runtime_env_manager.ensure(
            payload["env"], payload.get("job_id", ""))
        return ctx

    async def _on_publish(self, conn, payload):
        if payload.get("channel") == "JOB" \
                and payload["message"].get("event") == "finished":
            self.runtime_env_manager.release_job(payload["message"]["job_id"])
            return
        if payload.get("channel") == "NODE" and payload["message"].get("event") == "dead":
            # Drop cached peer connection to the dead node.
            msg = payload["message"]
            view = self.cluster_view.pop(msg.get("node_id", ""), None)
            if view:
                self._peer_conns.pop((view["host"], view["raylet_port"]), None)

    async def _reap_loop(self):
        """Detect worker process deaths (reference: raylet notices worker
        socket disconnects; here we poll the child PIDs)."""
        while True:
            await asyncio.sleep(0.1)
            now = time.monotonic()
            for w in list(self.workers.values()):
                if w.dead:
                    continue
                if w.proc.poll() is not None:
                    await self._on_worker_death(w, f"worker process exited "
                                                   f"with code {w.proc.returncode}")
            # Trim idle workers beyond the soft limit / idle timeout.
            # Not while draining: the evacuation pipeline is running.
            if self.draining:
                continue
            soft = self._idle_soft_limit()
            while len(self.idle_workers) > soft:
                w = self.idle_workers.popleft()
                if not self._claim(w):
                    continue  # native grant in flight: not actually idle
                self._kill_worker(w)
            for w in list(self.idle_workers):
                if now - w.idle_since > 60.0 and len(self.idle_workers) > 1:
                    self.idle_workers.remove(w)
                    if not self._claim(w):
                        continue
                    self._kill_worker(w)

    async def _memory_monitor_loop(self):
        """Kill a worker when system memory crosses the threshold
        (reference: memory_monitor.h:52 + worker_killing_policy.h:34; the
        owner retries the killed task, so pressure sheds instead of the
        kernel OOM-killer taking out the raylet)."""
        threshold = self.config.memory_usage_threshold
        last_kill = 0.0
        frac_at_last_kill = 0.0
        while True:
            await asyncio.sleep(self.config.memory_monitor_period_s)
            frac = system_memory_fraction()
            if frac < threshold:
                continue
            now = time.monotonic()
            # Cooldown + effectiveness check: give a kill 3 periods to
            # show up in the reading, and don't keep killing when the
            # pressure is external (usage not dropping because our workers
            # aren't the cause).
            if now - last_kill < 3 * self.config.memory_monitor_period_s:
                continue
            if last_kill and frac >= frac_at_last_kill - 0.005 and \
                    now - last_kill < 30 * self.config.memory_monitor_period_s:
                continue
            victim = pick_oom_victim(self.workers.values())
            if victim is None:
                continue
            last_kill = now
            frac_at_last_kill = frac
            logger.warning(
                "memory usage %.0f%% >= %.0f%%: killing worker %s "
                "(%s) to relieve pressure", frac * 100, threshold * 100,
                victim.worker_id[:8],
                f"actor {victim.actor_id[:8]}" if victim.actor_id
                else "retriable task")
            await self._on_worker_death(
                victim, f"killed by memory monitor at {frac:.0%} usage")
            self._kill_worker(victim)

    async def _on_worker_death(self, w: WorkerHandle, reason: str):
        from ray_tpu_torch.util import events

        events.record("WARNING" if w.leased or w.actor_id else "INFO",
                      "raylet", f"worker died: {reason}",
                      worker_id=w.worker_id, actor_id=w.actor_id)
        w.dead = True
        self.workers.pop(w.worker_id, None)
        self._unpool_worker(w)
        if w in self.idle_workers:
            self.idle_workers.remove(w)
        if w.leased:
            self._release_lease_resources(w)
        if w.actor_id:
            report = {"actor_id": w.actor_id, "reason": reason,
                      "worker_id": w.worker_id}
            try:
                await self.gcs_conn.call("ReportActorDeath", report)
            except Exception:
                # GCS down: queue it — a restarted GCS restores the actor
                # as ALIVE from its snapshot, so the death must be replayed
                # after reconnecting or the actor never recovers.
                self._pending_death_reports.append(report)
        logger.warning("worker %s died: %s", w.worker_id[:8], reason)
        self._pump_pending_leases()

    # ---------- worker pool ----------

    class _LogTail:
        __slots__ = ("w", "path", "pos", "carry", "next_poll", "interval")

        def __init__(self, w, path):
            self.w = w
            self.path = path
            self.pos = 0
            self.carry = b""  # partial trailing line from the last chunk
            self.next_poll = 0.0
            self.interval = 0.3

    async def _log_tail_loop(self):
        """ONE tail loop for every worker log, publishing appended lines
        to the GCS LOGS channel (reference: log_monitor.py tails per-pid
        worker logs and publishes via GCS pubsub). Per-worker tail TASKS
        (r4) cost 400 timers + 1.3k stat()s/s during a 400-actor burst —
        a third of the raylet loop; here quiet logs back off to 2s polls
        and the whole pool shares one timer."""
        while True:
            await asyncio.sleep(0.3)
            now = time.monotonic()
            for wid, t in list(self._log_tails.items()):
                if t.next_poll > now:
                    continue
                grew = await self._drain_log_tail(t)
                if t.w.dead:
                    # Final drain happened above (worker exit flushes its
                    # last buffered output); emit any unterminated line.
                    if t.carry and self.gcs_conn \
                            and not self.gcs_conn.closed:
                        try:
                            await self.gcs_conn.call("Publish", {
                                "channel": "LOGS",
                                "message": {
                                    "worker_id": t.w.worker_id,
                                    "node_id": self.node_id,
                                    "pid": t.w.proc.pid,
                                    "lines": [t.carry.decode("utf-8",
                                                             "replace")]}})
                        except Exception:
                            pass
                    del self._log_tails[wid]
                    continue
                # Chatty logs poll fast; quiet ones back off (most
                # workers log nothing at all).
                t.interval = 0.3 if grew else min(2.0, t.interval * 1.7)
                t.next_poll = now + t.interval

    async def _drain_log_tail(self, t: "_LogTail") -> bool:
        try:
            size = os.path.getsize(t.path)
        except OSError:
            return False
        grew = False
        try:
            while t.pos < size:
                grew = True
                with open(t.path, "rb") as f:
                    f.seek(t.pos)
                    chunk = f.read(min(size - t.pos, 256 * 1024))
                if not chunk:
                    break
                t.pos += len(chunk)
                data = t.carry + chunk
                # Keep an unterminated final line for the next read.
                nl = data.rfind(b"\n")
                if nl < 0:
                    t.carry = data
                    continue
                t.carry = data[nl + 1:]
                lines = data[:nl].decode("utf-8", "replace").splitlines()
                for s in range(0, len(lines), 200):
                    if self.gcs_conn and not self.gcs_conn.closed:
                        await self.gcs_conn.call("Publish", {
                            "channel": "LOGS",
                            "message": {"worker_id": t.w.worker_id,
                                        "node_id": self.node_id,
                                        "pid": t.w.proc.pid,
                                        "lines": lines[s:s + 200]}})
        except Exception:
            pass
        return grew

    def _idle_soft_limit(self) -> int:
        """Idle-pool cap shared by the reap loop and prestart (keeping the
        two in lockstep so prestarted workers aren't reaped on arrival)."""
        soft = self.config.num_workers_soft_limit
        if soft < 0:
            soft = max(2, int(self.total_resources.get("CPU", 2)))
        return soft

    def _spawn_worker(self) -> WorkerHandle:
        from ray_tpu_torch._private.ids import WorkerID

        worker_id = WorkerID.from_random().hex()
        worker_env = {
            "RAY_TPU_TORCH_WORKER_ID": worker_id,
            "RAY_TPU_TORCH_NODE_ID": self.node_id,
            "RAY_TPU_TORCH_RAYLET_HOST": self.host,
            "RAY_TPU_TORCH_RAYLET_PORT": str(self.port),
            "RAY_TPU_TORCH_GCS_HOST": self.gcs_host,
            "RAY_TPU_TORCH_GCS_PORT": str(self.gcs_port),
            "RAY_TPU_TORCH_STORE_PATH": self.store_path,
            "RAY_TPU_TORCH_SESSION_DIR": self.session_dir,
            # The CLUSTER config, not defaults: a worker's own fetches,
            # lease retries, and store sizing must honor what the driver
            # configured (pool workers previously default-constructed
            # Config and silently ignored e.g. same_host_zero_copy).
            "RAY_TPU_TORCH_CONFIG_JSON": self.config.to_json(),
            # Logs stream to the driver via the tail loop; block-buffered
            # stdout would hold lines back for ~8KB.
            "PYTHONUNBUFFERED": "1",
            # No card until a lease names one (accelerator.py).
            **accelerator.worker_env(),
        }
        log_path = os.path.join(self.session_dir, "logs", f"worker-{worker_id[:12]}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        w = WorkerHandle(_PendingProc(), worker_id)
        self.workers[worker_id] = w
        self._log_tails[worker_id] = self._LogTail(w, log_path)
        self._tasks.append(
            supervised_task(
                self._materialize_worker(w, worker_env, log_path)))
        return w

    async def _materialize_worker(self, w: WorkerHandle, worker_env: dict,
                                  log_path: str):
        """Back the handle with a real process: fork from the zygote when
        it is (or comes) warm, else cold-spawn an interpreter. Holds one
        startup-concurrency slot from fork until registration."""
        await self._spawn_slots.acquire()
        self._tasks.append(
            supervised_task(self._release_spawn_slot(w)))
        proc = None
        if self._zygote is not None:
            # Waiting for zygote warm-up beats cold-spawning in parallel
            # (the cold interpreter pays the exact same import cost the
            # zygote is finishing, contending for the same cores) — but
            # the wait must leave most of worker_startup_timeout_s for
            # the caller's registration window, or an alive-but-wedged
            # zygote starves every spawn: cap it well below that budget.
            deadline = time.monotonic() + min(
                20.0, self.config.worker_startup_timeout_s / 2)
            # The lock covers only the warm-up wait (one waiter polls;
            # the rest queue behind it briefly at boot) — spawns
            # themselves PIPELINE on the zygote socket, so a burst of
            # worker bring-ups no longer serializes behind one ~10-25ms
            # fork round-trip at a time (r4 many_actors ceiling).
            async with self._zygote_lock:
                zygote = self._zygote
                while (zygote is not None
                       and not await zygote.connect()
                       and time.monotonic() < deadline
                       and zygote.proc.poll() is None
                       and not w.dead):
                    await asyncio.sleep(0.1)
                connected = zygote is not None \
                    and await zygote.connect(0.05)
                if connected:
                    self._zygote_strikes = 0
                elif zygote is not None:
                    # Never-connected template: three strikes and it is
                    # retired so later spawns stop paying the wait.
                    self._zygote_strikes += 1
                    if self._zygote_strikes >= 3:
                        logger.warning(
                            "worker zygote never became ready; disabling "
                            "fork-server (workers will cold-spawn)")
                        self._zygote = None
                        await zygote.aclose()
            pid = None
            if connected:
                pid = await zygote.spawn(worker_env, log_path)
            if pid is not None:
                proc = _PidProc(pid)
        if proc is None:
            from ray_tpu_torch._private.ids import WorkerID

            # Fresh worker id for the fallback: a zygote spawn that forks
            # but loses its response leaves an orphan carrying the OLD id;
            # two registrations sharing one id would cross their death
            # handling (the orphan registers as unpooled and is reaped at
            # zygote shutdown).
            new_id = WorkerID.from_random().hex()
            self.workers.pop(w.worker_id, None)
            w.worker_id = new_id
            worker_env["RAY_TPU_TORCH_WORKER_ID"] = new_id
            if not w.dead:
                self.workers[new_id] = w
            env = dict(os.environ)
            env.update(worker_env)
            with open(log_path, "ab") as log_file:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch._private.worker"],
                    env=env, stdout=log_file, stderr=subprocess.STDOUT,
                    start_new_session=True)
        kill_requested = isinstance(w.proc, _PendingProc) \
            and w.proc.kill_requested
        w.proc = proc
        if w.dead or kill_requested:
            proc.kill()

    async def _release_spawn_slot(self, w: WorkerHandle):
        """Free the startup slot when the worker registers, dies, or the
        startup budget lapses — whichever comes first."""
        deadline = time.monotonic() + self.config.worker_startup_timeout_s
        try:
            while not w.registered.is_set() and not w.dead \
                    and time.monotonic() < deadline:
                try:
                    # 1s liveness poll: at 0.25s a 400-worker burst spent
                    # 1.6k os.kill probes/s on this alone.
                    await asyncio.wait_for(w.registered.wait(), 1.0)
                except asyncio.TimeoutError:
                    if w.proc.poll() is not None:
                        break
        finally:
            self._spawn_slots.release()

    def _kill_worker(self, w: WorkerHandle):
        w.dead = True
        self.workers.pop(w.worker_id, None)
        self._unpool_worker(w)
        try:
            w.proc.kill()
        except Exception:
            pass

    async def handle_register_worker(self, conn, payload):
        require_fields(payload, "host", "port", "worker_id",
                       method="handle_register_worker")
        w = self.workers.get(payload["worker_id"])
        if w is None:
            # Driver-side core workers also register so the raylet can track
            # them, but they are not pool workers.
            return {"ok": True, "pooled": False, "store_path": self.store_path,
                    "node_id": self.node_id}
        w.conn = conn
        w.address = (payload["host"], payload["port"])
        w.fp_port = payload.get("fp_port", 0)
        conn.on_close(lambda: None if w.dead else supervised_task(
            self._on_worker_death(w, "worker connection lost")))
        w.registered.set()
        if not w.leased and w.actor_id is None and not w.reserved:
            self._pool_worker(w)
        self._pump_pending_leases()
        return {"ok": True, "pooled": True, "store_path": self.store_path,
                "node_id": self.node_id}

    async def _get_ready_worker(self, lease_id: str = "") -> WorkerHandle | None:
        visible = ",".join(self.rcore.gpu_ids(lease_id)) if lease_id else ""
        while True:
            w = self._take_idle_worker(visible)
            if w is None:
                break
            if not w.dead and w.proc.poll() is None:
                return w
        w = self._spawn_worker()
        # Reserve BEFORE the await: registration lands on this same loop,
        # and an unreserved fresh worker would enter the idle pool where
        # a concurrent grant pops it — handing one process to two grants.
        w.reserved = True
        try:
            deadline = time.monotonic() + self.config.worker_startup_timeout_s
            while not w.registered.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._kill_worker(w)
                    self._last_spawn_failure = (
                        f"worker registration timed out after "
                        f"{self.config.worker_startup_timeout_s:g}s")
                    return None
                try:
                    # Wait slice bounded by the REMAINING budget: a fixed
                    # 0.5s slice quantized sub-0.5s startup timeouts away
                    # entirely (a fast registration landed inside the
                    # first slice and the deadline was never checked).
                    await asyncio.wait_for(w.registered.wait(),
                                           min(0.5, remaining))
                except asyncio.TimeoutError:
                    # A process that DIED before registering is a broken
                    # worker environment, not load — fail in seconds with
                    # a cause, instead of burning the full startup budget
                    # (owners budget these retries; see _request_lease).
                    if w.proc.poll() is not None:
                        self._kill_worker(w)
                        self._last_spawn_failure = (
                            "worker process exited during startup "
                            "(see worker logs)")
                        return None
        finally:
            w.reserved = False
        if w in self.idle_workers:
            self.idle_workers.remove(w)
            self._claim(w)
        return w

    # ---------- leases / scheduling ----------

    @property
    def available(self) -> dict:
        """Node-pool availability snapshot from the native core (what
        heartbeats report and spillback checks read)."""
        return self.rcore.available()

    def _acquire(self, resources: dict, pg_id: str,
                 bundle_index: int) -> str | None:
        """Acquire resources in the native core under a fresh lease id.

        Returns the lease id, or None when the demand does not fit now
        (or the PG bundle is absent/uncommitted — queued either way)."""
        self._lease_seq += 1
        lease_id = f"{self.node_id[:8]}-{self._lease_seq}"
        if self.rcore.try_acquire(lease_id, resources, pg_id or "",
                                  bundle_index):
            return lease_id
        return None

    def _release_lease_resources(self, w: WorkerHandle):
        if w.lease_id:
            # The core knows which pool the lease drew from and whether
            # a blocked worker already returned its resources.
            self.rcore.release(w.lease_id)
        w.blocked = False
        w.leased = False
        w.lease_id = None
        w.lease_resources = {}
        w.lease_pg = None

    # ---- blocked-worker CPU release (reference: raylet marks workers
    # blocked in ray.get and frees their resources so nested tasks can
    # run — the fix for fan-out/nested-get worker starvation) ----

    async def handle_node_debug_tasks(self, conn, payload):
        """Per-worker submission-state dump (owned pending tasks + lease
        slots) plus the raylet's lease table — the debug_state.txt
        analog (reference: node_manager.cc DumpDebugState); the tool
        that diagnosed the nested-fanout wedge (PARITY Known gaps)."""
        live = [w for w in self.workers.values()
                if not w.dead and w.conn is not None and not w.conn.closed]

        async def dump_one(w):
            # Concurrent: N wedged workers must cost ~one timeout, not N.
            try:
                return await w.conn.call("DebugTasks", {}, timeout=10)
            except Exception as e:
                return {"worker_id": w.worker_id, "error": str(e)}

        outs = list(await asyncio.gather(*(dump_one(w) for w in live)))
        leases = [{"worker": w.worker_id[:8], "leased": w.leased,
                   "reserved": w.reserved, "actor": bool(w.actor_id)}
                  for w in self.workers.values()]
        return {"node_id": self.node_id, "workers": outs, "leases": leases}

    async def handle_node_stacks(self, conn, payload):
        """Stack dumps from every live worker on this node (reference:
        `ray stack` — scripts.py:2453 py-spies all workers)."""
        skipped = []
        live = []
        for w in list(self.workers.values()):
            if w.dead or w.conn is None or w.conn.closed:
                # Usually a worker still cold-starting (interpreter spawn
                # takes seconds where it imports torch).
                skipped.append({"worker_id": w.worker_id, "dead": w.dead,
                                "registered": w.conn is not None})
                continue
            live.append(w)

        async def dump_one(w):
            try:
                return await w.conn.call("DumpStack", {}, timeout=10)
            except Exception as e:
                return {"worker_id": w.worker_id,
                        "error": f"{type(e).__name__}: {e}"}

        # Concurrent: N wedged workers must cost ~one timeout, not N.
        dumps = list(await asyncio.gather(*(dump_one(w) for w in live)))
        return {"node_id": self.node_id, "workers": dumps,
                "skipped": skipped}

    async def handle_node_profile(self, conn, payload):
        """Live CPU profiles from every worker on this node (reference:
        dashboard reporter module's py-spy profiling hooks — here each
        worker samples its own frames; see worker._handle_profile)."""
        duration = min(float(payload.get("duration_s", 2.0)), 30.0)
        live = [w for w in self.workers.values()
                if not w.dead and w.conn is not None and not w.conn.closed]

        async def profile_one(w):
            try:
                return await w.conn.call(
                    "Profile", {"duration_s": duration},
                    timeout=duration + 10)
            except Exception as e:
                return {"worker_id": w.worker_id,
                        "error": f"{type(e).__name__}: {e}"}

        out = list(await asyncio.gather(*(profile_one(w) for w in live)))
        return {"node_id": self.node_id, "duration_s": duration,
                "workers": out}

    # ---- observability: log files + per-worker profiling stats ----
    # (reference: dashboard/modules/log — per-node log index/tail — and
    # dashboard/modules/reporter — per-worker cpu/rss stats)

    async def handle_list_logs(self, conn, payload):
        logs_dir = os.path.join(self.session_dir, "logs")
        out = []
        try:
            for name in sorted(os.listdir(logs_dir)):
                try:
                    st = os.stat(os.path.join(logs_dir, name))
                    out.append({"name": name, "size": st.st_size,
                                "mtime": st.st_mtime})
                except OSError:
                    continue
        except FileNotFoundError:
            pass
        return {"node_id": self.node_id, "logs": out}

    def _tail_one_log(self, name: str, max_bytes: int) -> dict:
        logs_dir = os.path.realpath(os.path.join(self.session_dir, "logs"))
        path = os.path.realpath(os.path.join(logs_dir, name))
        # Traversal guard: only files directly inside the logs dir.
        if os.path.dirname(path) != logs_dir:
            return {"error": "invalid log name"}
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                if size > max_bytes:
                    f.seek(size - max_bytes)
                data = f.read(max_bytes)
        except OSError as e:
            return {"error": str(e)}
        return {"node_id": self.node_id, "name": name, "size": size,
                "data": data.decode("utf-8", "replace")}

    async def handle_tail_log(self, conn, payload):
        max_bytes = min(int(payload.get("max_bytes", 64 << 10)), 4 << 20)
        if "names" in payload:
            # Batched form: one RPC tails several files (the dashboard's
            # event merge uses this — one connection per node instead of
            # one per file).
            return {"node_id": self.node_id,
                    "files": {n: self._tail_one_log(n, max_bytes)
                              for n in payload["names"]}}
        return self._tail_one_log(payload.get("name", ""), max_bytes)

    @staticmethod
    def _proc_stats(pid: int) -> dict:
        """CPU seconds + RSS bytes from /proc (reporter-module parity
        without psutil)."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
            tick = os.sysconf("SC_CLK_TCK")
            return {
                "cpu_s": round((int(parts[11]) + int(parts[12])) / tick, 2),
                "rss_bytes": rss_pages * os.sysconf("SC_PAGE_SIZE"),
            }
        except (OSError, IndexError, ValueError):
            return {}

    async def handle_node_device_objects(self, conn, payload):
        """Device object plane stats from every live worker on this node
        (pinned bytes/objects and per-route counters per registry; see
        _private/device_objects.py)."""
        live = [w for w in self.workers.values()
                if not w.dead and w.conn is not None and not w.conn.closed]

        async def stats_one(w):
            try:
                out = await w.conn.call(
                    "DeviceObjectStats",
                    {"entries": bool(payload.get("entries"))}, timeout=10)
                out.setdefault("worker_id", w.worker_id)
                return out
            except Exception as e:
                return {"worker_id": w.worker_id,
                        "error": f"{type(e).__name__}: {e}"}

        stats = list(await asyncio.gather(*(stats_one(w) for w in live)))
        return {"node_id": self.node_id, "workers": stats}

    async def handle_worker_stats(self, conn, payload):
        workers = []
        for w in list(self.workers.values()):
            # _PendingProc (pid 0) = still materializing: no /proc entry
            # yet, reporting it as a live pid-0 worker would be noise.
            if w.dead or not w.proc.pid:
                continue
            entry = {"worker_id": w.worker_id, "pid": w.proc.pid,
                     "actor_id": w.actor_id or "",
                     "leased": w.leased, "blocked": w.blocked}
            entry.update(self._proc_stats(w.proc.pid))
            workers.append(entry)
        node = {"node_id": self.node_id, "pid": os.getpid(),
                "workers": workers}
        node.update(self._proc_stats(os.getpid()))
        return node

    def handle_worker_blocked(self, conn, payload):
        require_fields(payload, "worker_id", method="handle_worker_blocked")
        w = self.workers.get(payload["worker_id"])
        if w is None or not w.leased or not w.lease_id:
            return {}
        if self.rcore.block(w.lease_id):
            w.blocked = True
            self._pump_pending_leases()
        return {}

    def handle_worker_unblocked(self, conn, payload):
        require_fields(payload, "worker_id", method="handle_worker_unblocked")
        w = self.workers.get(payload["worker_id"])
        if w is None or not w.lease_id:
            return {}
        # Re-acquire immediately; the pool may go briefly negative
        # (dispatch only proceeds when fit, so this self-corrects as
        # other leases finish — same oversubscription the reference
        # tolerates on unblock).
        if self.rcore.unblock(w.lease_id):
            w.blocked = False
        return {}

    def _sync_native_view(self):
        """Mirror the GCS cluster view into the native scheduler core."""
        if self._native_sched is None:
            return
        seen = set()
        for nid, info in self.cluster_view.items():
            seen.add(nid)
            self._native_sched.update_node(
                nid, total=info.get("total_resources"),
                available=info.get("available_resources"),
                labels=info.get("labels"),
                # Draining peers stay in the data-plane view (object
                # pulls) but must not win spillback picks.
                alive=info.get("state", "ALIVE") == "ALIVE")
        for nid in self._native_known - seen:
            self._native_sched.remove_node(nid)
        self._native_known = seen

    def _pick_spillback(self, resources: dict, view: dict | None = None,
                        debit: bool = False) -> dict | None:
        """Hybrid policy tail: among alive peers that fit the demand, pick
        the best-utilized (pack) candidate (reference: top-k hybrid policy,
        hybrid_scheduling_policy.h:107-124 — we take k=1 of the sorted list
        since the cluster view is already fresh).  Pass `view` to pick
        against a locally-debited copy (bulk spill decisions).

        `debit=True` immediately charges the demand against the chosen
        node in the native mirror, so CONCURRENT spill decisions fan out
        across peers instead of herding onto one stale "best" node (the
        next heartbeat restores ground truth). Without it, a burst of
        direct-path lease requests all redirect to the same peer. Callers
        that pick conditionally use _debit_spill at the decision point
        instead."""
        if self._native_sched is not None and view is None:
            nid = self._native_sched.pick_node(resources, "pack",
                                               exclude=self.node_id)
            info = self.cluster_view.get(nid) if nid else None
            if info is None:
                return None
            if debit:
                self._native_sched.debit_node(nid, resources)
            return {"node_id": nid, "host": info["host"],
                    "port": info["raylet_port"]}
        candidates = []
        for nid, info in (view if view is not None
                          else self.cluster_view).items():
            if nid == self.node_id:
                continue
            if info.get("state", "ALIVE") != "ALIVE":
                continue  # never spill onto a draining/drained peer
            if resources_fit(info.get("available_resources", {}), resources):
                util = sum(info["total_resources"].get(k, 0)
                           - info["available_resources"].get(k, 0)
                           for k in ("CPU", "TPU", "GPU"))
                candidates.append((util, nid, info))
        if not candidates:
            return None
        candidates.sort(key=lambda c: -c[0])
        _, nid, info = candidates[0]
        return {"node_id": nid, "host": info["host"], "port": info["raylet_port"]}

    def _debit_spill(self, spill: dict, resources: dict) -> dict:
        """Charge a taken spill decision against the native mirror (see
        _pick_spillback's debit note) and pass the decision through."""
        if self._native_sched is not None:
            self._native_sched.debit_node(spill["node_id"], resources)
        return spill

    def _note_infeasible(self, resources: dict):
        now = time.monotonic()
        # One entry per distinct shape: owners retry infeasible leases every
        # second, and a log of rejections would read as N pending tasks.
        self._infeasible_demand = [
            (ts, d) for ts, d in self._infeasible_demand
            if now - ts < 10.0 and d != resources]
        self._infeasible_demand.append((now, resources))

    async def handle_request_worker_lease(self, conn, payload):
        """Grant a worker lease, spill back, or queue (reference:
        node_manager.cc:1778 HandleRequestWorkerLease)."""
        received_at = time.time()
        resources = normalize_resources(payload.get("resources"))
        strategy = payload.get("strategy")
        pg_id = payload.get("placement_group", "")
        bundle_index = payload.get("pg_bundle_index", -1)
        job_id = payload.get("job_id", "")
        if self.draining:
            spill = self._pick_spillback(resources)
            if spill:
                return {"spillback": self._debit_spill(spill, resources)}
            # No peer fits right now: a drain rejection is retry-
            # elsewhere, NEVER a permanent failure — a task that raced
            # the drain flag must not be failed infeasible (the owner
            # backs off and re-resolves from its local raylet's view).
            return {"error": "node draining", "draining": True,
                    "retry": True}

        if strategy and strategy[0] == "node_affinity" \
                and strategy[1] != self.node_id:
            # Route the lease to the TARGET node's raylet (reference:
            # NodeAffinitySchedulingStrategy — the lease must be granted
            # by the named node; lease_policy.cc picks the target raylet).
            target, soft = strategy[1], strategy[2]
            info = self.cluster_view.get(target)
            if info is not None:
                return {"spillback": {"node_id": target,
                                      "host": info["host"],
                                      "port": info["raylet_port"]}}
            if soft:
                pass  # target unknown/dead: soft affinity runs anywhere
            else:
                # Hard affinity to a node not (yet) in view: the caller
                # backs off and retries — a just-added node appears at
                # the next heartbeat exchange.
                return {"error": f"node_affinity target {target[:8]} is "
                                 "not in the cluster view",
                        "infeasible": True}
        allow_spill = not (strategy and strategy[0] == "node_affinity") and not pg_id
        hops = payload.get("hops", 0)
        is_spread = bool(strategy and strategy[0] == "spread") and hops == 0
        locally_feasible = pg_id or resources_fit(self.total_resources, resources)
        if not allow_spill or not is_spread:
            # FIFO fairness: a fresh request must not acquire ahead of
            # already-queued leases — a returner's immediate re-request
            # would otherwise grab its own freed credit every cycle and
            # starve the queue forever (observed as a grant/return
            # carousel wedging nested fan-outs). PG bundle leases are
            # exempt: they draw from their own reserved pool, which no
            # queued non-PG lease can consume.
            if pg_id or not self.pending_leases:
                lease_id = self._acquire(resources, pg_id, bundle_index)
                if lease_id:
                    return await self._grant_lease(lease_id, resources,
                                                   pg_id, bundle_index,
                                                   received_at=received_at)
        if allow_spill:
            # Prefer a peer with capacity available right now; for SPREAD,
            # prefer spilling even when we could run locally (one hop max,
            # so spilled requests settle instead of ping-ponging).
            spill = self._pick_spillback(resources)
            if spill is not None and (
                    is_spread or not resources_fit(self.available, resources)):
                return {"spillback": self._debit_spill(spill, resources)}
            if is_spread:
                # No better peer: run locally if possible (same FIFO
                # fairness gate as the non-spread path — a spread
                # returner must not lap the queue either).
                if pg_id or not self.pending_leases:
                    lease_id = self._acquire(resources, pg_id, bundle_index)
                    if lease_id:
                        return await self._grant_lease(
                            lease_id, resources, pg_id, bundle_index,
                            received_at=received_at)
            if not locally_feasible:
                # This node can never run it; hand off to any peer whose
                # TOTAL capacity fits (it will queue there), else error.
                for nid, info in self.cluster_view.items():
                    if nid != self.node_id \
                            and info.get("state", "ALIVE") == "ALIVE" \
                            and resources_fit(
                                info.get("total_resources", {}), resources):
                        return {"spillback": {"node_id": nid, "host": info["host"],
                                              "port": info["raylet_port"]}}
                self._note_infeasible(resources)
                return {"error": f"infeasible resource demand {resources} "
                                 f"(no node in cluster fits)", "infeasible": True}
        elif not locally_feasible:
            self._note_infeasible(resources)
            return {"error": f"infeasible resource demand {resources} "
                             f"(node total {self.total_resources})",
                    "infeasible": True}
        # Queue until resources free up.
        fut = asyncio.get_running_loop().create_future()
        item = (resources, pg_id, bundle_index, fut, allow_spill,
                received_at, job_id)
        self.pending_leases.append(item)
        try:
            return await asyncio.wait_for(fut, self.config.worker_lease_timeout_s)
        except asyncio.TimeoutError:
            try:
                self.pending_leases.remove(item)
            except ValueError:
                pass
            spill = self._pick_spillback(resources)
            if spill:
                return {"spillback": self._debit_spill(spill, resources)}
            return {"error": "lease timeout: insufficient resources", "retry": True}

    async def _grant_lease(self, lease_id, resources, pg_id, bundle_index,
                           received_at: float | None = None):
        """Attach an already-acquired lease (see _acquire) to a worker."""
        acquired_at = time.time()
        w = await self._get_ready_worker(lease_id)
        if w is None:
            # Couldn't start a worker: give the acquisition back. Often
            # load-dependent (spawn timeout under process pressure), so
            # the owner retries — but it is marked spawn_failure so the
            # owner can BUDGET those retries and surface a persistent
            # cause (broken worker env) instead of hanging forever.
            self.rcore.release(lease_id)
            reason = getattr(self, "_last_spawn_failure",
                             "worker startup failed")
            return {"error": f"worker startup failed: {reason}",
                    "retry": True, "spawn_failure": True}
        try:
            await self._pin_worker(w, lease_id)
        except Exception as e:
            self.rcore.release(lease_id)
            self._kill_worker(w)
            return {"error": f"worker device pin failed: {e}",
                    "retry": True}
        self._num_leases_granted += 1
        w.leased = True
        w.leased_at = time.monotonic()
        w.lease_id = lease_id
        w.lease_resources = resources
        # Observability only (which pool the lease drew from is tracked
        # natively; -1 records the wildcard request as made).
        w.lease_pg = (pg_id, bundle_index) if pg_id else None
        granted_at = time.time()
        return {"granted": True, "lease_id": lease_id,
                "worker_id": w.worker_id,
                "worker_host": w.address[0], "worker_port": w.address[1],
                "worker_fp_port": getattr(w, "fp_port", 0),
                "node_id": self.node_id,
                # Raylet-side lifecycle stamps: queue wait (request
                # arrival → resource acquisition) and worker attach time
                # — the owner embeds them in the task's LEASE_GRANTED
                # event so the latency breakdown can split raylet
                # queueing from RPC transit.
                "lease_timing": {
                    "received_at": received_at or acquired_at,
                    "granted_at": granted_at,
                    "queue_wait_ms": round(
                        (acquired_at - (received_at or acquired_at))
                        * 1000, 3),
                    "worker_attach_ms": round(
                        (granted_at - acquired_at) * 1000, 3),
                }}

    async def handle_return_worker(self, conn, payload):
        require_fields(payload, "lease_id", method="handle_return_worker")
        lease_id = payload["lease_id"]
        for w in self.workers.values():
            if w.lease_id == lease_id:
                self._release_lease_resources(w)
                if payload.get("kill"):
                    self._kill_worker(w)
                else:
                    self._pool_worker(w)
                break
        self._pump_pending_leases()
        return {"ok": True}

    def _pump_pending_leases(self):
        granted = []
        # Debited copy of the cluster view: each spill decision in this
        # pass consumes the target's capacity locally, so a burst of
        # queued leases fans out across peers instead of all redirecting
        # to the same (stale-view) "best" node.
        import copy

        debit_view = None
        # One availability snapshot per pass (each is a native call +
        # wire round-trip; per-item reads would be O(queue depth) on the
        # hottest scheduling path), refreshed after successful acquires.
        avail = None
        # Fair-share visit order: strict FIFO would hand every freed
        # slot to the head-of-queue tenant, so a 100k-task burst starves
        # the latency-sensitive job queued behind it. Interleave per-job
        # FIFO lanes round-robin, rotated so the lane after the last
        # job served goes first.
        by_job: dict = {}
        for item in list(self.pending_leases):
            by_job.setdefault(item[6], []).append(item)
        jobs = sorted(by_job)
        if self._lease_rr_last in by_job:
            i = jobs.index(self._lease_rr_last)
            jobs = jobs[i + 1:] + jobs[:i + 1]
        lanes = [deque(by_job[j]) for j in jobs]
        visit = []
        while any(lanes):
            for lane in lanes:
                if lane:
                    visit.append(lane.popleft())
        for item in visit:
            (resources, pg_id, bundle_index, fut, spillable, received,
             job_id) = item
            if fut.done():
                self.pending_leases.remove(item)
                continue
            lease_id = self._acquire(resources, pg_id, bundle_index)
            if lease_id:
                self.pending_leases.remove(item)
                granted.append((lease_id, item))
                avail = None
                self._lease_rr_last = job_id
                self._lease_grants_by_job[job_id] = \
                    self._lease_grants_by_job.get(job_id, 0) + 1
                if time.time() - received > self._starvation_threshold_s:
                    self._lease_starvation += 1
                continue
            if avail is None:
                avail = self.available
            if spillable and not resources_fit(avail, resources):
                # Re-run the scheduling policy over queued work: a peer may
                # have gained capacity (or just joined) since this lease
                # queued (reference: ClusterTaskManager::ScheduleAndDispatch
                # revisits the queue every round and can spill it). Each
                # spill decision debits the target locally so a burst fans
                # out across peers instead of herding onto one node.
                if self._native_sched is not None:
                    spill = self._pick_spillback(resources, debit=True)
                    if spill is not None:
                        self.pending_leases.remove(item)
                        fut.set_result({"spillback": spill})
                    continue
                if debit_view is None:
                    debit_view = copy.deepcopy(self.cluster_view)
                spill = self._pick_spillback(resources, view=debit_view)
                if spill is not None:
                    peer_avail = \
                        debit_view[spill["node_id"]]["available_resources"]
                    for k, v in resources.items():
                        peer_avail[k] = peer_avail.get(k, 0) - v
                    self.pending_leases.remove(item)
                    fut.set_result({"spillback": spill})
        for lease_id, (resources, pg_id, bundle_index, fut, _sp,
                       received_at, _job) in granted:
            async def grant(lease_id=lease_id, resources=resources,
                            pg_id=pg_id, bundle_index=bundle_index, fut=fut,
                            received_at=received_at):
                result = await self._grant_lease(lease_id, resources, pg_id,
                                                 bundle_index,
                                                 received_at=received_at)
                if not fut.done():
                    fut.set_result(result)
                elif result.get("granted"):
                    # Requester gave up (lease timeout) while we granted:
                    # reclaim the worker and its resources.
                    for w in self.workers.values():
                        if w.lease_id == lease_id:
                            self._release_lease_resources(w)
                            self._pool_worker(w)
                            break
                    else:
                        self.rcore.release(lease_id)
            supervised_task(grant(), name="fp-lease-grant")

    # ---------- actors ----------

    async def handle_create_actor(self, conn, payload):
        if self.draining:
            # The GCS excludes draining nodes from placement, but a
            # creation can race the drain flag; bounce it so the GCS
            # repicks (without consuming a restart — see _schedule_actor).
            return {"ok": False, "reason": "node draining"}
        resources = normalize_resources(payload.get("resources"))
        pg_id = payload.get("placement_group", "")
        bundle_index = payload.get("pg_bundle_index", -1)
        lease_id = self._acquire(resources, pg_id, bundle_index)
        if lease_id is None:
            if pg_id or resources_fit(self.total_resources, resources):
                # Feasible later: wait for resources like a queued lease.
                fut = asyncio.get_running_loop().create_future()
                # Not spillable: the GCS owns actor placement and reschedules
                # on failure; the raylet must not redirect actor creations.
                self.pending_leases.append(
                    (resources, pg_id, bundle_index, fut, False,
                     time.time(), payload.get("job_id", "")))
                try:
                    grant = await asyncio.wait_for(
                        fut, self.config.worker_lease_timeout_s)
                except asyncio.TimeoutError:
                    return {"ok": False, "reason": "timeout acquiring actor resources"}
                if not grant.get("granted"):
                    return {"ok": False, "reason": grant.get("error", "no worker")}
                w = self.workers.get(grant["worker_id"])
                return await self._assign_actor(w, payload, resources)
            return {"ok": False, "reason": f"infeasible actor resources {resources}"}
        w = await self._get_ready_worker(lease_id)
        if w is None:
            self.rcore.release(lease_id)
            return {"ok": False, "reason": "worker startup failed"}
        w.leased = True
        w.leased_at = time.monotonic()
        w.lease_id = lease_id
        w.lease_resources = resources
        w.lease_pg = (pg_id, bundle_index) if pg_id else None
        return await self._assign_actor(w, payload, resources)

    async def _pin_worker(self, w: WorkerHandle, lease_id: str) -> None:
        """Tell the worker which cards its lease holds before anything
        is pushed to it; it pins CUDA_VISIBLE_DEVICES to them at task
        start (accelerator.py). Skipped when the worker already holds
        that set (a CPU lease on a worker that never held a card)."""
        gpu_ids = self.rcore.gpu_ids(lease_id)
        visible = ",".join(gpu_ids)
        if w.device_pin == visible:
            return
        await w.conn.call("SetLeaseDevices", {"gpu_ids": gpu_ids},
                          timeout=self.config.rpc_call_timeout_s)
        w.device_pin = visible

    async def _assign_actor(self, w: WorkerHandle | None, payload, resources):
        if w is None:
            return {"ok": False, "reason": "no worker"}
        # The accounting lease (w.lease_id) stays attached for the
        # actor's lifetime; release happens on actor-worker death/kill
        # via _release_lease_resources.
        w.actor_id = payload["actor_id"]
        try:
            await self._pin_worker(w, w.lease_id)
            resp = await w.conn.call("AssignActor", {"spec": payload["spec"]},
                                     timeout=self.config.rpc_call_timeout_s)
            if not resp.get("ok"):
                return {"ok": False, "reason": resp.get("reason", "assign failed")}
        except Exception as e:
            return {"ok": False, "reason": f"assign rpc failed: {e}"}
        return {"ok": True}

    async def handle_kill_actor_worker(self, conn, payload):
        require_fields(payload, "actor_id", method="handle_kill_actor_worker")
        actor_id = payload["actor_id"]
        for w in list(self.workers.values()):
            if w.actor_id == actor_id:
                if self.draining and w.conn is not None \
                        and not w.conn.closed:
                    # Drain-migration kill: this worker's pins must
                    # re-home NOW: the pipeline's own device phase
                    # (_run_drain step 3) runs later and would find the
                    # process already dead.
                    try:
                        out = await w.conn.call(
                            "DeviceObjectEvacuate", {},
                            timeout=min(30.0,
                                        self.drain_deadline_s or 30.0))
                        self._note_device_evac(out)
                    except Exception:
                        logger.warning("pre-kill device evacuation of "
                                       "actor %s failed", actor_id[:8],
                                       exc_info=True)
                self._release_lease_resources(w)
                self._kill_worker(w)
                self._pump_pending_leases()
                return {"ok": True}
        return {"ok": False}

    # ---------- placement group bundles ----------

    async def handle_prepare_pg_bundle(self, conn, payload):
        require_fields(payload, "bundle_index", "pg_id", "resources",
                       method="handle_prepare_pg_bundle")
        resources = normalize_resources(payload["resources"])
        if self.rcore.pg_prepare(payload["pg_id"], payload["bundle_index"],
                                 resources):
            return {"ok": True}
        return {"ok": False, "reason": "insufficient resources"}

    async def handle_commit_pg_bundle(self, conn, payload):
        require_fields(payload, "bundle_index", "pg_id",
                       method="handle_commit_pg_bundle")
        if not self.rcore.pg_commit(payload["pg_id"],
                                    payload["bundle_index"]):
            return {"ok": False}
        self._pump_pending_leases()
        return {"ok": True}

    async def handle_return_pg_bundle(self, conn, payload):
        require_fields(payload, "bundle_index", "pg_id",
                       method="handle_return_pg_bundle")
        held = self.rcore.pg_return(payload["pg_id"],
                                    payload["bundle_index"])
        if held is not None:
            # Kill workers still leased against this bundle. Their lease
            # RECORDS must be released explicitly — _kill_worker pops the
            # worker, so no death path will do it later — but the credit
            # inside release is a no-op (the pool is already gone; its
            # whole reservation went back to the node pool above).
            for lease_id in held:
                for w in list(self.workers.values()):
                    if w.lease_id == lease_id:
                        self._release_lease_resources(w)
                        self._kill_worker(w)
                        break
                else:
                    self.rcore.release(lease_id)
            self._pump_pending_leases()
        return {"ok": True}

    # ---------- objects: spill / restore ----------

    async def _ensure_room(self, needed: int) -> int:
        """Spill idle (sealed, unreferenced) objects to disk until `needed`
        bytes are plausibly free. Returns bytes spilled. File writes run in
        a thread (reference: spilling is offloaded to IO workers) so
        heartbeats and RPCs keep flowing while gigabytes hit disk."""
        async with self._spill_lock:
            candidates = self.store.lru_candidates(needed)
            if not candidates:
                return 0
            os.makedirs(self.spill_dir, exist_ok=True)
            freed = 0
            for oid in candidates:
                oid_hex = oid.hex()
                if oid_hex in self.spilled:
                    continue
                got = self.store.get_buffer(oid)
                if got is None:
                    continue
                meta, data = got
                if self._ext_storage is not None:
                    # External URI backend (reference:
                    # external_storage.py:72 spill to URI store).
                    def write_ext(oid_hex=oid_hex, meta=meta, data=data):
                        return self._ext_storage.put(
                            oid_hex, bytes(meta) + bytes(data))

                    try:
                        path = await asyncio.to_thread(write_ext)
                    except Exception:
                        logger.exception("external spill failed")
                        continue
                    finally:
                        self.store.release(oid)
                else:
                    path = os.path.join(self.spill_dir, oid_hex)

                    def write_file(path=path, meta=meta, data=data):
                        with open(path, "wb") as f:
                            f.write(meta)
                            f.write(data)

                    try:
                        await asyncio.to_thread(write_file)
                    finally:
                        self.store.release(oid)
                # Non-forced delete: if a reader grabbed it between
                # candidate selection and now, keep it in shm and drop the
                # file.
                if self.store.delete(oid, force=False):
                    size = len(meta) + len(data)
                    self.spilled[oid_hex] = (path, len(meta), size)
                    self._spilled_bytes += size
                    self._num_spilled += 1
                    freed += size
                else:
                    # Delete-refused race: a reader re-pinned the object
                    # between candidate selection and delete; the object
                    # stays in shm, so drop the just-written blob from
                    # whichever backend holds it.
                    if self._ext_storage is not None and "://" in path:
                        await asyncio.to_thread(self._ext_storage.delete,
                                                path)
                    else:
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
            if freed:
                from ray_tpu_torch.util import events

                events.record("INFO", "raylet", "objects spilled",
                              freed_bytes=freed,
                              total_spilled=self._num_spilled)
                logger.info("spilled %d objects (%.1f MB) to %s",
                            self._num_spilled, freed / 1e6, self.spill_dir)
            return freed

    async def _create_with_room(self, oid: ObjectID, size: int,
                                meta_size: int):
        """store.create with one spill-and-retry on OOM. Returns the buffer,
        None if the object already exists (benign race with a concurrent
        writer), or raises ObjectStoreFullError."""
        for attempt in (0, 1):
            try:
                return self.store.create(oid, size, meta_size)
            except ObjectStoreFullError:
                if attempt or not await self._ensure_room(size):
                    raise
            except Exception as e:
                if "already exists" in str(e):
                    return None
                raise

    async def _restore_spilled(self, oid: ObjectID) -> bool:
        """Read a spilled object back into the store (restore path)."""
        entry = self.spilled.get(oid.hex())
        if entry is None:
            return False
        path, meta_size, size = entry

        def read_file():
            if self._ext_storage is not None and "://" in path:
                return self._ext_storage.get(path)
            with open(path, "rb") as f:
                return f.read()

        try:
            blob = await asyncio.to_thread(read_file)
        except OSError:  # includes FileNotFoundError from URI backends
            return False
        try:
            buf = await self._create_with_room(oid, len(blob), meta_size)
        except ObjectStoreFullError:
            return False
        if buf is not None:
            buf[:] = blob
            self.store.seal(oid)
        # buf None: someone else is re-creating it (e.g. lineage
        # re-execution); keep the spill file until that copy seals.
        if buf is None and not self.store.contains(oid):
            return False
        self.spilled.pop(oid.hex(), None)
        self._spilled_bytes -= size
        self._num_restored += 1
        if self._ext_storage is not None and "://" in path:
            await asyncio.to_thread(self._ext_storage.delete, path)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass
        return True

    async def handle_make_room(self, conn, payload):
        """A worker's store.create hit OOM; spill idle objects on its
        behalf, then it retries."""
        freed = await self._ensure_room(int(payload.get("needed", 0)))
        return {"ok": True, "freed": freed}

    # ---------- objects ----------

    async def handle_fetch_chunk(self, conn, payload):
        """Serve a chunk of a local object to a peer raylet (reference:
        push_manager.h:30 streams chunks over the ObjectManager service)."""
        require_fields(payload, "object_id", "offset", "size",
                       method="handle_fetch_chunk")
        oid = ObjectID.from_hex(payload["object_id"])
        got = self.store.get_buffer(oid)
        if got is None and await self._restore_spilled(oid):
            got = self.store.get_buffer(oid)
        if got is None:
            return {"found": False}
        meta, data = got
        try:
            off = payload["offset"]
            n = payload["size"]
            # Chunk space covers meta + data concatenated.
            if off < len(meta):
                combined = bytes(meta) + bytes(data)
                chunk = combined[off: off + n]
            else:
                chunk = bytes(data[off - len(meta): off - len(meta) + n])
            return {"found": True, "meta_size": len(meta),
                    "total_size": len(meta) + len(data), "chunk": chunk}
        finally:
            self.store.release(oid)

    async def _peer_conn(self, host: str, port: int) -> rpc.Connection:
        key = (host, port)
        conn = self._peer_conns.get(key)
        if conn is None or conn.closed:
            # dial, not a session: a dead peer conn is itself the signal
            # to re-resolve the peer from the cluster view.
            conn = await rpc.dial(host, port, name=f"raylet-peer-{port}",
                                  timeout=self.config.rpc_connect_timeout_s)
            self._peer_conns[key] = conn
        return conn

    async def handle_pull_object(self, conn, payload):
        """Pull an object from a remote node into the local store
        (reference: pull_manager.h:52)."""
        require_fields(payload, "object_id", method="handle_pull_object")
        oid_hex = payload["object_id"]
        oid = ObjectID.from_hex(oid_hex)
        if self.store.contains(oid):
            return {"ok": True}
        if oid_hex in self.spilled and await self._restore_spilled(oid):
            return {"ok": True}
        lock = self._pull_locks.setdefault(oid_hex, asyncio.Lock())
        async with lock:
            if self.store.contains(oid):
                return {"ok": True}
            locations = payload.get("locations") or []
            last_err = "no locations"
            # Native plane first: ONE multi-peer call stripes chunks
            # across every location that has a transfer server
            # (reference: pull_manager requests chunks from all copies).
            native_peers = [
                info for nid in locations
                if (info := self.cluster_view.get(nid)) is not None
                and info.get("transfer_port")]
            if native_peers:
                if await self._native_pull(native_peers, oid):
                    self._pull_locks.pop(oid_hex, None)
                    # Stripes may have come from several peers; any one
                    # alive source is enough for "a copy exists there".
                    src = next((nid for nid in locations
                                if nid in self.cluster_view), "")
                    if src:
                        self._pulled_copies[oid_hex] = src
                    return {"ok": True}
                last_err = "native pull failed from all peers"
            for nid in locations:
                info = self.cluster_view.get(nid)
                if info is None:
                    continue
                try:
                    peer = await self._peer_conn(info["host"], info["raylet_port"])
                    ok = await self._pull_from(peer, oid)
                    if ok:
                        self._pull_locks.pop(oid_hex, None)
                        self._pulled_copies[oid_hex] = nid
                        return {"ok": True}
                    last_err = f"object not on node {nid[:8]}"
                except Exception as e:
                    last_err = str(e)
            self._pull_locks.pop(oid_hex, None)
            return {"ok": False, "reason": last_err}

    async def _native_pull(self, infos: list, oid: ObjectID) -> bool:
        """Pull via peers' C++ transfer servers (bulk bytes stream
        shm-to-shm without touching Python; chunks stripe across peers).
        False = use the RPC path."""
        # Same-HOST peer: both arenas are local shm files — attach the
        # peer's arena and copy object bytes directly (ONE memcpy, no
        # sockets). This is plasma's same-node shared-memory property
        # extended across co-hosted raylets (fake multi-node clusters,
        # multi-raylet hosts); cross-host peers take the TCP stripes.
        # same_host_zero_copy=False disables the shortcut so the chunked
        # plane is measurable on one host (object_broadcast_chunked).
        for info in (infos if self.config.same_host_zero_copy else []):
            if info.get("host") == self.host and info.get("store_path"):
                try:
                    if await self._local_peer_copy(info["store_path"], oid):
                        return True
                except Exception:
                    logger.exception("local peer copy failed; using TCP")
        peers = [(info["host"], info["transfer_port"]) for info in infos]
        if not peers:
            return False
        from ray_tpu_torch._private import native_transfer

        loop = asyncio.get_running_loop()
        try:
            rc = await loop.run_in_executor(
                None, native_transfer.fetch_multi, self.store_path, peers,
                oid.binary())
        except Exception:
            return False
        if rc == -3:
            # Local arena full: make room like the RPC path would, then
            # retry once.
            try:
                if not await self._ensure_room(64 << 20):
                    return False
            except Exception:
                return False
            rc = await loop.run_in_executor(
                None, native_transfer.fetch_multi, self.store_path, peers,
                oid.binary())
        return rc == 0

    async def _local_peer_copy(self, peer_store_path: str,
                               oid: ObjectID) -> bool:
        """Copy one sealed object from a co-hosted peer's arena into
        ours (zero-copy read + one memcpy write, off the IO loop)."""
        if peer_store_path == self.store_path:
            return self.store.contains(oid)
        cache = getattr(self, "_peer_store_clients", None)
        if cache is None:
            cache = self._peer_store_clients = {}
        client = cache.get(peer_store_path)
        if client is None:
            if not os.path.exists(peer_store_path):
                return False
            client = ObjectStoreClient(peer_store_path)
            cache[peer_store_path] = client
        got = client.get_buffer(oid)
        if got is None:
            return False
        try:
            meta, data = got
            total = len(meta) + len(data)
            buf = await self._create_with_room(oid, total, len(meta))
            if buf is None:  # concurrent writer already has it
                return self.store.contains(oid)

            def copy_and_seal():
                if meta:
                    buf[:len(meta)] = meta
                buf[len(meta):] = data
                self.store.seal(oid)

            await asyncio.to_thread(copy_and_seal)
            return True
        finally:
            client.release(oid)

    async def _pull_from(self, peer: rpc.Connection, oid: ObjectID) -> bool:
        chunk_size = self.config.object_transfer_chunk_size
        first = await peer.call("FetchChunk", {
            "object_id": oid.hex(), "offset": 0, "size": chunk_size})
        if not first.get("found"):
            return False
        total = first["total_size"]
        meta_size = first["meta_size"]
        chunks = [first["chunk"]]
        got = len(first["chunk"])
        while got < total:
            nxt = await peer.call("FetchChunk", {
                "object_id": oid.hex(), "offset": got, "size": chunk_size})
            if not nxt.get("found"):
                return False
            chunks.append(nxt["chunk"])
            got += len(nxt["chunk"])
        try:
            buf = await self._create_with_room(oid, total, meta_size)
        except ObjectStoreFullError:
            return False
        if buf is None:  # concurrent writer already has it
            return self.store.contains(oid)
        off = 0
        for c in chunks:
            buf[off: off + len(c)] = c
            off += len(c)
        self.store.seal(oid)
        return True

    async def handle_free_objects(self, conn, payload):
        require_fields(payload, "object_ids", method="handle_free_objects")
        for oid_hex in payload["object_ids"]:
            self._pulled_copies.pop(oid_hex, None)
            self.store.delete(ObjectID.from_hex(oid_hex), force=True)
            entry = self.spilled.pop(oid_hex, None)
            if entry is not None:
                self._spilled_bytes -= entry[2]
                if self._ext_storage is not None and "://" in entry[0]:
                    await asyncio.to_thread(self._ext_storage.delete,
                                            entry[0])
                else:
                    try:
                        os.unlink(entry[0])
                    except OSError:
                        pass
        return {"ok": True}

    async def handle_node_store_info(self, conn, payload):
        """(host, store_path) of a peer node — workers use it to map
        same-host arenas for zero-copy reads (one host = one shm
        domain; see worker._try_same_host_read)."""
        require_fields(payload, "node_id", method="handle_node_store_info")
        nid = payload["node_id"]
        if nid == self.node_id:
            return {"found": True, "host": self.host,
                    "store_path": self.store_path}
        info = self.cluster_view.get(nid)
        if info is None:
            return {"found": False}
        return {"found": True, "host": info.get("host"),
                "store_path": info.get("store_path", "")}

    async def handle_drain(self, conn, payload):
        """Start graceful evacuation (reference: node_manager.cc:1940
        HandleDrainRaylet, grown into a full drain pipeline). Acks
        immediately; _run_drain evacuates in the background and reports
        DrainComplete to the GCS when the node is safe to kill."""
        reason = payload.get("reason") or "manual"
        deadline_s = float(payload.get("deadline_s") or 30.0)
        if self.draining:
            # A more urgent drain supersedes an in-flight one: a
            # preemption notice landing mid-idle-drain must TIGHTEN the
            # running pipeline's deadline (the platform reclaims the VM
            # on ITS schedule), never extend it.
            new_abs = time.monotonic() + deadline_s
            if new_abs < self._drain_deadline_mono:
                self._drain_deadline_mono = new_abs
                self.drain_reason = reason
                self.drain_deadline_s = deadline_s
                logger.warning("drain deadline tightened to %.1fs (%s)",
                               deadline_s, reason)
            return {"ok": True, "draining": True,
                    "already": True, "reason": self.drain_reason}
        self.draining = True
        if self._lease_plane is not None:
            self._lease_plane.set_draining(True)
            # Fault-aware rung for the native grant condition: DRAINING
            # routes every RequestWorkerLease to Python's drain logic.
            self._lease_plane.set_node_state(2)  # NODE_DRAINING
        self.drain_reason = reason
        self.drain_deadline_s = deadline_s
        self._drain_deadline_mono = time.monotonic() + deadline_s
        self._drain_task = supervised_task(
            self._run_drain(reason, deadline_s))
        self._tasks.append(self._drain_task)
        return {"ok": True, "draining": True}

    async def _run_drain(self, reason: str, deadline_s: float):
        """The evacuation pipeline, bounded by `deadline_s`:

        1. re-spill queued pending leases to peer raylets (or reject
           them retryable when no peer fits),
        2. wait for running leases to finish — reserving a slice of the
           deadline for data evacuation,
        3. re-home every worker's device-pinned tensors to their ref
           owners (device_objects.evacuate), before any worker is killed,
        4. kill overdue leased workers (their owners retry elsewhere —
           retryable, not infeasible),
        5. push the store's primary object copies to peers and record
           the relocations,
        6. report DrainComplete{stats, relocations} to the GCS.

        Actor migration runs concurrently on the GCS side
        (gcs._migrate_actors_off), started by the same DrainNode."""
        from ray_tpu_torch.util import events

        t0 = time.monotonic()
        stats = self._drain_stats
        stats.update({"reason": reason, "deadline_s": deadline_s})
        events.record("INFO", "raylet",
                      f"drain started ({reason}, {deadline_s:g}s deadline)",
                      node_id=self.node_id)
        logger.info("draining node %s: reason=%s deadline=%.1fs",
                    self.node_id[:8], reason, deadline_s)
        try:
            # -- 0. pre-death notice to live local workers -----------
            # Fire-and-forget fan-out so in-process subscribers (elastic
            # train sessions) can park at their next step boundary while
            # the evacuation pipeline runs — the node-local complement
            # of the GCS NODE "draining" publish, which only reaches
            # remote owners.
            for w in list(self.workers.values()):
                if w.dead or w.conn is None or w.conn.closed:
                    continue
                try:
                    await w.conn.notify("DrainNotice", {
                        "node_id": self.node_id, "reason": reason,
                        "deadline_s": deadline_s})
                except Exception:
                    pass

            # -- 1. queued leases ------------------------------------
            respilled = rejected = 0
            for item in list(self.pending_leases):
                resources, _pg, _bi, fut, spillable, _received, _job = item
                try:
                    self.pending_leases.remove(item)
                except ValueError:
                    continue
                if fut.done():
                    continue
                spill = self._pick_spillback(resources) if spillable \
                    else None
                if spill is not None:
                    fut.set_result(
                        {"spillback": self._debit_spill(spill, resources)})
                    respilled += 1
                else:
                    fut.set_result({"error": "node draining",
                                    "draining": True, "retry": True})
                    rejected += 1
            stats["respilled_leases"] = respilled
            stats["rejected_leases"] = rejected

            # -- 2. running leases (bounded wait) --------------------
            # Reserve part of the deadline for the data-evacuation
            # phases; a node that waits the full budget on one slow
            # task would have nothing left to move its objects with.
            # Cutoff re-read each tick: a superseding preemption drain
            # may tighten _drain_deadline_mono mid-wait.

            def running_leases():
                return [w for w in self.workers.values()
                        if w.leased and not w.dead and w.actor_id is None]

            while running_leases():
                reserve = min(max(1.0, self.drain_deadline_s * 0.3), 10.0)
                if time.monotonic() >= self._drain_deadline_mono - reserve:
                    break
                await asyncio.sleep(0.05)
            stats["lease_wait_s"] = round(time.monotonic() - t0, 3)

            # -- 3. device objects (before any worker is killed) -----
            # Accumulated, not assigned: drain-migration kills
            # (handle_kill_actor_worker) may have evacuated some
            # workers' pins already.
            for w in list(self.workers.values()):
                if w.dead or w.conn is None or w.conn.closed:
                    continue
                try:
                    out = await w.conn.call(
                        "DeviceObjectEvacuate", {},
                        timeout=max(2.0, self._drain_deadline_mono
                                    - time.monotonic()))
                except Exception as e:
                    logger.warning("device evacuation on worker %s "
                                   "failed: %s", w.worker_id[:8], e)
                    continue
                self._note_device_evac(out)
            for key in ("evacuated_device_objects",
                        "evacuated_device_bytes",
                        "skipped_device_objects"):
                stats.setdefault(key, 0)
            stats.setdefault("device_routes", {})

            # -- 4. overdue running leases: fail retryable -----------
            killed = 0
            for w in running_leases():
                await self._on_worker_death(
                    w, "node drained before lease completed "
                       "(owner retries elsewhere)")
                self._kill_worker(w)
                killed += 1
            stats["killed_leases"] = killed

            # -- 5. primary object copies → peers --------------------
            relocations, evac_objects, evac_bytes, left = \
                await self._evacuate_objects()
            stats["evacuated_objects"] = evac_objects
            stats["evacuated_bytes"] = evac_bytes
            stats["unevacuated_objects"] = left
        except Exception:
            logger.exception("drain evacuation failed; reporting what "
                             "completed")
            relocations = {}
        stats["duration_s"] = round(time.monotonic() - t0, 3)

        # -- 6. DrainComplete ------------------------------------
        for _attempt in range(3):
            try:
                await self.gcs_conn.call(
                    "DrainComplete",
                    {"node_id": self.node_id, "stats": stats,
                     "relocations": relocations},
                    timeout=self.config.rpc_call_timeout_s)
                break
            except Exception:
                await asyncio.sleep(0.5)
        else:
            logger.error("could not report DrainComplete to GCS")
        events.record("INFO", "raylet", "drain complete",
                      node_id=self.node_id,
                      **{k: v for k, v in stats.items()
                         if isinstance(v, (int, float))})
        logger.info("node %s drain complete in %.2fs: %s",
                    self.node_id[:8], stats["duration_s"], stats)
        self._drain_done.set()

    def _note_device_evac(self, out: dict) -> None:
        """Fold one worker's DeviceObjectEvacuate report into the drain
        stats (called from the pipeline's device phase AND from
        drain-migration actor kills, which evacuate early)."""
        s = self._drain_stats
        s["evacuated_device_objects"] = \
            s.get("evacuated_device_objects", 0) \
            + out.get("evacuated_objects", 0)
        s["evacuated_device_bytes"] = \
            s.get("evacuated_device_bytes", 0) \
            + out.get("evacuated_bytes", 0)
        s["skipped_device_objects"] = \
            s.get("skipped_device_objects", 0) + out.get("skipped", 0)
        routes = s.setdefault("device_routes", {})
        for route, n in (out.get("routes") or {}).items():
            routes[route] = routes.get(route, 0) + n

    async def _evacuate_objects(self):
        """Push every sealed (or spilled) local object to an alive peer
        by asking the peer to PullObject from us — the existing pull
        plane (native shm/TCP stripes, spill-restore) does the bytes.
        Bounded by self._drain_deadline_mono (re-read per object: a
        superseding drain may tighten it). Returns (relocations,
        n_evacuated, bytes_evacuated, n_left)."""
        peers = [(nid, info) for nid, info in self.cluster_view.items()
                 if nid != self.node_id
                 and info.get("state", "ALIVE") == "ALIVE"]
        todo: list[tuple[str, int]] = []  # (oid_hex, size)
        if self.store is not None:
            for oid in self.store.list_objects():
                got = self.store.get_buffer(oid)
                if got is None:
                    continue  # unsealed/mid-write: nothing to push yet
                meta, data = got
                size = len(meta) + len(data)
                self.store.release(oid)
                todo.append((oid.hex(), size))
        in_store = {h for h, _ in todo}
        for oid_hex, (_path, _ms, size) in list(self.spilled.items()):
            if oid_hex not in in_store:
                todo.append((oid_hex, size))
        if not todo:
            return {}, 0, 0, 0
        # Primaries first: copies we pulled from a STILL-ALIVE peer
        # exist elsewhere — pushing them is belt-and-braces, not
        # survival, so they must not eat the bounded window ahead of
        # objects whose only copy lives here. A pulled copy whose
        # source node has since died (rolling preemption) is a primary
        # now and sorts with them.
        alive_ids = {nid for nid, _info in peers}

        def is_secondary(oid_hex: str) -> bool:
            return self._pulled_copies.get(oid_hex) in alive_ids

        todo.sort(key=lambda item: is_secondary(item[0]))
        if not peers:
            logger.warning("drain: %d objects have no peer to evacuate "
                           "to", len(todo))
            return {}, 0, 0, len(todo)
        relocations: dict[str, str] = {}
        evac_bytes = 0
        bad_peers: set[str] = set()  # errored once: stop paying for it
        i = 0
        for oid_hex, size in todo:
            # Round-robin across peers (spreads transfer load and the
            # post-drain storage burden), retrying each object on the
            # NEXT peer when one fails — a single dead peer must not
            # silently lose its round-robin slice of the evacuation.
            for _attempt in range(len(peers)):
                remaining = self._drain_deadline_mono - time.monotonic()
                if remaining <= 0:
                    break
                nid, info = peers[i % len(peers)]
                i += 1
                if nid in bad_peers:
                    continue
                try:
                    peer = await self._peer_conn(info["host"],
                                                 info["raylet_port"])
                    resp = await peer.call(
                        "PullObject",
                        {"object_id": oid_hex,
                         "locations": [self.node_id]},
                        timeout=min(10.0, max(1.0, remaining)))
                except Exception as e:
                    logger.warning("drain: peer %s failed evacuating "
                                   "%s (%s); excluded", nid[:8],
                                   oid_hex[:12], e)
                    bad_peers.add(nid)
                    continue
                if resp.get("ok"):
                    relocations[oid_hex] = nid
                    evac_bytes += size
                    break
            if time.monotonic() >= self._drain_deadline_mono \
                    or len(bad_peers) == len(peers):
                break
        return (relocations, len(relocations), evac_bytes,
                len(todo) - len(relocations))

    async def handle_get_state(self, conn, payload):
        return {
            "node_id": self.node_id,
            "available": self.available,
            "total": self.total_resources,
            "num_workers": len(self.workers),
            "idle_workers": len(self.idle_workers),
            "pending_leases": len(self.pending_leases),
            "leases_granted": self._num_leases_granted,
            "lease_fair_share": {
                "jobs_queued": len({it[6] for it in self.pending_leases}),
                "grants_by_job": dict(self._lease_grants_by_job),
                "starvation": self._lease_starvation,
            },
            "active_leases": self.rcore.num_leases(),
            "pg_bundles": self.rcore.num_bundles(),
            "store": self.store.stats() if self.store else {},
            "spilled_objects": len(self.spilled),
            "spilled_bytes": self._spilled_bytes,
            "num_restored": self._num_restored,
            "gcs_registrations": self._gcs_registrations,
            "draining": self.draining,
            "drain_reason": self.drain_reason,
            "drain_stats": self._drain_stats,
            "drained": self._drain_done.is_set(),
            # Resilient-session counters for this raylet process (GCS
            # session flaps, replays, server-side dedup hits) — surfaced
            # as ray_tpu_rpc_* gauges in util/metrics.
            "rpc_sessions": rpc.session_stats(),
            "loaded_packages": loaded_packages(),
            "native_control": self._native_control_stats(),
        }

    def _native_control_stats(self):
        if self._lease_plane is None:
            return None
        plane = self._lease_plane
        handled, fallthrough, deduped = plane.counters()
        methods = {}
        for m in ("RequestWorkerLease", "ReturnWorker", "CreateActor"):
            mh, mr, md = plane.method_stats(m)
            methods[m] = {"handled": mh, "routed": mr, "degraded": md}
        return {
            "handled_total": handled,
            # Frames the plane looked at but routed to Python (complex
            # shapes, closed FIFO gate, empty pool, unknown leases).
            "native_fallthrough_total": fallthrough,
            "deduped_requests_total": deduped,
            "idle_mirror": plane.idle_count(),
            "sessions": plane.session_count(),
            "proto_errors": plane.proto_errors(),
            "stale_epoch_rejections_total": plane.stale_epoch_total(),
            "native_degraded_total": plane.degraded_total(),
            "divergence_trips_total": self._native_divergence_trips,
            "degraded_reason": self._native_degraded_reason,
            "native_leases": plane.native_lease_count(),
            "methods": methods,
        }

    async def _native_audit_loop(self):
        """Native↔Python mirror audit (mirrors gcs._native_audit_loop):
        two consecutive sweeps where the plane's lease ledger disagrees
        with the worker mirror — or a proto-error burst — trip the
        breaker and degrade the owned methods to Python for the life of
        the process (counted native_degraded_total)."""
        period = max(1.0, self.config.health_check_period_s)
        native_prefix = f"{self.node_id[:8]}-n"
        prev_mismatch = ""
        while True:
            await asyncio.sleep(period)
            plane = self._lease_plane
            if plane is None or self._native_degraded_reason:
                return
            try:
                proto = plane.proto_errors()
                burst = proto - self._audit_proto_seen >= 10
                self._audit_proto_seen = proto
                n_plane = plane.native_lease_count()
                n_mirror = sum(
                    1 for w in self.workers.values()
                    if w.leased and (w.lease_id or "").startswith(
                        native_prefix))
                mismatch = ""
                if n_plane != n_mirror:
                    mismatch = (f"lease-ledger divergence: plane="
                                f"{n_plane} mirror={n_mirror}")
                if burst:
                    self._trip_native_breaker(
                        f"proto-error burst ({proto} total)")
                elif mismatch and prev_mismatch:
                    self._trip_native_breaker(mismatch)
                prev_mismatch = mismatch
            except Exception:
                logger.exception("native mirror audit sweep failed")

    def _trip_native_breaker(self, reason: str) -> None:
        plane = self._lease_plane
        if plane is None or self._native_degraded_reason:
            return
        self._native_degraded_reason = reason
        self._native_divergence_trips += 1
        for m in ("RequestWorkerLease", "ReturnWorker", "CreateActor"):
            try:
                plane.set_degraded(m, True)
            except Exception:
                logger.exception("native breaker trip failed for %s", m)
        logger.error("native lease plane DEGRADED to Python: %s", reason)
        from ray_tpu_torch.util import events

        events.record("ERROR", "raylet",
                      f"native lease plane degraded: {reason}",
                      node_id=self.node_id)

    async def handle_get_event_loop_stats(self, conn, payload):
        """Per-handler dispatch latency + drain stats for this raylet's
        RPC loop (native pump or asyncio fallback — both expose the same
        EventLoopStats surface; analogue of event_stats.h)."""
        return {"node_id": self.node_id,
                "server": self.server.stats.snapshot()}

    async def self_drain(self, reason: str = "preemption",
                         deadline_s: float | None = None):
        """Self-initiated drain — the preemption-notice path. Platforms
        deliver SIGTERM ~30s before reclaiming a spot/maintenance node;
        the watcher in main() routes it here. Goes through the GCS so
        actor migration and the node-table ladder run exactly as for an
        operator-initiated drain; falls back to a local evacuation when
        the GCS is unreachable. Exits 0 once DRAINED."""
        if deadline_s is None:
            deadline_s = float(os.environ.get(
                "RAY_TPU_TORCH_PREEMPTION_DEADLINE_S", "30"))
        logger.warning("preemption notice on node %s: draining with "
                       "%.0fs deadline", self.node_id[:8], deadline_s)
        try:
            resp = await self.gcs_conn.call(
                "DrainNode", {"node_id": self.node_id, "reason": reason,
                              "deadline_s": deadline_s},
                timeout=min(10.0, self.config.rpc_call_timeout_s))
            if not resp.get("ok"):
                raise RuntimeError(resp.get("error", "DrainNode refused"))
        except Exception:
            logger.warning("GCS-coordinated drain failed; evacuating "
                           "locally", exc_info=True)
            await self.handle_drain(
                None, {"reason": reason, "deadline_s": deadline_s})
        try:
            await asyncio.wait_for(self._drain_done.wait(),
                                   deadline_s + 15.0)
        except asyncio.TimeoutError:
            logger.error("drain did not complete within deadline; "
                         "exiting anyway")
        logger.info("raylet %s exiting after preemption drain",
                    self.node_id[:8])
        os._exit(0)


def main():
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--node-id", default="")
    parser.add_argument("--head", action="store_true")
    parser.add_argument("--ready-fd", type=int, default=-1)
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[raylet] %(asctime)s %(levelname)s %(message)s")
    import faulthandler

    faulthandler.enable()  # segfault/abort tracebacks land in the log
    _maybe_attach_daemon_profiler("raylet")

    async def run():
        # Eager tasks (3.12): lease/return dispatches that complete
        # without blocking skip the scheduler round-trip (see gcs.main).
        if hasattr(asyncio, "eager_task_factory"):
            asyncio.get_running_loop().set_task_factory(
                asyncio.eager_task_factory)
        raylet = Raylet(
            args.gcs_host, args.gcs_port,
            resources=json.loads(args.resources) or None,
            labels=json.loads(args.labels),
            session_dir=args.session_dir,
            node_id=args.node_id or None,
            is_head=args.head)
        host, port = await raylet.start(args.host, args.port)
        # Preemption watcher: spot/maintenance reclamation delivers
        # SIGTERM with a short grace window — self-initiate a drain with
        # the platform deadline instead of dying with leases, objects,
        # and pinned HBM on board. RAY_TPU_TORCH_PREEMPTION_WATCHER=0 opts out
        # (SIGTERM then takes the default fatal path).
        if os.environ.get("RAY_TPU_TORCH_PREEMPTION_WATCHER", "1") != "0":
            try:
                asyncio.get_running_loop().add_signal_handler(
                    signal.SIGTERM,
                    lambda: supervised_task(raylet.self_drain(),
                                            name="sigterm-self-drain"))
            except (NotImplementedError, RuntimeError):
                pass  # non-main-thread / platform without signal support
        if args.ready_fd >= 0:
            os.write(args.ready_fd,
                     f"{host}:{port}:{raylet.node_id}:"
                     f"{raylet.store_path}\n".encode())
            os.close(args.ready_fd)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
