"""GCS: the cluster control plane.

Re-design of the reference's gcs_server (reference:
src/ray/gcs/gcs_server/gcs_server.h:79 and the manager classes it owns:
gcs_node_manager, gcs_actor_manager.cc, gcs_placement_group_manager,
gcs_job_manager, gcs_kv_manager, gcs_health_check_manager.h:39,
gcs_task_manager). One asyncio process owns all cluster metadata:

- node table + heartbeat-based failure detection
- actor directory, actor scheduling, restart-on-death (ReconstructActor
  analog, reference: gcs_actor_manager.h:504)
- placement groups with 2-phase prepare/commit reservation across raylets
  (reference: gcs_placement_group_scheduler.cc)
- namespaced KV store (function table, named actors, serve config live here)
- long-poll-free pubsub: subscribers hold an open connection, GCS pushes
  notify frames (reference: src/ray/pubsub/ + pubsub_handler)
- job table and task-event buffer for the state API

Tables persist through the native WAL store (csrc/gcs_store.cc,
native_gcs_store): mutations write through before the reply, and a
restarted GCS rehydrates from it (the reference's Redis-backed
gcs_table_storage is the model).
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict, defaultdict, deque

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.common import (  # noqa: F401
    _maybe_attach_daemon_profiler,
    NodeInfo,
    add_resources,
    loaded_packages,
    normalize_resources,
    require_fields,
    resources_fit,
    subtract_resources,
    supervised_task,
)
from ray_tpu_torch._private.config import Config

logger = logging.getLogger(__name__)

# Actor lifecycle states (reference: src/ray/protobuf/gcs.proto ActorTableData)
ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"

PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"

# Node drain ladder (reference: autoscaler.proto DrainNode +
# node_manager.cc HandleDrainRaylet). ALIVE nodes schedule normally;
# DRAINING nodes take no new placements while they evacuate; DRAINED
# nodes are safe to terminate and their death is a non-event.
#
# SUSPECT is the suspicion rung of failure detection (reference treats
# connection loss and health as separate signals: gcs_server/
# gcs_health_check_manager vs the node's pubsub channel dying): a lost
# raylet connection marks the node SUSPECT — excluded from NEW placement
# like DRAINING, but nothing is migrated or reconstructed. Only
# heartbeat-timeout expiry promotes SUSPECT -> DEAD; a re-registration
# inside the grace window restores the prior state as a logged non-event.
NODE_ALIVE = "ALIVE"
NODE_SUSPECT = "SUSPECT"
NODE_DRAINING = "DRAINING"
NODE_DRAINED = "DRAINED"
NODE_DEAD = "DEAD"

DRAIN_REASONS = ("preemption", "idle", "manual")

# GCS string rungs → native_policy.NODE_* ints for the actor plane's
# fault-aware ladder view. DRAINED maps onto the draining rung: both
# exclude the node from new native placements without killing it.
_PLANE_NODE_STATES = {
    NODE_ALIVE: 0,
    NODE_SUSPECT: 1,
    NODE_DRAINING: 2,
    NODE_DRAINED: 2,
    NODE_DEAD: 3,
}


def _plane_node_state(state: str) -> int:
    return _PLANE_NODE_STATES.get(state, 1)

# EV_INJECT token the native actor plane stamps on its mirror events
# (arrives in the conn_id slot — see fast_rpc.FastRpcServer.inject_handler).
_ACTOR_PLANE_TOKEN = 1


class _NativeServiceStack:
    """The pump's single native_service slot when two in-pump services
    are chained (actor plane → KV/pubsub). close() tears down front to
    back — the plane holds chain pointers into the KV service, so it
    must die first (both only after the pump loop thread is joined)."""

    def __init__(self, plane, svc):
        self._plane = plane
        self._svc = svc

    def close(self) -> None:
        if self._plane is not None:
            self._plane.close()
            self._plane = None
        if self._svc is not None:
            self._svc.close()
            self._svc = None


# Per-subscriber fanout queue bound. State channels coalesce
# latest-wins per entity, so depth only grows with DISTINCT entities in
# flight; LOGS (no coalesce key) drops oldest past the bound, counted.
_FANOUT_DEPTH = 256


def _fanout_key(channel: str, message):
    """Coalescing key for the bounded per-subscriber fanout queues.

    State channels (NODE/ACTOR/PG/JOB) are level-triggered — subscribers
    react to the LATEST state of an entity, not to every edge — so a
    queue backed up behind a slow subscriber keeps one pending message
    per entity (latest wins). Returns None for channels whose every
    message matters (LOGS) or unrecognized shapes: never coalesced,
    bounded by drop-oldest instead."""
    if not isinstance(message, dict):
        return None
    if channel == "NODE":
        nid = message.get("node_id") or \
            (message.get("node") or {}).get("node_id")
        return ("node", nid) if nid else None
    if channel == "ACTOR":
        aid = message.get("actor_id")
        return ("actor", aid) if aid else None
    if channel == "PG":
        pid = message.get("pg_id")
        return ("pg", pid) if pid else None
    if channel == "JOB":
        jid = message.get("job_id")
        return ("job", jid) if jid else None
    return None


class _SubscriberPump:
    """One supervised sender per subscriber connection (Python fanout
    path). publish() enqueues into the bounded coalescing queue and
    returns immediately; this task alone awaits the subscriber's
    (possibly stalled) socket, so one dead-slow subscriber can no
    longer head-of-line block delivery to every other subscriber on
    the channel. The queue is shared across channels — sends to one
    conn stay ordered."""

    def __init__(self, conn, stats: dict):
        self.conn = conn
        self.stats = stats
        self._q: OrderedDict = OrderedDict()
        self._seq = 0
        self._wake = asyncio.Event()
        self.closed = False
        self._task = supervised_task(self._run(), name="gcs-fanout")

    def push(self, channel: str, message) -> None:
        if self.closed:
            return
        key = _fanout_key(channel, message)
        if key is not None:
            if key in self._q:
                # Re-insert at the tail: the stale pending state for
                # this entity is superseded, ordering follows the
                # newest write.
                del self._q[key]
                self.stats["coalesced"] += 1
        else:
            self._seq += 1
            key = ("#", self._seq)
        self._q[key] = (channel, message)
        while len(self._q) > _FANOUT_DEPTH:
            self._q.popitem(last=False)
            self.stats["dropped"] += 1
        self.stats["enqueued"] += 1
        if len(self._q) > self.stats["max_depth"]:
            self.stats["max_depth"] = len(self._q)
        self._wake.set()

    def close(self) -> None:
        self.closed = True
        self._q.clear()
        self._wake.set()

    async def _run(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            if self.closed:
                return
            batch = 0
            while self._q:
                _, (channel, message) = self._q.popitem(last=False)
                try:
                    await self.conn.notify(
                        "Publish", {"channel": channel, "message": message})
                except Exception:
                    self.close()
                    return
                batch += 1
                self.stats["sent"] += 1
            if batch:
                self.stats["batches"] += 1


class GcsServer:
    def __init__(self, config: Config | None = None,
                 persistence_path: str | None = None):
        self.config = config or Config()
        # File-backed metadata persistence (the reference's Redis-backed
        # gcs_table_storage role): tables snapshot here so a restarted GCS
        # resumes with its actor/PG/KV/job state; raylets re-register
        # (reference: NotifyGCSRestart resync, node_manager.cc:1168).
        self.persistence_path = persistence_path
        # Dirty TABLE names awaiting flush (see _MUTATING); a direct
        # mark_dirty() with no argument dirties everything.
        self._dirty: set = set()
        # Native durable table store (csrc/gcs_store.cc): rows are written
        # through as WAL appends on each flush — only CHANGED rows hit
        # disk (hash-diffed), and a compaction rewrites the snapshot when
        # the WAL outgrows it. Opened in start().
        self._store = None
        self._row_hashes: dict[tuple[str, str], int] = {}
        self._row_sizes: dict[tuple[str, str], int] = {}
        self._persisted_bytes = 0  # total state size for compaction ratio
        self._flush_lock = threading.Lock()
        # Rows touched by in-flight mutating handlers: (table, key)
        # entries recorded AFTER the in-memory mutation, drained by the
        # handler wrapper and written through the WAL BEFORE the RPC
        # reply (per-mutation durability — reference: redis
        # store_client_kv write-through). Shared across concurrent
        # handlers on purpose: flushing another handler's already-applied
        # mutation early is harmless, and each wrapper drains the list
        # after its own handler ran, so its own rows are always covered.
        self._touched: list = []
        self._needs_sync = False  # WAL appends since last fdatasync
        self.nodes: dict[str, NodeInfo] = {}
        self.node_conns: dict[str, rpc.Connection] = {}
        # Per-node GCS->raylet call sessions (see _call_node): the GCS
        # stamps its raylet-bound mutating RPCs so a call replayed across
        # a raylet re-registration executes at most once on the raylet.
        self._node_call_sessions: dict[str, dict] = {}
        self.kv: dict[str, dict[bytes, bytes]] = defaultdict(dict)
        self.actors: dict[str, dict] = {}
        self.named_actors: dict[tuple[str, str], str] = {}
        self.jobs: dict[str, dict] = {}
        self.placement_groups: dict[str, dict] = {}
        self.task_events: deque = deque(maxlen=self.config.task_events_max_buffer)
        self.pending_demand: dict[str, list] = {}
        # Forwarding directory for objects evacuated off drained nodes:
        # oid_hex -> node_id of the copy's new home. Owners consult it
        # (GetObjectRelocations) before falling back to lineage
        # reconstruction when every known location is gone. Bounded:
        # entries beyond the cap age out FIFO.
        self.object_relocations: "dict[str, str]" = {}
        self._relocation_order: deque = deque()
        self._relocation_cap = 65536
        self.subscribers: dict[str, set[rpc.Connection]] = defaultdict(set)
        # Python-fallback fanout: one _SubscriberPump per subscriber
        # conn + shared counters (also fed by the native fanout path's
        # batch counter). Surfaced in GetClusterStatus -> status CLI +
        # /metrics.
        self._fanout_pumps: dict = {}
        self._fanout_stats = {"enqueued": 0, "sent": 0, "coalesced": 0,
                              "dropped": 0, "batches": 0, "max_depth": 0,
                              "native_batches": 0}
        # Streaming recovery: True while a restarted GCS is
        # still rehydrating persisted state in the background; flips
        # False when the recovery stream drains. Grants and answers
        # begin within the bounded priority prefix, not after the full
        # table replay.
        self.recovering = False
        self._recovery_backlog: deque = deque()
        self._recovery_stats = {"prefix_rows": 0, "streamed_rows": 0,
                                "prefix_ms": 0.0, "stream_ms": 0.0}
        # Native-pump server when available (csrc/fastpath.cc): accept,
        # framing, and sends ride the C++ epoll thread; table mutations
        # stay Python above the loop (reference: gcs_server.h:79 runs on
        # a C++ asio loop end-to-end).
        from ray_tpu_torch._private.fast_rpc import make_server

        self._server = make_server(self._handlers(), name="gcs")
        # Native in-pump protocol service (csrc/gcs_service.cc): when the
        # daemon runs on the fastpath pump, the KV table and pubsub
        # handlers execute entirely in C++ on the loop thread (parse →
        # mutate → WAL write-through → reply) and their frames never
        # reach Python. Installed by _native_service_factory at server
        # start; None on the asyncio fallback.
        self._native_svc = None
        # Native actor plane (csrc/gcs_actor.cc, RAY_TPU_TORCH_NATIVE_CONTROL=1):
        # the RegisterActor→CreateActor→ActorReady ladder for the simple
        # hot shape runs on the pump thread; Python mirrors state off
        # EV_INJECT events (_on_native_inject) and keeps every routed
        # shape (named/PG/strategy/resource actors).
        self._actor_plane = None
        # Divergence breaker bookkeeping: once the mirror
        # audit trips, owned methods degrade to the Python handlers and
        # stay degraded (re-arming needs an operator restart — the
        # divergence root cause must be understood, not retried).
        self._native_degraded_reason = ""
        self._native_divergence_trips = 0
        self._audit_proto_seen = 0
        # Actor ids whose re-kick _load_state deferred to the native
        # plane's rehydration; re-kicked via Python if install fails.
        self._native_rekick_deferred: list = []
        self._pending_native_kv: list = []   # (key_hex, blob) restore rows
        self._native_appends_seen = 0
        self._native_walfails_seen = 0
        self._health_task: asyncio.Task | None = None
        self._aux_tasks: list = []  # audit + restored-node reaper
        self._actor_seq = 0
        self.start_time = time.time()
        # Native C++ scheduling core (csrc/scheduler.cc). Mirrors the
        # node table and answers actor/PG placement queries; the
        # pure-Python policies below run only with
        # RAY_TPU_TORCH_NATIVE_CONTROL=0 (a core that does not build
        # raises).
        from ray_tpu_torch._private import native_scheduler

        self.native_sched = None
        if native_scheduler.available():
            self.native_sched = native_scheduler.ClusterScheduler()

    # Mutating RPC -> the persistence tables the HANDLER ITSELF touches.
    # The flush packs + hash-diffs only DIRTY tables, so a KV-heavy
    # cluster does not re-serialize the kv namespace when an actor
    # changed state. Cascades (node death failing over actors, job
    # finish killing actors or GCing kv packages) run through internal
    # paths that call mark_dirty with their OWN tables — listing them
    # here too would force full repacks of the largest tables for
    # handlers that changed nothing in them.
    _MUTATING = {
        "RegisterNode": ("nodes",),
        "NotifyNodeDead": ("nodes",),
        "DrainNode": ("nodes",),
        "DrainComplete": ("nodes", "actors"),
        "KVPut": ("kv",),
        "KVDel": ("kv",),
        "RegisterActor": ("actors", "named_actors"),
        "ActorReady": ("actors",),
        "ReportActorDeath": ("actors", "named_actors"),
        "KillActor": ("actors", "named_actors"),
        "RegisterJob": ("jobs",),
        "FinishJob": ("jobs",),
        "CreatePlacementGroup": ("placement_groups",),
        "RemovePlacementGroup": ("placement_groups",),
    }

    def _handlers(self):
        def wrap(name, fn):
            tables = self._MUTATING.get(name)
            if tables is None:
                return fn

            async def dirty(conn, payload, fn=fn, tables=tables):
                try:
                    return await fn(conn, payload)
                finally:
                    # Write-through BEFORE the reply goes out: rows the
                    # handler _touch()ed hit the WAL now, so a GCS
                    # killed -9 right after the ack replays them.
                    # mark_dirty stays as the hash-diffed catch-all for
                    # mutation sites without a _touch.
                    if self._touched:
                        touched, self._touched = self._touched, []
                        self._persist_touched(touched)
                    self.mark_dirty(tables)

            return dirty

        return {name: wrap(name, fn) for name, fn in {
            "RegisterNode": self.handle_register_node,
            "Heartbeat": self.handle_heartbeat,
            "GetAllNodes": self.handle_get_all_nodes,
            "DrainNode": self.handle_drain_node,
            "DrainComplete": self.handle_drain_complete,
            "GetObjectRelocations": self.handle_get_object_relocations,
            "NotifyNodeDead": self.handle_notify_node_dead,
            "KVPut": self.handle_kv_put,
            "KVGet": self.handle_kv_get,
            "KVDel": self.handle_kv_del,
            "KVKeys": self.handle_kv_keys,
            "KVExists": self.handle_kv_exists,
            "RegisterActor": self.handle_register_actor,
            "ActorReady": self.handle_actor_ready,
            "ReportActorDeath": self.handle_report_actor_death,
            "GetActorInfo": self.handle_get_actor_info,
            "GetNamedActor": self.handle_get_named_actor,
            "ListActors": self.handle_list_actors,
            "KillActor": self.handle_kill_actor,
            "RegisterJob": self.handle_register_job,
            "FinishJob": self.handle_finish_job,
            "ListJobs": self.handle_list_jobs,
            "CreatePlacementGroup": self.handle_create_pg,
            "RemovePlacementGroup": self.handle_remove_pg,
            "GetPlacementGroup": self.handle_get_pg,
            "ListPlacementGroups": self.handle_list_pgs,
            "Subscribe": self.handle_subscribe,
            "Publish": self.handle_publish,
            "AddTaskEvents": self.handle_add_task_events,
            "ListTaskEvents": self.handle_list_task_events,
            "GetClusterStatus": self.handle_get_cluster_status,
            "GetEventLoopStats": self.handle_get_event_loop_stats,
            "GetConfig": self.handle_get_config,
        }.items()}

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        if self.persistence_path:
            from ray_tpu_torch._private.native_gcs_store import GcsTableStore

            self._store = GcsTableStore(self.persistence_path)
            self._load_state()
            from ray_tpu_torch.util import events

            events.configure(os.path.dirname(self.persistence_path), "gcs")
            events.record("INFO", "gcs", "control plane started")
        from ray_tpu_torch._private.fast_rpc import FastRpcServer

        if isinstance(self._server, FastRpcServer):
            self._server.service_factory = self._native_service_factory
        addr = await self._server.start(host, port)
        self._health_task = supervised_task(self._health_check_loop(),
                                            name="gcs-health-loop")
        if self._actor_plane is not None:
            self._aux_tasks.append(supervised_task(
                self._native_audit_loop(), name="gcs-native-audit"))
        if self.persistence_path:
            self._persist_task = supervised_task(self._persist_loop(),
                                                 name="gcs-persist-loop")
            self._aux_tasks.append(supervised_task(
                self._reap_restored_nodes(), name="gcs-reap-restored"))
            if self.recovering:
                # The priority prefix is live; the rest of the persisted
                # state rehydrates behind the serving path.
                self._aux_tasks.append(supervised_task(
                    self._recovery_stream(), name="gcs-recovery-stream"))
        logger.info("GCS listening on %s:%s", *addr)
        return addr

    def _native_service_factory(self, pump):
        """Install the native in-pump services (called by
        FastRpcServer.start between pump creation and listen): the
        KV/pubsub service, and — under RAY_TPU_TORCH_NATIVE_CONTROL=1 — the
        actor plane chained in FRONT of it (both share the single
        fpump_set_service slot; unowned frames flow plane → KV service
        → Python). With RAY_TPU_TORCH_NATIVE_CONTROL=0 the Python
        handlers take KV and pubsub, re-homing kv rows that _load_state
        stashed for the native side. A service that fails to install
        raises (after closing what it made): nothing falls back to
        Python unnoticed."""
        from ray_tpu_torch._private import native_gcs_service

        svc = None
        if native_gcs_service.available():
            try:
                svc = native_gcs_service.GcsNativeService(pump, self._store)
                for key_hex, blob in self._pending_native_kv:
                    ns, k = rpc.unpack(bytes.fromhex(key_hex))
                    svc.kv_load(ns, rpc.pack(k), blob)
                # Hook the pump only once every restored row loaded — a
                # partially-loaded service must never answer frames.
                svc.install()
                self._pending_native_kv = []
                self._native_svc = svc
                logger.info(
                    "native GCS service active (KV + pubsub in-pump)")
            except Exception:
                logger.exception("native GCS service failed to install")
                # The pump hook was never installed (install() is the
                # last step), so the partially-constructed service can be
                # destroyed safely.
                if svc is not None:
                    try:
                        svc.close()
                    except Exception:
                        logger.exception("native GCS service close failed")
                raise
        if svc is None:
            # Switch off: re-home any rows _load_state stashed for the
            # native side into the Python tables.
            for key_hex, blob in self._pending_native_kv:
                self._restore_kv_row(key_hex, blob)
            self._pending_native_kv = []
        stack = self._install_actor_plane(pump, svc)
        if stack is not None:
            return stack
        return svc

    def _install_actor_plane(self, pump, svc):
        """Chain the native actor plane ahead of the KV service. Returns
        the combined service stack (close() tears down both in order) or
        None when RAY_TPU_TORCH_NATIVE_CONTROL is off — in which case
        the KV service's own hook (if any) stays active. A plane that
        fails to install raises."""
        from ray_tpu_torch._private import native_actor_plane

        if not native_actor_plane.available():
            self._rekick_deferred_native_actors()
            return None
        plane = None
        try:
            plane = native_actor_plane.GcsActorPlane(
                pump, inject_token=_ACTOR_PLANE_TOKEN)
            if svc is not None:
                plane.chain(svc.frame_addr(), svc.close_addr(), svc._h)
            # Crash rehydration (before install(), so the first frame the
            # plane answers already sees the replayed world): stamp the
            # server incarnation epoch — a replayed request from before
            # the restart carries the old epoch and, with the reply cache
            # gone, must be rejected as stale rather than wrongly deduped
            # or silently re-executed — then replay the persisted node
            # table and every native-owned actor row. Restored nodes are
            # not up (no conn yet); re-registration re-drives parked
            # PENDING actors via the plane's node_up path.
            plane.set_epoch(rpc._server_sessions.epoch)
            for nid, node in self.nodes.items():
                plane.restore_node(nid, _plane_node_state(node.state))
            for aid, a in self._iter_restorable_actors():
                if not a.get("native"):
                    continue
                if a["state"] == ACTOR_ALIVE:
                    pstate = "ALIVE"
                elif a["state"] in (ACTOR_PENDING, ACTOR_RESTARTING):
                    pstate = "PENDING"
                else:
                    continue
                plane.restore_actor(
                    aid, pstate, a.get("restarts", 0),
                    a.get("max_restarts", 0), a.get("node_id") or "",
                    rpc.pack(a["spec"]))
            self._native_rekick_deferred = []
            # install() replaces the KV service's pump hook — the plane
            # forwards everything it doesn't own down the chain, so
            # this must be the LAST step (a half-wired plane must never
            # answer frames).
            plane.install()
            self._server.inject_handler = self._on_native_inject
            self._actor_plane = plane
            logger.info("native control plane active (actor ladder "
                        "in-pump, graftgen validators + reply cache)")
            return _NativeServiceStack(plane, svc)
        except Exception:
            logger.exception("native actor plane failed to install")
            if plane is not None:
                try:
                    plane.close()
                except Exception:
                    logger.exception("native actor plane close failed")
            raise

    def _iter_restorable_actors(self):
        """Actor rows for the plane's pre-install rehydration: the
        prefix-applied tables plus rows still staged on the recovery
        backlog (decoded at load time). The plane must see the full
        replayed world before install(); the Python mirror of the
        backlog rows catches up via _recovery_stream."""
        yield from self.actors.items()
        for table, key_hex, _blob, row in self._recovery_backlog:
            if table == "actors" and row is not None:
                yield bytes.fromhex(key_hex).decode(), row

    def _rekick_deferred_native_actors(self) -> None:
        """_load_state deferred these re-kicks to the plane's
        rehydration; with no plane, Python's scheduler owns them."""
        deferred, self._native_rekick_deferred = (
            self._native_rekick_deferred, [])
        for actor_id in deferred:
            a = self.actors.get(actor_id)
            if a is None or a["state"] not in (ACTOR_PENDING,
                                               ACTOR_RESTARTING):
                continue
            a.pop("native", None)
            asyncio.get_event_loop().call_later(
                1.0, lambda aid=actor_id: supervised_task(
                    self._schedule_actor(aid)))

    # ---------- native actor plane mirror ----------
    # The plane decides on the pump thread and narrates every decision
    # through EV_INJECT ([event, payload] msgpack bodies); Python applies
    # them to the authoritative tables in arrival order. Mirror handlers
    # mutate state before their first await, so interleaving with RPC
    # handlers cannot reorder the per-actor ladder.

    def _on_native_inject(self, token, body):
        if token != _ACTOR_PLANE_TOKEN:
            return
        try:
            event, payload = rpc.unpack(body)
        except Exception:
            logger.exception("native actor plane: bad inject event")
            return
        supervised_task(self._apply_native_actor_event(event, payload),
                        name=f"native-actor-{event}")

    async def _apply_native_actor_event(self, event: str, payload):
        if event == "registered":
            # payload is the original RegisterActor payload (the plane
            # only owns nameless, strategy-less, resource-less actors).
            for stamp in (rpc._SID_KEY, rpc._RSEQ_KEY, rpc._ACK_KEY):
                payload.pop(stamp, None)
            actor_id = payload["actor_id"]
            self.actors[actor_id] = {
                "actor_id": actor_id,
                "job_id": payload.get("job_id", ""),
                "name": "",
                "namespace": payload.get("namespace") or "default",
                "class_name": payload.get("class_name", ""),
                "state": ACTOR_PENDING,
                "spec": payload["spec"],
                "resources": {},
                "max_restarts": payload.get("max_restarts", 0),
                "restarts": 0,
                "node_id": None,
                "address": None,
                "detached": payload.get("detached", False),
                "owner": payload.get("owner"),
                "death_cause": None,
                "strategy": None,
                "placement_group": "",
                "pg_bundle_index": -1,
                "native": True,
            }
            self.mark_dirty(("actors",))
            self._record_task_event(
                self._creation_task_id(actor_id, payload["spec"]),
                payload.get("class_name", ""), "CREATE_REGISTERED",
                job_id=payload.get("job_id", ""), actor_id=actor_id)
            return
        actor_id = payload.get("actor_id", "")
        a = self.actors.get(actor_id)
        if a is None:
            return
        if event == "scheduled":
            node_id = payload["node_id"]
            a["node_id"] = node_id
            self.mark_dirty(("actors",))
            # Same transient placement debit as _schedule_actor: the
            # plane charges CPU:1 so bursts fan out; the next heartbeat
            # restores ground truth.
            node = self.nodes.get(node_id)
            if node is not None:
                subtract_resources(node.available_resources, {"CPU": 1.0})
            if self.native_sched is not None:
                self.native_sched.debit_node(node_id, {"CPU": 1.0})
            self._record_task_event(
                self._creation_task_id(actor_id, a["spec"]),
                a["class_name"], "CREATE_SCHEDULED",
                job_id=a.get("job_id", ""), actor_id=actor_id,
                target_node=node_id)
        elif event == "ready":
            a["state"] = ACTOR_ALIVE
            a["address"] = payload.get("address")
            a["restarts"] = payload.get("restarts", a["restarts"])
            self.mark_dirty(("actors",))
            self._record_task_event(
                self._creation_task_id(actor_id, a["spec"]),
                a["class_name"], "CREATE_READY",
                job_id=a.get("job_id", ""), actor_id=actor_id)
            await self.publish("ACTOR", {
                "actor_id": actor_id, "state": ACTOR_ALIVE,
                "address": a["address"], "restarts": a["restarts"]})
        elif event == "restarting":
            a["restarts"] = payload.get("restarts", a["restarts"] + 1)
            a["state"] = ACTOR_RESTARTING
            a["address"] = None
            self.mark_dirty(("actors",))
            await self.publish("ACTOR", {
                "actor_id": actor_id, "state": ACTOR_RESTARTING,
                "reason": payload.get("reason", "")})
        elif event == "dead":
            a.pop("native", None)
            a["state"] = ACTOR_DEAD
            a["address"] = None
            a["death_cause"] = payload.get("reason", "")
            self.mark_dirty(("actors",))
            from ray_tpu_torch.util import events

            events.record("WARNING", "gcs", "actor dead",
                          actor_id=actor_id)
            await self.publish("ACTOR", {
                "actor_id": actor_id, "state": ACTOR_DEAD,
                "reason": payload.get("reason", "")})
        elif event == "orphaned":
            # The plane found no feasible node and handed the actor back
            # for good (its record is gone; the mirror keeps the restart
            # count). Python's scheduler takes over with its retry loop.
            a.pop("native", None)
            supervised_task(self._schedule_actor(actor_id))

    def _restore_kv_row(self, key_hex: str, blob: bytes) -> None:
        """Restore one persisted kv row into the Python tables. The
        decoded key type (str vs bytes) is preserved: a str-keyed row
        written by the native service must answer a str-keyed KVGet
        after a fallback restart (the live tables keep the two distinct,
        exactly like the native service's raw-encoding identity)."""
        ns, k = rpc.unpack(bytes.fromhex(key_hex))
        self.kv[ns][k] = rpc.unpack(blob)
        self._row_hashes[("kv", key_hex)] = hash(blob)
        self._row_sizes[("kv", key_hex)] = len(blob)

    async def stop(self):
        self._native_svc = None  # server stop destroys the service stack
        self._actor_plane = None
        for pump in list(self._fanout_pumps.values()):
            pump.close()
        self._fanout_pumps.clear()
        if self._health_task:
            self._health_task.cancel()
        if getattr(self, "_persist_task", None):
            self._persist_task.cancel()
        for t in self._aux_tasks:
            t.cancel()
        self._aux_tasks = []
        # Server (and its pump loop thread, which may be running native
        # KV write-throughs) must be fully stopped BEFORE the store is
        # flushed and closed.
        await self._server.stop()
        if self._store is not None:
            # Flush acknowledged mutations from the last <0.5s window,
            # then compact so restart replays a snapshot, not a long WAL.
            tables = set()
            try:
                if self._dirty:
                    tables, self._dirty = self._dirty, set()
                    self._flush_rows(self._table_rows(only=tables), tables)
                self._store.compact()
            except Exception:
                self.mark_dirty(tables)
                logger.exception("final GCS persistence flush failed")
            self._store.close()

    # ---------- persistence ----------
    # Tables persist as (namespace, key) -> msgpack'd row in the native
    # WAL store (csrc/gcs_store.cc — the reference's gcs_table_storage /
    # store_client role). Flushes are row-INCREMENTAL: rows are packed
    # and hash-diffed against the last flush, so disk writes are O(rows
    # changed), not O(cluster state), and a restart replays snapshot +
    # WAL. Store keys are hex (binary-safe for user internal_kv keys).

    _ALL_TABLES = ("kv", "actors", "named_actors", "jobs",
                   "placement_groups", "nodes")

    def mark_dirty(self, tables=None):
        self._dirty.update(tables if tables is not None else
                           self._ALL_TABLES)

    def _touch(self, table: str, key) -> None:
        """Record one mutated row for pre-reply write-through. Call
        AFTER the in-memory mutation, with the live-table key:
        kv=(ns, key_bytes), actors/jobs/placement_groups=str id,
        named_actors=(name, namespace), nodes=node_id."""
        if self._store is not None:
            self._touched.append((table, key))

    def _pack_row(self, table: str, key):
        """(store_key_hex, row_bytes | None) for one live-table row —
        None when the key is gone (row delete). Mirrors _table_rows."""
        if table == "kv":
            ns, k = key
            v = self.kv.get(ns, {}).get(k)
            return rpc.pack([ns, k]).hex(), (None if v is None
                                             else rpc.pack(v))
        if table == "actors":
            a = self.actors.get(key)
            if a is not None:
                a = dict(a)
                if isinstance(a.get("dead_worker_ids"), set):
                    a["dead_worker_ids"] = sorted(a["dead_worker_ids"])
            return key.encode().hex(), None if a is None else rpc.pack(a)
        if table == "named_actors":
            v = self.named_actors.get(key)
            return (rpc.pack(list(key)).hex(),
                    None if v is None else rpc.pack(v))
        if table == "jobs":
            j = self.jobs.get(key)
            return key.encode().hex(), None if j is None else rpc.pack(j)
        if table == "placement_groups":
            pg = self.placement_groups.get(key)
            return key.encode().hex(), None if pg is None else rpc.pack(pg)
        if table == "nodes":
            n = self.nodes.get(key)
            return (key.encode().hex(),
                    None if n is None else rpc.pack(n.to_wire()))
        raise ValueError(f"unknown persistence table {table!r}")

    def _persist_touched(self, touched: list) -> None:
        """Write touched rows through the WAL synchronously (before the
        RPC reply). Failures fall back to the debounced flush via
        mark_dirty."""
        with self._flush_lock:
            for table, key in touched:
                try:
                    key_hex, blob = self._pack_row(table, key)
                except Exception:
                    logger.exception("write-through pack failed (%s)", table)
                    self.mark_dirty((table,))
                    continue
                if blob is None:
                    if (table, key_hex) in self._row_hashes:
                        if self._store.delete(table, key_hex):
                            del self._row_hashes[(table, key_hex)]
                            self._persisted_bytes -= \
                                self._row_sizes.pop((table, key_hex), 0)
                            self._needs_sync = True
                        else:
                            self.mark_dirty((table,))
                    continue
                h = hash(blob)
                if self._row_hashes.get((table, key_hex)) == h:
                    continue  # unchanged (idempotent re-touch)
                if self._store.put(table, key_hex, blob):
                    self._row_hashes[(table, key_hex)] = h
                    self._persisted_bytes += (
                        len(blob) - self._row_sizes.get((table, key_hex), 0))
                    self._row_sizes[(table, key_hex)] = len(blob)
                    self._needs_sync = True
                else:
                    self._row_hashes.pop((table, key_hex), None)
                    self.mark_dirty((table,))

    def _table_rows(self, only=None) -> dict:
        """Pack live tables into {(namespace, hex_key): row_bytes}.
        `only` limits packing to the named (dirty) tables — a KV-heavy
        cluster must not re-serialize every kv row because one actor
        changed state."""
        want = set(only) if only is not None else set(self._ALL_TABLES)
        rows: dict[tuple[str, str], bytes] = {}
        if "kv" in want:
            for ns, table in self.kv.items():
                for k, v in table.items():
                    rows[("kv", rpc.pack([ns, k]).hex())] = rpc.pack(v)
        if "actors" in want:
            for aid, a in self.actors.items():
                a = dict(a)
                if isinstance(a.get("dead_worker_ids"), set):
                    a["dead_worker_ids"] = sorted(a["dead_worker_ids"])
                rows[("actors", aid.encode().hex())] = rpc.pack(a)
        if "named_actors" in want:
            for k, v in self.named_actors.items():
                rows[("named_actors", rpc.pack(list(k)).hex())] = rpc.pack(v)
        if "jobs" in want:
            for jid, j in self.jobs.items():
                rows[("jobs", jid.encode().hex())] = rpc.pack(j)
        if "placement_groups" in want:
            for pgid, pg in self.placement_groups.items():
                rows[("placement_groups", pgid.encode().hex())] = rpc.pack(pg)
        if "nodes" in want:
            for n in self.nodes.values():
                rows[("nodes", n.node_id.encode().hex())] = \
                    rpc.pack(n.to_wire())
        return rows

    def _flush_rows(self, rows: dict, tables=None) -> int:
        """Write changed rows through to the native store; delete
        vanished rows (sweep limited to the flushed `tables` — rows of
        unflushed tables are absent from `rows` but not deleted).
        Returns the number of rows touched. Serialized by a lock:
        stop()'s final flush may overlap a cancelled-but-still-running
        to_thread flush, and the two must not race the hash map. A
        failed WAL append (disk full) leaves the row unhashed so a
        later flush retries it."""
        swept = set(tables) if tables is not None else set(self._ALL_TABLES)
        with self._flush_lock:
            touched = 0
            failed = 0
            for (ns, key), blob in rows.items():
                h = hash(blob)
                if self._row_hashes.get((ns, key)) != h:
                    if self._store.put(ns, key, blob):
                        self._row_hashes[(ns, key)] = h
                        self._persisted_bytes += (
                            len(blob) - self._row_sizes.get((ns, key), 0))
                        self._row_sizes[(ns, key)] = len(blob)
                    else:
                        self._row_hashes.pop((ns, key), None)
                        failed += 1
                        self.mark_dirty((ns,))  # retry next window
                    touched += 1
            for (ns, key) in list(self._row_hashes):
                if ns in swept and (ns, key) not in rows:
                    if self._store.delete(ns, key):
                        del self._row_hashes[(ns, key)]
                        self._persisted_bytes -= \
                            self._row_sizes.pop((ns, key), 0)
                    else:
                        failed += 1
                        self.mark_dirty((ns,))
                    touched += 1
            if failed:
                logger.error("GCS persistence: %d row writes failed "
                             "(disk full?); will retry", failed)
            return touched

    def _load_state(self):
        """Restore the PRIORITY PREFIX of persisted state synchronously
        — the bounded set a restarted control plane needs to answer and
        grant correctly from its first frame — and stage everything
        else on `_recovery_backlog` for the background recovery stream
        (recovery is a stream, not a snapshot).

        Prefix, in priority order: every node row with live nodes
        first (placement and heartbeat replies need the full width
        view — bounded by cluster size, not workload), then in-flight
        actor creations (PENDING/RESTARTING rows, whose re-kicks must
        not be lost). The rest — the workload-proportional bulk:
        settled actors, named-actor index, jobs, placement groups —
        rehydrates incrementally in _recovery_stream; reads that race
        the stream fault their rows in via _recovery_faultin."""
        if self._store.num_rows() == 0:
            # A file AT the bare prefix is the pre-WAL single-snapshot
            # format (replaced this round); it is not migrated — surface
            # that instead of silently starting fresh over it.
            if os.path.exists(self.persistence_path):
                logger.warning(
                    "found legacy single-file GCS snapshot at %s; the WAL "
                    "store does not migrate it — starting fresh",
                    self.persistence_path)
            return  # first start of this session
        t0 = time.monotonic()
        native_kv = self._native_kv_planned()
        for key_hex, blob in self._store.scan("kv"):
            if native_kv:
                # The native service will own these rows (it re-writes
                # them through the WAL itself); keeping them out of
                # _row_hashes keeps the Python flush sweep away from
                # the kv namespace.
                self._pending_native_kv.append((key_hex, blob))
            else:
                self._restore_kv_row(key_hex, blob)
            self._persisted_bytes += len(blob)
        # Priority 1: the node table, live rungs first.
        node_rows = [(key_hex, blob, rpc.unpack(blob))
                     for key_hex, blob in self._store.scan("nodes")]
        node_rows.sort(key=lambda r: 0 if r[2].get("state", "ALIVE") in (
            NODE_ALIVE, NODE_SUSPECT, NODE_DRAINING) else 1)
        for key_hex, blob, w in node_rows:
            info = NodeInfo(
                node_id=w["node_id"], host=w["host"],
                raylet_port=w["raylet_port"],
                total_resources=w["total_resources"],
                available_resources=w["available_resources"],
                labels=w.get("labels") or {}, store_path=w.get("store_path", ""),
                is_head=w.get("is_head", False),
                transfer_port=w.get("transfer_port", 0),
                state=w.get("state", "ALIVE"),
                drain_reason=w.get("drain_reason", ""),
                drain_deadline_s=w.get("drain_deadline_s", 0.0),
                drain_stats=w.get("drain_stats") or {})
            # Nodes come back when their raylet re-registers; stale-alive
            # entries would mislead placement.
            info.alive = False
            self.nodes[info.node_id] = info
            self._row_hashes[("nodes", key_hex)] = hash(blob)
            self._row_sizes[("nodes", key_hex)] = len(blob)
            self._persisted_bytes += len(blob)
        self._restored_unregistered = {
            nid for nid, n in self.nodes.items() if not n.alive}
        # Priority 2: in-flight actor creations. Re-kick scheduling that
        # died with the previous process. Native-owned actors are
        # deferred: the plane's rehydration (restore_actor + re-drive on
        # node re-registration) replays them with at-most-once
        # semantics; a Python re-kick here would race it and fork the
        # creation. If the plane then fails to install,
        # _rekick_deferred_native_actors hands them back.
        native_planned = self._native_actor_planned()
        backlog: deque = deque()
        prefix_rows = len(node_rows)
        for key_hex, blob in self._store.scan("actors"):
            a = rpc.unpack(blob)
            a["dead_worker_ids"] = set(a.get("dead_worker_ids", ()))
            if a["state"] not in (ACTOR_PENDING, ACTOR_RESTARTING):
                backlog.append(("actors", key_hex, blob, a))
                continue
            aid = bytes.fromhex(key_hex).decode()
            self.actors[aid] = a
            self._row_hashes[("actors", key_hex)] = hash(blob)
            self._row_sizes[("actors", key_hex)] = len(blob)
            self._persisted_bytes += len(blob)
            prefix_rows += 1
            if native_planned and a.get("native"):
                self._native_rekick_deferred.append(aid)
                continue
            asyncio.get_event_loop().call_later(
                1.0, lambda aid=aid: supervised_task(
                    self._schedule_actor(aid)))
        # The rest rides the stream (PG_PENDING re-kicks fire as their
        # rows apply).
        for table in ("named_actors", "jobs", "placement_groups"):
            for key_hex, blob in self._store.scan(table):
                backlog.append((table, key_hex, blob, None))
        self._recovery_backlog = backlog
        self.recovering = bool(backlog)
        self._recovery_stats["prefix_rows"] = prefix_rows
        self._recovery_stats["prefix_ms"] = (time.monotonic() - t0) * 1e3
        logger.info("GCS recovery prefix loaded from %s in %.1fms "
                    "(%d nodes, %d pending actors, %d kv ns; %d rows "
                    "streaming)", self.persistence_path,
                    self._recovery_stats["prefix_ms"], len(self.nodes),
                    len(self.actors), len(self.kv), len(backlog))

    def _apply_recovery_row(self, table, key_hex, blob, row) -> None:
        """Apply one backlog row to the live tables. A key the running
        workload already (re)created wins over the snapshot — the
        stream only fills gaps, it never rolls live state back."""
        if table == "actors":
            aid = bytes.fromhex(key_hex).decode()
            if aid in self.actors:
                return
            self.actors[aid] = row
        elif table == "named_actors":
            key = tuple(rpc.unpack(bytes.fromhex(key_hex)))
            if key in self.named_actors:
                return
            self.named_actors[key] = rpc.unpack(blob)
        elif table == "jobs":
            jid = bytes.fromhex(key_hex).decode()
            if jid in self.jobs:
                return
            self.jobs[jid] = rpc.unpack(blob)
        elif table == "placement_groups":
            pid = bytes.fromhex(key_hex).decode()
            if pid in self.placement_groups:
                return
            pg = rpc.unpack(blob)
            self.placement_groups[pid] = pg
            if pg["state"] == PG_PENDING:
                asyncio.get_event_loop().call_later(
                    1.0, lambda p=pid: supervised_task(
                        self._schedule_pg(p)))
        self._row_hashes[(table, key_hex)] = hash(blob)
        self._row_sizes[(table, key_hex)] = len(blob)
        self._persisted_bytes += len(blob)

    async def _recovery_stream(self):
        """Drain the recovery backlog incrementally, yielding to the
        loop between chunks so answering and granting never wait on the
        full-table replay. Flips `recovering` off when dry."""
        t0 = time.monotonic()
        applied = 0
        try:
            while self._recovery_backlog:
                self._apply_recovery_row(*self._recovery_backlog.popleft())
                applied += 1
                if applied % 256 == 0:
                    await asyncio.sleep(0)
        finally:
            self.recovering = False
            self._recovery_stats["streamed_rows"] += applied
            self._recovery_stats["stream_ms"] = \
                (time.monotonic() - t0) * 1e3
            logger.info("GCS recovery stream drained (%d rows in %.1fms)",
                        applied, self._recovery_stats["stream_ms"])

    def _recovery_faultin(self, pred) -> None:
        """Synchronously apply (and drop) backlog rows matching pred —
        the read-through for lookups racing the recovery stream. O(n)
        over the remaining backlog, only while `recovering`."""
        if not self.recovering or not self._recovery_backlog:
            return
        keep: deque = deque()
        faulted = 0
        while self._recovery_backlog:
            item = self._recovery_backlog.popleft()
            if pred(item):
                self._apply_recovery_row(*item)
                faulted += 1
            else:
                keep.append(item)
        self._recovery_backlog = keep
        self._recovery_stats["streamed_rows"] += faulted

    async def _reap_restored_nodes(self):
        """Nodes restored from the snapshot that never re-registered are
        dead: fail over their actors (restart elsewhere or mark DEAD) the
        same way a live death would."""
        grace = max(10.0, self.config.health_check_period_s
                    * self.config.num_heartbeats_timeout * 3)
        await asyncio.sleep(grace)
        for nid in list(getattr(self, "_restored_unregistered", ())):
            node = self.nodes.get(nid)
            if node is None or node.alive:
                continue
            logger.warning("restored node %s never re-registered; failing "
                           "over its actors", nid[:8])
            for actor_id, a in list(self.actors.items()):
                if a.get("node_id") == nid and a["state"] in (
                        ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING):
                    await self._on_actor_worker_death(
                        actor_id, f"node {nid[:8]} lost across GCS restart")
            self.mark_dirty(("actors", "named_actors"))

    async def _persist_loop(self):
        while True:
            await asyncio.sleep(0.5)
            if self._native_svc is not None:
                # Native KV mutations append to the WAL on the pump
                # thread; fold them into the same batched-fdatasync
                # window, and surface disk-full failures.
                _, appends, fails = self._native_svc.counters()
                if appends != self._native_appends_seen:
                    self._native_appends_seen = appends
                    self._needs_sync = True
                if fails != self._native_walfails_seen:
                    self._native_walfails_seen = fails
                    logger.error(
                        "native GCS service: %d WAL appends failed "
                        "(disk full?)", fails)
            if self._needs_sync:
                # Batched fdatasync: write-through already made every
                # acknowledged mutation process-crash durable; this
                # bounds OS-crash exposure to one window (redis
                # appendfsync-everysec semantics).
                self._needs_sync = False
                await asyncio.to_thread(self._store.sync)
            if not self._dirty:
                # Compaction must not be gated on Python-side dirtiness:
                # a kv-churn workload handled entirely by the native
                # service never dirties a Python table, yet its WAL
                # appends still need folding into the snapshot.
                if self._store.wal_bytes() > max(
                        1 << 20, 4 * self._persisted_bytes):
                    await asyncio.to_thread(self._store.compact)
                continue
            tables, self._dirty = self._dirty, set()
            try:
                # Pack DIRTY tables' rows ON the loop (consistent view —
                # same role the old deepcopy played, at a cost bounded by
                # what actually changed); the diff + WAL writes run
                # off-loop (the store is thread-safe).
                rows = self._table_rows(only=tables)
                await asyncio.to_thread(self._flush_rows, rows, tables)
                # Compact once the WAL outgrows the TOTAL persisted
                # state (not this flush's dirty subset — that would
                # trigger full-snapshot rewrites on every small change).
                if self._store.wal_bytes() > max(
                        1 << 20, 4 * self._persisted_bytes):
                    await asyncio.to_thread(self._store.compact)
            except Exception:
                # Re-dirty the swapped tables: with per-table dirtying,
                # an unrelated later mutation would no longer re-flush
                # the rows this failed window carried.
                self.mark_dirty(tables)
                logger.exception("GCS persistence write failed")

    # ---------- pubsub ----------

    async def handle_subscribe(self, conn, payload):
        require_fields(payload, "channels", method="handle_subscribe")
        for channel in payload["channels"]:
            self.subscribers[channel].add(conn)
            conn.on_close(lambda ch=channel: self.subscribers[ch].discard(conn))
        return {"ok": True}

    async def handle_publish(self, conn, payload):
        require_fields(payload, "channel", "message", method="handle_publish")
        await self.publish(payload["channel"], payload["message"])
        return {"ok": True}

    def _native_kv_planned(self) -> bool:
        from ray_tpu_torch._private.fast_rpc import FastRpcServer

        if not isinstance(self._server, FastRpcServer):
            return False
        from ray_tpu_torch._private import native_gcs_service

        return native_gcs_service.available()

    def _native_actor_planned(self) -> bool:
        from ray_tpu_torch._private.fast_rpc import FastRpcServer

        if not isinstance(self._server, FastRpcServer):
            return False
        from ray_tpu_torch._private import native_actor_plane

        return native_actor_plane.available()

    async def publish(self, channel: str, message):
        if self._native_svc is not None:
            # One ctypes call, N native sends — and no packing at all
            # when nobody subscribed (the common case for LOGS).
            if self._native_svc.sub_count(channel):
                self._native_svc.fanout(channel, rpc.pack(
                    [rpc.MSG_NOTIFY, 0, "Publish",
                     {"channel": channel, "message": message}]))
                self._fanout_stats["native_batches"] += 1
            return
        # Python fallback: enqueue-and-return into per-subscriber
        # supervised sender pumps. publish() itself never awaits a
        # subscriber socket — a stalled conn backs up only its own
        # bounded queue (coalesced latest-wins per entity on state
        # channels, drop-oldest-counted otherwise).
        dead = []
        for conn in list(self.subscribers.get(channel, ())):
            if getattr(conn, "closed", False):
                dead.append(conn)
                continue
            pump = self._fanout_pumps.get(conn)
            if pump is None or pump.closed:
                pump = _SubscriberPump(conn, self._fanout_stats)
                self._fanout_pumps[conn] = pump
                conn.on_close(lambda c=conn: self._drop_fanout_pump(c))
            pump.push(channel, message)
        for conn in dead:
            self.subscribers[channel].discard(conn)
            self._drop_fanout_pump(conn)

    def _drop_fanout_pump(self, conn) -> None:
        pump = self._fanout_pumps.pop(conn, None)
        if pump is not None:
            pump.close()

    # ---------- nodes ----------

    async def handle_register_node(self, conn, payload):
        require_fields(payload, "host", "node_id", "raylet_port",
                       "total_resources", method="handle_register_node")
        node_id = payload["node_id"]
        existing = self.nodes.get(node_id)
        if existing is not None and existing.alive:
            # Re-registration of a LIVE node: the raylet's session
            # reconnected after a socket flap (or a half-open link the
            # GCS never noticed). Re-bind the connection and restore the
            # pre-suspect state — a fresh NodeInfo here would wipe drain
            # progress and heartbeat history, the flap-resurrect hole.
            return await self._handle_node_reregister(conn, existing, payload)
        info = NodeInfo(
            node_id=node_id,
            host=payload["host"],
            raylet_port=payload["raylet_port"],
            total_resources=normalize_resources(payload["total_resources"]),
            available_resources=normalize_resources(payload["total_resources"]),
            labels=payload.get("labels") or {},
            store_path=payload.get("store_path", ""),
            is_head=payload.get("is_head", False),
            transfer_port=payload.get("transfer_port", 0),
        )
        self.nodes[info.node_id] = info
        self.node_conns[info.node_id] = conn
        self._plane_node_up(info.node_id, conn)
        self._touch("nodes", info.node_id)
        if hasattr(self, "_restored_unregistered"):
            self._restored_unregistered.discard(info.node_id)
        if self.native_sched is not None:
            self.native_sched.update_node(
                info.node_id, total=info.total_resources,
                available=info.available_resources, labels=info.labels)
        conn.on_close(lambda: supervised_task(
            self._on_node_conn_lost(info.node_id, conn)))
        await self.publish("NODE", {"event": "alive", "node": info.to_wire()})
        logger.info("node %s registered (%s:%s)", info.node_id[:8], info.host, info.raylet_port)
        return {"ok": True, "config": self.config.to_json()}

    async def _handle_node_reregister(self, conn, node: NodeInfo, payload):
        """A live node re-registered over a fresh connection: a logged
        non-event. No migrations, no reconstructions — just re-bind the
        connection, clear SUSPECT, and preserve the drain ladder."""
        require_fields(payload, "host", "raylet_port",
                       method="RegisterNode")
        node.host = payload["host"]
        node.raylet_port = payload["raylet_port"]
        node.store_path = payload.get("store_path", node.store_path)
        node.transfer_port = payload.get("transfer_port", node.transfer_port)
        node.labels = payload.get("labels") or node.labels
        node.last_heartbeat = time.monotonic()
        was_suspect = node.state == NODE_SUSPECT
        if was_suspect:
            node.state = node.pre_suspect_state or NODE_ALIVE
            node.pre_suspect_state = ""
            outage_s = time.time() - node.suspect_since_s \
                if node.suspect_since_s else 0.0
            node.suspect_since_s = 0.0
            node.suspect_recoveries += 1
            logger.info(
                "node %s reconnected inside the grace window after %.1fs "
                "(flap #%d): non-event, state restored to %s",
                node.node_id[:8], outage_s, node.suspect_recoveries,
                node.state)
            from ray_tpu_torch.util import events

            events.record("INFO", "gcs", "suspect node reconnected",
                          node_id=node.node_id)
        self.node_conns[node.node_id] = conn
        self._plane_node_up(node.node_id, conn)
        if node.state != NODE_ALIVE:
            # node_up resets the plane's rung to ALIVE; restore the real
            # one (e.g. a DRAINING node that flapped stays unpickable).
            self._plane_node_state_notify(node.node_id, node.state)
        self._touch("nodes", node.node_id)
        if self.native_sched is not None:
            self.native_sched.update_node(
                node.node_id, total=node.total_resources,
                available=node.available_resources, labels=node.labels,
                alive=node.state == NODE_ALIVE)
        conn.on_close(lambda: supervised_task(
            self._on_node_conn_lost(node.node_id, conn)))
        await self.publish("NODE", {
            "event": "reconnected" if was_suspect else "alive",
            "node": node.to_wire()})
        return {"ok": True, "config": self.config.to_json(),
                "reconnected": True}

    def _plane_node_up(self, node_id: str, conn) -> None:
        """Tell the native actor plane a raylet conn (re)bound, so it
        can (re)send any in-flight CreateActors over the fresh socket
        with their ORIGINAL (sid, rseq) — the raylet's reply cache
        makes the replay at-most-once."""
        if self._actor_plane is not None and hasattr(conn, "_conn_id"):
            try:
                self._actor_plane.node_up(node_id, conn._conn_id)
            except Exception:
                logger.exception("native actor plane node_up failed")

    def _plane_node_state_notify(self, node_id: str, state: str) -> None:
        """Mirror a death/drain-ladder rung into the native plane so
        native picks and re-drives honor SUSPECT/DRAINING exclusions."""
        if self._actor_plane is not None:
            try:
                self._actor_plane.node_state(node_id,
                                             _plane_node_state(state))
            except Exception:
                logger.exception("native actor plane node_state failed")

    async def _call_node(self, node_id: str, method: str, payload=None, *,
                         timeout: float | None = None,
                         wait_rebind: bool = True):
        """At-most-once GCS->raylet call.

        GCS->raylet RPCs ride the raylet-OPENED connection, so the GCS
        cannot redial a dead socket — it can only wait for the raylet to
        re-register (node_conns rebind). This helper stamps the request
        with a GCS-side per-node session id so a call replayed across
        that rebind hits the raylet's reply cache instead of executing a
        second time (a replayed CreateActor must not fork the actor).
        Waits up to the SUSPECT grace window for the rebind; raises
        rpc.ConnectionLost once the node is dead or the window expires.
        """
        sess = self._node_call_sessions.get(node_id)
        if sess is None:
            sess = self._node_call_sessions[node_id] = {
                "sid": uuid.uuid4().hex, "rseq": 0, "outstanding": set()}
        stamped = None
        rseq = 0
        if method not in rpc.SESSION_EXEMPT_METHODS \
                and (payload is None or isinstance(payload, dict)):
            sess["rseq"] += 1
            rseq = sess["rseq"]
            stamped = dict(payload or {})
            stamped[rpc._SID_KEY] = sess["sid"]
            stamped[rpc._RSEQ_KEY] = rseq
            sess["outstanding"].add(rseq)
        loop = asyncio.get_running_loop()
        grace = (self.config.health_check_period_s
                 * self.config.num_heartbeats_timeout)
        rebind_deadline = loop.time() + grace
        call_deadline = None if timeout is None else loop.time() + timeout
        sent_once = False
        try:
            while True:
                node = self.nodes.get(node_id)
                if node is None or not node.alive:
                    raise rpc.ConnectionLost(
                        f"node {node_id[:8]} is dead")
                conn = self.node_conns.get(node_id)
                if conn is None or conn.closed:
                    if not wait_rebind or loop.time() > rebind_deadline:
                        raise rpc.ConnectionLost(
                            f"no raylet connection to node {node_id[:8]}")
                    await asyncio.sleep(0.05)
                    continue
                if stamped is not None:
                    outstanding = sess["outstanding"]
                    stamped[rpc._ACK_KEY] = (min(outstanding) - 1
                                             if outstanding else sess["rseq"])
                if sent_once:
                    rpc._session_stats["replayed_requests_total"] += 1
                sent_once = True
                try:
                    att = None if call_deadline is None \
                        else max(0.01, call_deadline - loop.time())
                    return await conn.call(
                        method, stamped if stamped is not None else payload,
                        timeout=att)
                except rpc.ConnectionLost:
                    # Socket died mid-call: wait for the raylet to
                    # re-register, then replay (deduped server-side).
                    logger.debug(
                        "%s to node %s interrupted by connection loss; "
                        "awaiting re-registration to replay",
                        method, node_id[:8])
                    continue
        finally:
            if stamped is not None:
                sess["outstanding"].discard(rseq)

    async def handle_heartbeat(self, conn, payload):
        require_fields(payload, "node_id", method="handle_heartbeat")
        node = self.nodes.get(payload["node_id"])
        if node is None or not node.alive:
            # Explicit death notice: a raylet that outlived its own
            # SUSPECT->DEAD promotion (long partition healed) must not
            # be silently resurrected by a late heartbeat — its actors
            # and leases were already failed over. It must exit or
            # re-register as a fresh node.
            return {"ok": False, "dead": True,
                    "reason": "unknown or dead node; this identity was "
                              "declared dead — re-register as a new node"}
        if node.state == NODE_SUSPECT:
            # A heartbeat over a fresh connection from a SUSPECT node:
            # the node is clearly up, but its registration conn is gone.
            # Don't resurrect it from a side channel — tell it to re-run
            # the RegisterNode handshake (which rebinds node_conns and
            # clears SUSPECT as a non-event).
            return {"ok": False, "reregister": True,
                    "reason": "node is SUSPECT (connection lost); "
                              "re-register to reattach"}
        node.last_heartbeat = time.monotonic()
        node.available_resources = payload.get("available_resources", node.available_resources)
        if self.native_sched is not None:
            # A draining node keeps heartbeating but must stay dead in
            # the placement mirror (update_node defaults alive=True).
            self.native_sched.update_node(
                node.node_id, available=node.available_resources,
                alive=node.state == NODE_ALIVE)
        self.pending_demand[node.node_id] = payload.get("pending_demand", [])
        # Reply piggy-backs the cluster resource view so raylets can make
        # spillback decisions (replaces the reference's ray_syncer gossip,
        # reference: src/ray/common/ray_syncer/ray_syncer.h).
        return {"ok": True, "cluster": self._cluster_view()}

    def _cluster_view(self):
        return {
            nid: {
                "host": n.host,
                "raylet_port": n.raylet_port,
                "available_resources": n.available_resources,
                "total_resources": n.total_resources,
                "labels": n.labels,
                "transfer_port": n.transfer_port,
                # Same-host peers pull arena-to-arena through shm (one
                # memcpy, no sockets) — see raylet._native_pull.
                "store_path": n.store_path,
                # Raylets must not spill leases onto a DRAINING peer
                # (its object plane stays reachable for pulls).
                "state": n.state,
            }
            for nid, n in self.nodes.items()
            if n.alive
        }

    async def handle_get_all_nodes(self, conn, payload):
        return {"nodes": [n.to_wire() for n in self.nodes.values()]}

    async def handle_drain_node(self, conn, payload):
        """Start a graceful drain: DRAINING in the node table, Drain RPC
        to the raylet (reason + deadline), proactive actor migration.
        Failures PROPAGATE — a caller about to terminate the VM must
        know the node was never told to evacuate (the old handler
        swallowed every error and answered ok)."""
        require_fields(payload, "node_id", method="handle_drain_node")
        node_id = payload["node_id"]
        reason = payload.get("reason") or "manual"
        if reason not in DRAIN_REASONS:
            return {"ok": False, "error": f"unknown drain reason {reason!r} "
                                          f"(expected one of {DRAIN_REASONS})"}
        deadline_s = float(payload.get("deadline_s") or 30.0)
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "error": f"unknown node {node_id[:12]}"}
        if node.state == NODE_DRAINED:
            # Already evacuated (possibly self-drained on SIGTERM and
            # exited): idempotent success, even if the node is dead —
            # checked BEFORE aliveness or a clean self-drain would read
            # as a failed drain to the autoscaler/CLI.
            return {"ok": True, "state": NODE_DRAINED}
        if not node.alive:
            return {"ok": False, "error": f"node {node_id[:12]} is not alive"}
        nconn = self.node_conns.get(node_id)
        if (nconn is None or nconn.closed) and node.state != NODE_SUSPECT:
            # A SUSPECT node has no conn right now but may re-register
            # inside the grace window — _call_node below waits for the
            # rebind, so a drain issued during a flap still lands.
            return {"ok": False,
                    "error": f"no raylet connection to node {node_id[:12]}"}
        already_draining = node.state == NODE_DRAINING
        node.state = NODE_DRAINING
        # A drain overrides suspicion: clear the SUSPECT bookkeeping so a
        # later re-registration doesn't restore a stale pre-drain state.
        node.pre_suspect_state = ""
        node.suspect_since_s = 0.0
        node.drain_reason = reason
        node.drain_deadline_s = deadline_s
        node.drain_stats.setdefault("started_at", time.time())
        self._touch("nodes", node_id)
        self._plane_node_state_notify(node_id, NODE_DRAINING)
        # Placement mirror: stop picking the node for new actors/PGs
        # (the data plane keeps treating it as alive — objects are still
        # being pulled off it).
        if self.native_sched is not None:
            self.native_sched.update_node(node_id, available={}, alive=False)
        def rollback():
            # The raylet never accepted the drain: a node left DRAINING
            # here would be wedged out of placement forever (no
            # _run_drain is running, so DrainComplete never comes).
            if already_draining:
                return
            node.state = NODE_ALIVE
            node.drain_reason = ""
            self._touch("nodes", node_id)
            self._plane_node_state_notify(node_id, NODE_ALIVE)
            if self.native_sched is not None:
                self.native_sched.update_node(
                    node_id, available=node.available_resources,
                    alive=True)

        try:
            resp = await self._call_node(
                node_id, "Drain",
                {"reason": reason, "deadline_s": deadline_s},
                timeout=self.config.rpc_call_timeout_s)
        except Exception as e:
            rollback()
            return {"ok": False,
                    "error": f"drain rpc to raylet {node_id[:12]} failed: {e}"}
        if not resp.get("ok"):
            rollback()
            return {"ok": False,
                    "error": resp.get("error", "raylet refused drain")}
        from ray_tpu_torch.util import events

        events.record("INFO", "gcs", f"node draining ({reason}, "
                      f"deadline {deadline_s:g}s)", node_id=node_id)
        await self.publish("NODE", {"event": "draining", "node_id": node_id,
                                    "reason": reason,
                                    "deadline_s": deadline_s})
        # Proactively restart restartable/named actors elsewhere while
        # the node is still up — callers observe a RESTARTING window,
        # never a dead-actor error. Once per drain: a repeated DrainNode
        # must not race a second migration pass into double-scheduling
        # the same actor (two CreateActors = a forked actor).
        if not already_draining:
            supervised_task(self._migrate_actors_off(node_id, reason))
        return {"ok": True, "state": NODE_DRAINING}

    async def _migrate_actors_off(self, node_id: str, reason: str):
        """Move every restartable (or detached/named) ALIVE actor off a
        draining node before it dies (reference: gcs_actor_manager's
        OnNodeDead reconstruction, run EARLY). Migration must not spend
        the user's failure budget: the incarnation number (restarts)
        bumps so callers reset their per-actor sequence counters, but
        max_restarts is extended to match."""
        node = self.nodes.get(node_id)
        migrated = 0
        for actor_id, a in list(self.actors.items()):
            if a.get("node_id") != node_id or a["state"] != ACTOR_ALIVE:
                continue
            restartable = (a["max_restarts"] == -1
                           or a["restarts"] < a["max_restarts"]
                           or a.get("detached") or a.get("name"))
            if not restartable:
                continue
            addr = a.get("address")
            if addr and len(addr) > 2:
                # Pre-record the current worker as dead so the eventual
                # death report from the raylet (kill below, or node
                # death) dedupes instead of consuming another restart.
                a.setdefault("dead_worker_ids", set()).add(addr[2])
            a["restarts"] += 1
            if a["max_restarts"] >= 0:
                a["max_restarts"] += 1  # migration is not a failure
            a["migrations"] = a.get("migrations", 0) + 1
            a["state"] = ACTOR_RESTARTING
            a["address"] = None
            self._touch("actors", actor_id)
            self.mark_dirty(("actors",))
            await self.publish("ACTOR", {
                "actor_id": actor_id, "state": ACTOR_RESTARTING,
                "reason": f"migrating off draining node ({reason})"})
            try:
                await self._call_node(
                    node_id, "KillActorWorker", {"actor_id": actor_id},
                    timeout=self.config.rpc_call_timeout_s)
            except Exception:
                pass  # node may die mid-drain; reschedule regardless
            migrated += 1
            supervised_task(self._schedule_actor(actor_id))
        if node is not None and migrated:
            node.drain_stats["migrated_actors"] = \
                node.drain_stats.get("migrated_actors", 0) + migrated
            self._touch("nodes", node_id)
            logger.info("migrated %d actor(s) off draining node %s",
                        migrated, node_id[:8])

    def _note_relocations(self, relocations: dict) -> None:
        for oid_hex, nid in relocations.items():
            if oid_hex not in self.object_relocations:
                self._relocation_order.append(oid_hex)
            self.object_relocations[oid_hex] = nid
        while len(self._relocation_order) > self._relocation_cap:
            self.object_relocations.pop(self._relocation_order.popleft(),
                                        None)

    async def handle_drain_complete(self, conn, payload):
        """The raylet finished evacuating: DRAINED in the node table,
        relocated-object directory updated, stats recorded. From here
        the node's death is expected and cheap."""
        require_fields(payload, "node_id", method="handle_drain_complete")
        node_id = payload["node_id"]
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "error": f"unknown node {node_id[:12]}"}
        self._note_relocations(payload.get("relocations") or {})
        node.state = NODE_DRAINED
        self._plane_node_state_notify(node_id, NODE_DRAINED)
        stats = dict(payload.get("stats") or {})
        # Merge: migrated_actors is GCS-side accounting, the rest is the
        # raylet's evacuation report.
        node.drain_stats.update(stats)
        self._touch("nodes", node_id)
        from ray_tpu_torch.util import events

        events.record("INFO", "gcs", "node drained", node_id=node_id,
                      **{k: v for k, v in stats.items()
                         if isinstance(v, (int, float))})
        logger.info("node %s DRAINED (%s): %s", node_id[:8],
                    node.drain_reason or "?", node.drain_stats)
        await self.publish("NODE", {"event": "drained", "node_id": node_id,
                                    "stats": node.drain_stats})
        return {"ok": True, "state": NODE_DRAINED}

    async def handle_get_object_relocations(self, conn, payload):
        """Owner-side lookup: where did evacuated copies of these
        objects land? (Consulted before lineage reconstruction.)"""
        out = {}
        for oid_hex in payload.get("object_ids") or []:
            nid = self.object_relocations.get(oid_hex)
            if nid is not None:
                node = self.nodes.get(nid)
                if node is not None and node.alive:
                    out[oid_hex] = nid
        return {"relocations": out}

    async def handle_notify_node_dead(self, conn, payload):
        require_fields(payload, "node_id", method="handle_notify_node_dead")
        await self._mark_node_dead(payload["node_id"], payload.get("reason", "reported dead"))
        return {"ok": True}

    async def _on_node_conn_lost(self, node_id: str, conn=None):
        # Connection loss is a SUSPICION, not a death certificate: a
        # network flap or a GCS-side socket hiccup looks identical to a
        # crashed raylet at this layer. Mark the node SUSPECT (out of NEW
        # placement, nothing migrated) and let the heartbeat-timeout
        # expiry in _health_check_loop issue the actual death.
        if conn is not None and self.node_conns.get(node_id) is not conn:
            # A stale conn's close callback fired after the raylet
            # already re-registered over a fresh connection — suspecting
            # the healthy node now would be a false positive.
            return
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        if node.state == NODE_DRAINED:
            # An evacuated node hanging up is its expected exit — keep
            # the clean-removal path instead of a pointless grace window.
            await self._mark_node_dead(node_id, "raylet connection lost")
            return
        if node.state == NODE_SUSPECT:
            return
        node.pre_suspect_state = node.state
        node.state = NODE_SUSPECT
        node.suspect_since_s = time.time()
        # The plane parks (not forks) any in-flight create aimed at a
        # SUSPECT node: re-driven on reconnection, failed over on DEAD.
        self._plane_node_state_notify(node_id, NODE_SUSPECT)
        self.node_conns.pop(node_id, None)
        if self.native_sched is not None:
            self.native_sched.update_node(node_id, available={}, alive=False)
        self._touch("nodes", node_id)
        from ray_tpu_torch.util import events

        grace = (self.config.health_check_period_s
                 * self.config.num_heartbeats_timeout)
        logger.info(
            "node %s connection lost: SUSPECT (grace %.1fs before "
            "promotion to DEAD)", node_id[:8], grace)
        events.record("INFO", "gcs", "node suspect: connection lost",
                      node_id=node_id)
        await self.publish("NODE", {"event": "suspect",
                                    "node": node.to_wire()})

    async def _mark_node_dead(self, node_id: str, reason: str):
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        drained = node.state == NODE_DRAINED
        node.alive = False
        node.state = NODE_DEAD if not drained else NODE_DRAINED
        node.available_resources = {}
        if self._actor_plane is not None:
            # The plane fails over its own in-flight creates (restart
            # bookkeeping + reschedule, narrated via inject events) —
            # BEFORE the loop below, whose skip of native PENDING actors
            # relies on the plane owning them.
            try:
                self._actor_plane.node_down(node_id)
            except Exception:
                logger.exception("native actor plane node_down failed")
        self.node_conns.pop(node_id, None)
        self._node_call_sessions.pop(node_id, None)
        if self.native_sched is not None:
            self.native_sched.update_node(node_id, available={}, alive=False)
        self.pending_demand.pop(node_id, None)
        self._touch("nodes", node_id)
        self.mark_dirty(("nodes", "actors", "placement_groups"))
        from ray_tpu_torch.util import events

        if drained:
            # Expected death of an evacuated node: a non-event, not a
            # failure (no ERROR record, no unexpected-death log).
            logger.info("drained node %s removed cleanly (%s)",
                        node_id[:8], reason)
            events.record("INFO", "gcs", "drained node removed",
                          node_id=node_id)
        else:
            logger.warning("node %s dead: %s", node_id[:8], reason)
            events.record("ERROR", "gcs", f"node dead: {reason}",
                          node_id=node_id)
        await self.publish("NODE", {"event": "dead", "node_id": node_id,
                                    "reason": reason, "drained": drained})
        # Actor fault tolerance: restart or kill actors that lived there
        # (reference: gcs_actor_manager.cc OnNodeDead). On a DRAINED
        # node every restartable actor migrated before death; anything
        # left goes through the normal path with a drain-flavored cause.
        for actor_id, a in list(self.actors.items()):
            if a.get("node_id") == node_id and a["state"] in (ACTOR_ALIVE, ACTOR_PENDING):
                if a.get("native") and a["state"] == ACTOR_PENDING:
                    # In-flight native create: the node_down call above
                    # already failed it over inside the plane (restart
                    # consumed there); running the Python path too would
                    # double-count the restart.
                    continue
                await self._on_actor_worker_death(
                    actor_id,
                    f"node {node_id[:8]} drained and removed" if drained
                    else f"node {node_id[:8]} died: {reason}")
        for pg_id, pg in self.placement_groups.items():
            if pg["state"] == PG_CREATED and any(
                    b.get("node_id") == node_id for b in pg["bundles"]):
                supervised_task(self._schedule_pg(pg_id))

    async def _health_check_loop(self):
        # reference: gcs_health_check_manager.h:39 — gRPC health checks with
        # knobs from ray_config_def.h:813-819. Here: heartbeat staleness.
        period = self.config.health_check_period_s
        timeout = period * self.config.num_heartbeats_timeout
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node in list(self.nodes.values()):
                # Heads are exempt from heartbeat policing (the GCS lives
                # there) — EXCEPT once SUSPECT: a head whose connection
                # died and never came back must still be promoted.
                if node.alive and \
                        (not node.is_head or node.state == NODE_SUSPECT) \
                        and now - node.last_heartbeat > timeout:
                    reason = ("suspect grace expired (connection lost, "
                              "no re-registration)"
                              if node.state == NODE_SUSPECT
                              else "heartbeat timeout")
                    await self._mark_node_dead(node.node_id, reason)

    # ---------- KV ----------

    async def handle_kv_put(self, conn, payload):
        require_fields(payload, "key", "value", method="handle_kv_put")
        ns = payload.get("ns", "")
        table = self.kv[ns]
        key = payload["key"]
        if not payload.get("overwrite", True) and key in table:
            return {"added": False}
        table[key] = payload["value"]
        self._touch("kv", (ns, key))
        return {"added": True}

    async def handle_kv_get(self, conn, payload):
        require_fields(payload, "key", method="handle_kv_get")
        return {"value": self.kv[payload.get("ns", "")].get(payload["key"])}

    async def handle_kv_del(self, conn, payload):
        require_fields(payload, "key", method="handle_kv_del")
        existed = self.kv[payload.get("ns", "")].pop(payload["key"], None) is not None
        if existed:
            self._touch("kv", (payload.get("ns", ""), payload["key"]))
        return {"deleted": existed}

    async def handle_kv_keys(self, conn, payload):
        prefix = payload.get("prefix", b"")
        return {"keys": [k for k in self.kv[payload.get("ns", "")] if k.startswith(prefix)]}

    async def handle_kv_exists(self, conn, payload):
        require_fields(payload, "key", method="handle_kv_exists")
        return {"exists": payload["key"] in self.kv[payload.get("ns", "")]}

    # ---------- actors ----------

    async def handle_register_actor(self, conn, payload):
        """Register + schedule an actor (reference: gcs_actor_manager.cc
        RegisterActor → GcsActorScheduler)."""
        require_fields(payload, "actor_id", "spec",
                       method="handle_register_actor")
        actor_id = payload["actor_id"]
        spec = payload["spec"]
        name = payload.get("name") or ""
        namespace = payload.get("namespace") or "default"
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing is not None and existing["state"] != ACTOR_DEAD:
                    if payload.get("get_if_exists"):
                        return {"ok": True, "existing": True, "actor_id": self.named_actors[key]}
                    return {"ok": False,
                            "reason": f"actor name {name!r} already taken in {namespace!r}"}
            self.named_actors[key] = actor_id
            self._touch("named_actors", key)
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "job_id": payload.get("job_id", ""),
            "name": name,
            "namespace": namespace,
            "class_name": payload.get("class_name", ""),
            "state": ACTOR_PENDING,
            "spec": spec,
            "resources": normalize_resources(payload.get("resources")),
            "max_restarts": payload.get("max_restarts", 0),
            "restarts": 0,
            "node_id": None,
            "address": None,
            "detached": payload.get("detached", False),
            "owner": payload.get("owner"),
            "death_cause": None,
            "strategy": payload.get("strategy"),
            "placement_group": payload.get("placement_group", ""),
            "pg_bundle_index": payload.get("pg_bundle_index", -1),
        }
        self._touch("actors", actor_id)
        self._record_task_event(
            self._creation_task_id(actor_id, spec), payload.get("class_name", ""),
            "CREATE_REGISTERED", job_id=payload.get("job_id", ""),
            actor_id=actor_id)
        supervised_task(self._schedule_actor(actor_id))
        return {"ok": True}

    def _pick_node_for(self, resources: dict, strategy=None,
                       pg_id: str = "", bundle_index: int = -1) -> str | None:
        """Node selection for actors/PGs at the GCS (raylets do their own
        hybrid policy for tasks). Mirrors the reference's GcsActorScheduler
        falling back onto raylet scheduling."""
        # DRAINING/DRAINED nodes take no new placements (their native-
        # scheduler mirror is already marked dead at drain start).
        alive = [n for n in self.nodes.values()
                 if n.alive and n.state == NODE_ALIVE]
        if strategy and strategy[0] == "node_affinity":
            target, soft = strategy[1], strategy[2]
            node = self.nodes.get(target)
            if node is not None and node.alive and node.state == NODE_ALIVE:
                return target
            if not soft:
                return None
        if pg_id:
            pg = self.placement_groups.get(pg_id)
            if not pg or pg["state"] != PG_CREATED:
                return None
            bundles = pg["bundles"]
            if bundle_index >= 0:
                return bundles[bundle_index].get("node_id")
            for b in bundles:
                node = self.nodes.get(b.get("node_id") or "")
                if node and node.alive and resources_fit(b["available"], resources):
                    return b["node_id"]
            return None
        if self.native_sched is not None:
            strat = "spread" if (strategy and strategy[0] == "spread") else "pack"
            return self.native_sched.pick_node(resources, strat,
                                               fallback_total=True)
        candidates = [n for n in alive if resources_fit(n.available_resources, resources)]
        if not candidates:
            # Fall back to nodes that could EVER fit (total resources) —
            # the raylet will queue the lease until resources free up.
            candidates = [n for n in alive if resources_fit(n.total_resources, resources)]
        if not candidates:
            return None
        if strategy and strategy[0] == "spread":
            candidates.sort(key=lambda n: sum(
                n.total_resources.get(k, 0) - n.available_resources.get(k, 0)
                for k in ("CPU", "TPU", "GPU")))
            return candidates[0].node_id
        # Default: pack onto the most-utilized node that fits (hybrid-ish).
        candidates.sort(key=lambda n: -sum(
            n.total_resources.get(k, 0) - n.available_resources.get(k, 0)
            for k in ("CPU", "TPU", "GPU")))
        return candidates[0].node_id

    async def _schedule_actor(self, actor_id: str, delay: float = 0.0):
        if delay:
            await asyncio.sleep(delay)
        a = self.actors.get(actor_id)
        if a is None or a["state"] == ACTOR_DEAD:
            return
        # Resource-less actors hold nothing while alive, but placement still
        # charges 1 CPU so creations spread and land on feasible nodes
        # (reference: actor creation schedules against num_cpus=1, runs
        # against num_cpus=0).
        placement_demand = a["resources"]
        if not placement_demand and not a.get("placement_group"):
            placement_demand = {"CPU": 1.0}
        node_id = self._pick_node_for(
            placement_demand, a.get("strategy"), a.get("placement_group", ""),
            a.get("pg_bundle_index", -1))
        if node_id is None or node_id not in self.node_conns:
            # No feasible node right now; retry (autoscaler demand signal).
            supervised_task(self._schedule_actor(actor_id, delay=0.5))
            return
        # Transient debit of the placement demand against the GCS view: a
        # burst of concurrent creations fans out across nodes instead of
        # herding onto one stale "best" node. The next heartbeat from the
        # raylet restores ground truth (real holds are debited there).
        node = self.nodes.get(node_id)
        if node is not None:
            subtract_resources(node.available_resources, placement_demand)
        if self.native_sched is not None:
            self.native_sched.debit_node(node_id, placement_demand)
        a["node_id"] = node_id
        self.mark_dirty(("actors",))
        self._record_task_event(
            self._creation_task_id(actor_id, a["spec"]), a["class_name"],
            "CREATE_SCHEDULED", job_id=a.get("job_id", ""),
            actor_id=actor_id, target_node=node_id)
        try:
            # _call_node, not a raw conn.call: a socket flap mid-create
            # replays the request after the raylet re-registers, and the
            # raylet's reply cache guarantees the actor is created at
            # most once (a forked actor is the worst control-plane bug).
            resp = await self._call_node(
                node_id, "CreateActor",
                {"actor_id": actor_id, "spec": a["spec"], "resources": a["resources"],
                 "placement_group": a.get("placement_group", ""),
                 "pg_bundle_index": a.get("pg_bundle_index", -1)},
                timeout=self.config.rpc_call_timeout_s)
            if not resp.get("ok"):
                reason = resp.get("reason", "creation failed")
                if "draining" in reason:
                    # Creation raced a drain: not a failure, just pick a
                    # different node — consuming a restart here would
                    # spend the user's budget on an infrastructure event.
                    logger.info("actor %s creation bounced off draining "
                                "node %s; rescheduling", actor_id[:8],
                                node_id[:8])
                    supervised_task(
                        self._schedule_actor(actor_id, delay=0.2))
                    return
                logger.warning("actor %s creation on node %s failed: %s",
                               actor_id[:8], node_id[:8], reason)
                await self._on_actor_worker_death(actor_id, reason)
        except Exception as e:
            logger.warning("actor %s creation rpc to node %s failed: %s",
                           actor_id[:8], node_id[:8], e)
            await self._on_actor_worker_death(actor_id, f"creation rpc failed: {e}")

    async def handle_actor_ready(self, conn, payload):
        require_fields(payload, "actor_id", "address",
                       method="handle_actor_ready")
        a = self.actors.get(payload["actor_id"])
        if a is None:
            return {"ok": False}
        a["state"] = ACTOR_ALIVE
        a["address"] = payload["address"]
        self._touch("actors", payload["actor_id"])
        self._record_task_event(
            self._creation_task_id(payload["actor_id"], a["spec"]),
            a["class_name"], "CREATE_READY", job_id=a.get("job_id", ""),
            actor_id=payload["actor_id"])
        # restarts doubles as the incarnation number: callers reset their
        # per-actor sequence numbers when it changes (reference: the client
        # queue resend path in direct_actor_task_submitter).
        await self.publish("ACTOR", {"actor_id": a["actor_id"], "state": ACTOR_ALIVE,
                                     "address": a["address"],
                                     "restarts": a["restarts"]})
        return {"ok": True}

    async def handle_report_actor_death(self, conn, payload):
        # Dedupe: a single worker death can surface through several signals
        # (process reap, socket close); only the first report per worker
        # may consume a restart (reference: ReconstructActor checks the
        # dead worker matches the actor's current incarnation).
        require_fields(payload, "actor_id", method="handle_report_actor_death")
        a = self.actors.get(payload["actor_id"])
        wid = payload.get("worker_id")
        if a is not None and wid:
            seen = a.setdefault("dead_worker_ids", set())
            if wid in seen:
                return {"ok": True}
            seen.add(wid)
        await self._on_actor_worker_death(payload["actor_id"],
                                          payload.get("reason", "worker died"),
                                          intended=payload.get("intended", False))
        return {"ok": True}

    async def _on_actor_worker_death(self, actor_id: str, reason: str, intended: bool = False):
        """reference: gcs_actor_manager.h:504 ReconstructActor — restart with
        backoff while restarts remain, else mark DEAD and notify callers."""
        a = self.actors.get(actor_id)
        if a is None or a["state"] == ACTOR_DEAD:
            return
        if a.pop("native", None) and self._actor_plane is not None:
            # Python takes over this actor's lifecycle (post-create
            # death, kill, node failure of an ALIVE actor): the plane
            # must drop its record or a later node event would make it
            # act on a ghost.
            try:
                self._actor_plane.actor_forget(actor_id)
            except Exception:
                logger.exception("native actor plane forget failed")
        can_restart = (not intended) and (
            a["max_restarts"] == -1 or a["restarts"] < a["max_restarts"])
        logger.info("actor %s worker died (%s), restart=%s (%d/%s)",
                    actor_id[:8], reason, can_restart, a["restarts"],
                    a["max_restarts"])
        if can_restart:
            a["restarts"] += 1
            a["state"] = ACTOR_RESTARTING
            a["address"] = None
            self._touch("actors", actor_id)
            self.mark_dirty(("actors",))
            await self.publish("ACTOR", {"actor_id": actor_id, "state": ACTOR_RESTARTING,
                                         "reason": reason})
            supervised_task(self._schedule_actor(actor_id))
        else:
            a["state"] = ACTOR_DEAD
            self.mark_dirty(("actors", "named_actors"))
            a["address"] = None
            a["death_cause"] = reason
            self.named_actors.pop((a["namespace"], a["name"]), None)
            self._touch("actors", actor_id)
            self._touch("named_actors", (a["namespace"], a["name"]))
            from ray_tpu_torch.util import events

            events.record("WARNING", "gcs", "actor dead",
                          actor_id=actor_id)
            await self.publish("ACTOR", {"actor_id": actor_id, "state": ACTOR_DEAD,
                                         "reason": reason})

    async def handle_get_actor_info(self, conn, payload):
        require_fields(payload, "actor_id", method="handle_get_actor_info")
        if self.recovering and payload["actor_id"] not in self.actors:
            aid_hex = payload["actor_id"].encode().hex()
            self._recovery_faultin(
                lambda it: it[0] == "actors" and it[1] == aid_hex)
        a = self.actors.get(payload["actor_id"])
        if a is None:
            return {"found": False}
        return {"found": True, "state": a["state"], "address": a["address"],
                "death_cause": a["death_cause"], "restarts": a["restarts"],
                "class_name": a["class_name"], "name": a["name"]}

    async def handle_get_named_actor(self, conn, payload):
        require_fields(payload, "name", method="handle_get_named_actor")
        key = (payload.get("namespace") or "default", payload["name"])
        if self.recovering and key not in self.named_actors:
            # The name index and its target row may both still be on
            # the stream: fault in the index, then the actor it names.
            self._recovery_faultin(lambda it: it[0] == "named_actors")
            target = self.named_actors.get(key)
            if target is not None and target not in self.actors:
                t_hex = target.encode().hex()
                self._recovery_faultin(
                    lambda it: it[0] == "actors" and it[1] == t_hex)
        actor_id = self.named_actors.get(key)
        if actor_id is None or actor_id not in self.actors:
            return {"found": False}
        a = self.actors[actor_id]
        return {"found": True, "actor_id": actor_id, "state": a["state"],
                "address": a["address"], "spec_meta": a["spec"].get("meta")
                if isinstance(a["spec"], dict) else None}

    async def handle_list_actors(self, conn, payload):
        if self.recovering:
            self._recovery_faultin(lambda it: it[0] == "actors")
        return {"actors": [
            {k: a[k] for k in ("actor_id", "job_id", "name", "namespace", "class_name",
                               "state", "node_id", "restarts", "resources")}
            for a in self.actors.values()]}

    async def handle_kill_actor(self, conn, payload):
        require_fields(payload, "actor_id", method="handle_kill_actor")
        actor_id = payload["actor_id"]
        if self.recovering and actor_id not in self.actors:
            aid_hex = actor_id.encode().hex()
            self._recovery_faultin(
                lambda it: it[0] == "actors" and it[1] == aid_hex)
        a = self.actors.get(actor_id)
        if a is None:
            return {"ok": False}
        no_restart = payload.get("no_restart", True)
        if no_restart:
            a["max_restarts"] = a["restarts"]  # exhaust restarts
        node_id = a.get("node_id")
        if node_id in self.node_conns:
            try:
                await self._call_node(
                    node_id, "KillActorWorker", {"actor_id": actor_id},
                    timeout=self.config.rpc_call_timeout_s)
            except Exception:
                # Best-effort: the raylet may already be tearing the
                # worker down; the death path below is authoritative.
                logger.warning("kill_actor(%s): KillActorWorker rpc to "
                               "node %s failed", actor_id[:8], node_id[:8],
                               exc_info=True)
        if a["state"] != ACTOR_DEAD and no_restart:
            await self._on_actor_worker_death(actor_id, "killed via kill()", intended=True)
        return {"ok": True}

    # ---------- jobs ----------

    async def handle_register_job(self, conn, payload):
        require_fields(payload, "job_id", method="handle_register_job")
        if payload.get("owns_cluster"):
            # This driver started the session (local mode): the whole tree
            # dies with it — GCS exits, raylets exit on GCS loss, workers
            # exit on raylet loss.  Prevents orphaned daemons when the
            # driver is killed (reference: ray.init() local session
            # lifetime is the driver's lifetime).
            loop = asyncio.get_running_loop()

            def _driver_gone():
                import os

                logger.warning("owning driver for job %s disconnected; "
                               "shutting down session", payload["job_id"][:8])
                loop.call_later(0.2, lambda: os._exit(0))

            conn.on_close(_driver_gone)
        self.jobs[payload["job_id"]] = {
            "job_id": payload["job_id"],
            "driver_address": payload.get("driver_address"),
            "start_time": time.time(),
            "end_time": None,
            "status": "RUNNING",
            "entrypoint": payload.get("entrypoint", ""),
        }
        self._touch("jobs", payload["job_id"])
        return {"ok": True}

    async def handle_finish_job(self, conn, payload):
        require_fields(payload, "job_id", method="handle_finish_job")
        if self.recovering and payload["job_id"] not in self.jobs:
            jid_hex = payload["job_id"].encode().hex()
            self._recovery_faultin(
                lambda it: it[0] == "jobs" and it[1] == jid_hex)
        job = self.jobs.get(payload["job_id"])
        if job:
            job["status"] = payload.get("status", "SUCCEEDED")
            job["end_time"] = time.time()
            self._touch("jobs", payload["job_id"])
        # Raylets release the job's runtime-env references on this event
        # (reference: runtime-env URI GC when the last referencing job
        # exits, runtime_env ARCHITECTURE.md).
        await self.publish("JOB", {"event": "finished",
                                   "job_id": payload["job_id"]})
        return {"ok": True}

    async def handle_list_jobs(self, conn, payload):
        if self.recovering:
            self._recovery_faultin(lambda it: it[0] == "jobs")
        return {"jobs": list(self.jobs.values())}

    # ---------- placement groups ----------

    async def handle_create_pg(self, conn, payload):
        require_fields(payload, "bundles", "pg_id", method="handle_create_pg")
        pg_id = payload["pg_id"]
        bundles = [{"resources": normalize_resources(b), "node_id": None, "available": {}}
                   for b in payload["bundles"]]
        self.placement_groups[pg_id] = {
            "pg_id": pg_id,
            "name": payload.get("name", ""),
            "strategy": payload.get("strategy", "PACK"),
            "bundles": bundles,
            "state": PG_PENDING,
            "job_id": payload.get("job_id", ""),
        }
        self._touch("placement_groups", pg_id)
        supervised_task(self._schedule_pg(pg_id))
        return {"ok": True}

    async def _schedule_pg(self, pg_id: str, delay: float = 0.0):
        """2-phase bundle reservation (reference:
        gcs_placement_group_scheduler.cc Prepare/Commit) with PACK / SPREAD /
        STRICT_PACK / STRICT_SPREAD and the TPU-first STRICT_ICI strategy:
        all bundles must land on nodes of one ICI-connected slice (same
        `tpu-slice` label), the gang-lease unit for multi-host TPU pods."""
        if delay:
            await asyncio.sleep(delay)
        pg = self.placement_groups.get(pg_id)
        if pg is None or pg["state"] != PG_PENDING:
            return
        placement = self._pack_bundles(pg)
        if placement is None:
            supervised_task(self._schedule_pg(pg_id, delay=0.5))
            return
        # Prepare on all nodes.
        prepared = []
        ok = True
        for idx, node_id in placement:
            if node_id not in self.node_conns:
                ok = False
                break
            try:
                resp = await self._call_node(node_id, "PreparePGBundle", {
                    "pg_id": pg_id, "bundle_index": idx,
                    "resources": pg["bundles"][idx]["resources"]})
                if not resp.get("ok"):
                    ok = False
                    break
                prepared.append((idx, node_id))
            except Exception:
                ok = False
                break
        if not ok:
            for idx, node_id in prepared:
                try:
                    await self._call_node(
                        node_id, "ReturnPGBundle",
                        {"pg_id": pg_id, "bundle_index": idx})
                except Exception:
                    pass
            supervised_task(self._schedule_pg(pg_id, delay=0.5))
            return
        for idx, node_id in placement:
            try:
                await self._call_node(
                    node_id, "CommitPGBundle",
                    {"pg_id": pg_id, "bundle_index": idx})
            except Exception:
                pass
            pg["bundles"][idx]["node_id"] = node_id
            pg["bundles"][idx]["available"] = dict(pg["bundles"][idx]["resources"])
        pg["state"] = PG_CREATED
        self.mark_dirty(("placement_groups",))
        await self.publish("PG", {"pg_id": pg_id, "state": PG_CREATED,
                                  "bundles": [(b["node_id"]) for b in pg["bundles"]]})

    def _pack_bundles(self, pg) -> list[tuple[int, str]] | None:
        """Returns [(bundle_index, node_id)] or None if infeasible now."""
        strategy = pg["strategy"]
        if self.native_sched is not None:
            got = self.native_sched.schedule_bundles(
                [b["resources"] for b in pg["bundles"]], strategy)
            if got is None:
                return None
            return list(enumerate(got))
        alive = [n for n in self.nodes.values()
                 if n.alive and n.state == NODE_ALIVE]
        if strategy == "STRICT_ICI":
            # Group nodes by slice label; try each slice as a unit.
            slices: dict[str, list[NodeInfo]] = defaultdict(list)
            for n in alive:
                label = n.labels.get("tpu-slice")
                if label:
                    slices[label].append(n)
            for nodes in slices.values():
                placement = self._fit_bundles(pg["bundles"], nodes, spread=False)
                if placement is not None:
                    return placement
            return None
        if strategy in ("SPREAD", "STRICT_SPREAD"):
            placement = self._fit_bundles(pg["bundles"], alive, spread=True,
                                          strict=strategy == "STRICT_SPREAD")
            return placement
        if strategy == "STRICT_PACK":
            for n in sorted(alive, key=lambda n: -sum(n.available_resources.values())):
                placement = self._fit_bundles(pg["bundles"], [n], spread=False)
                if placement is not None:
                    return placement
            return None
        return self._fit_bundles(pg["bundles"], alive, spread=False)

    def _fit_bundles(self, bundles, nodes, spread: bool, strict: bool = False):
        avail = {n.node_id: dict(n.available_resources) for n in nodes}
        order = list(nodes)
        placement = []
        used_nodes = set()
        for idx, b in enumerate(bundles):
            res = b["resources"]
            placed = False
            if spread:
                order.sort(key=lambda n: len([1 for i, nid in placement if nid == n.node_id]))
            for n in order:
                if strict and n.node_id in used_nodes:
                    continue
                if resources_fit(avail[n.node_id], res):
                    subtract_resources(avail[n.node_id], res)
                    placement.append((idx, n.node_id))
                    used_nodes.add(n.node_id)
                    placed = True
                    break
            if not placed:
                return None
        return placement

    def _faultin_pg(self, pg_id: str) -> None:
        if self.recovering and pg_id not in self.placement_groups:
            pid_hex = pg_id.encode().hex()
            self._recovery_faultin(
                lambda it: it[0] == "placement_groups" and it[1] == pid_hex)

    async def handle_remove_pg(self, conn, payload):
        require_fields(payload, "pg_id", method="handle_remove_pg")
        self._faultin_pg(payload["pg_id"])
        pg = self.placement_groups.get(payload["pg_id"])
        if pg is None:
            return {"ok": False}
        for idx, b in enumerate(pg["bundles"]):
            node_id = b.get("node_id")
            if node_id and node_id in self.node_conns:
                try:
                    await self._call_node(
                        node_id, "ReturnPGBundle",
                        {"pg_id": pg["pg_id"], "bundle_index": idx})
                except Exception:
                    # A dead raylet frees its bundles via node-death
                    # cleanup; log so a live one failing is visible.
                    logger.warning("remove_pg(%s): ReturnPGBundle %d on "
                                   "node %s failed", pg["pg_id"][:8], idx,
                                   node_id[:8], exc_info=True)
        pg["state"] = PG_REMOVED
        self._touch("placement_groups", payload["pg_id"])
        # Waiters on ready() promises fail instead of hanging forever.
        await self.publish("PG", {"pg_id": payload["pg_id"],
                                  "state": PG_REMOVED})
        return {"ok": True}

    async def handle_get_pg(self, conn, payload):
        require_fields(payload, "pg_id", method="handle_get_pg")
        self._faultin_pg(payload["pg_id"])
        pg = self.placement_groups.get(payload["pg_id"])
        if pg is None:
            return {"found": False}
        return {"found": True, "state": pg["state"],
                "bundles": [{"node_id": b["node_id"], "resources": b["resources"]}
                            for b in pg["bundles"]],
                "strategy": pg["strategy"], "name": pg["name"]}

    async def handle_list_pgs(self, conn, payload):
        if self.recovering:
            self._recovery_faultin(lambda it: it[0] == "placement_groups")
        return {"placement_groups": [
            {"pg_id": pg["pg_id"], "name": pg["name"], "state": pg["state"],
             "strategy": pg["strategy"],
             "bundles": [{"node_id": b["node_id"], "resources": b["resources"]}
                         for b in pg["bundles"]]}
            for pg in self.placement_groups.values()]}

    # ---------- task events / status ----------

    def _record_task_event(self, task_id: str, name: str, state: str,
                           **extra) -> None:
        """GCS-side lifecycle stamp (actor CREATE stages): lands in the
        same task-event table worker stamps flush into, keyed by the
        creation task id so the per-actor ladder merges with the
        executing worker's ARGS_FETCHED/RUNNING/FINISHED stamps."""
        ev = {"task_id": task_id, "name": name, "state": state,
              "node_id": "gcs", "worker_id": "gcs",
              "job_id": extra.pop("job_id", ""), "ts": time.time()}
        if extra:
            ev.update(extra)
        self.task_events.append(ev)

    @staticmethod
    def _creation_task_id(actor_id: str, spec_wire) -> str:
        # TaskSpec.to_wire is a list with task_id first; fall back to the
        # actor id for exotic/legacy spec payloads.
        if isinstance(spec_wire, (list, tuple)) and spec_wire \
                and isinstance(spec_wire[0], str):
            return spec_wire[0]
        return actor_id

    async def handle_add_task_events(self, conn, payload):
        require_fields(payload, "events", method="handle_add_task_events")
        self.task_events.extend(payload["events"])
        return {"ok": True}

    async def handle_list_task_events(self, conn, payload):
        limit = payload.get("limit", 1000)
        events = list(self.task_events)[-limit:]
        return {"events": events}

    async def handle_get_cluster_status(self, conn, payload):
        return {
            "nodes": [n.to_wire() for n in self.nodes.values()],
            "pending_demand": [d for demands in self.pending_demand.values()
                               for d in demands],
            "pending_placement_groups": [
                {"strategy": pg["strategy"],
                 "bundles": [b["resources"] for b in pg["bundles"]]}
                for pg in self.placement_groups.values()
                if pg["state"] == PG_PENDING],
            "actors": len([a for a in self.actors.values() if a["state"] == ACTOR_ALIVE]),
            "placement_groups": len([p for p in self.placement_groups.values()
                                     if p["state"] == PG_CREATED]),
            "uptime_s": time.time() - self.start_time,
            "suspect_nodes": len([n for n in self.nodes.values()
                                  if n.state == NODE_SUSPECT]),
            "rpc_sessions": rpc.session_stats(),
            "native_control": self._native_control_stats(),
            "fanout": dict(self._fanout_stats),
            # Top-level packages this daemon has loaded (what a port
            # process may not load — jax, ray_tpu, msgpack — is checked
            # against this).
            "loaded_packages": loaded_packages(),
            "recovering": self.recovering,
            "recovery": dict(self._recovery_stats,
                             backlog_rows=len(self._recovery_backlog)),
        }

    def _native_control_stats(self):
        if self._actor_plane is None:
            return None
        plane = self._actor_plane
        handled, fallthrough, deduped = plane.counters()
        methods = {}
        for m in ("RegisterActor", "ActorReady"):
            mh, mr, md = plane.method_stats(m)
            methods[m] = {"handled": mh, "routed": mr, "degraded": md}
        return {
            "handled_total": handled,
            # Frames the plane looked at but routed to Python (complex
            # shapes, transient no-node states, unknown actors).
            "native_fallthrough_total": fallthrough,
            "deduped_requests_total": deduped,
            "actors": plane.actor_count(),
            "sessions": plane.session_count(),
            "proto_errors": plane.proto_errors(),
            # Replayed pre-restart frames rejected by the epoch handshake
            # (clients re-issue; never wrongly deduped against the lost
            # reply cache).
            "stale_epoch_rejections_total": plane.stale_epoch_total(),
            # Frames the divergence breaker pushed back to Python.
            "native_degraded_total": plane.degraded_total(),
            "divergence_trips_total": self._native_divergence_trips,
            "degraded_reason": self._native_degraded_reason,
            "methods": methods,
        }

    # ---------- native mirror audit (divergence breaker) ----------

    async def _native_audit_loop(self):
        """Periodically compare the Python mirror with the native
        plane's tables. Two consecutive mismatched sweeps (in-flight
        ladders make single-sweep skew normal) or a proto-error burst
        trips the breaker: the plane's owned methods degrade to the
        Python handlers (counted native_degraded_total) and stay there —
        re-arming needs an operator restart, because a real divergence
        must be understood, not retried."""
        period = max(1.0, self.config.health_check_period_s)
        prev_mismatch = ""
        while True:
            await asyncio.sleep(period)
            plane = self._actor_plane
            if plane is None or self._native_degraded_reason:
                return
            try:
                proto = plane.proto_errors()
                burst = proto - self._audit_proto_seen >= 10
                self._audit_proto_seen = proto
                mismatch = self._native_mirror_mismatch(plane)
                if burst:
                    self._trip_native_breaker(
                        f"proto-error burst ({proto} total)")
                elif mismatch and prev_mismatch:
                    self._trip_native_breaker(mismatch)
                prev_mismatch = mismatch
            except Exception:
                logger.exception("native mirror audit sweep failed")

    def _native_mirror_mismatch(self, plane) -> str:
        """One audit sweep; returns a divergence description or ''."""
        py_native = {aid: a for aid, a in self.actors.items()
                     if a.get("native") and a["state"] != ACTOR_DEAD}
        n_plane = plane.actor_count()
        if n_plane != len(py_native):
            return (f"actor-count divergence: plane={n_plane} "
                    f"mirror={len(py_native)}")
        for aid, a in py_native.items():
            pstate = plane.actor_state(aid)
            if pstate is None:
                return f"actor {aid[:8]} missing from native plane"
            # ALIVE in the mirror comes only from the plane's own ready
            # event, so the plane must agree; PENDING/RESTARTING can
            # legitimately lag one event behind.
            if a["state"] == ACTOR_ALIVE and pstate != "ALIVE":
                return (f"actor {aid[:8]} state divergence: "
                        f"plane={pstate} mirror=ALIVE")
        return ""

    def _trip_native_breaker(self, reason: str) -> None:
        plane = self._actor_plane
        if plane is None or self._native_degraded_reason:
            return
        self._native_degraded_reason = reason
        self._native_divergence_trips += 1
        for m in ("RegisterActor", "ActorReady"):
            try:
                plane.set_degraded(m, True)
            except Exception:
                logger.exception("native breaker trip failed for %s", m)
        logger.error("native control plane DEGRADED to Python: %s",
                     reason)
        from ray_tpu_torch.util import events

        events.record("ERROR", "gcs",
                      f"native control plane degraded: {reason}")

    async def handle_get_event_loop_stats(self, conn, payload):
        """Event-loop/RPC dispatch stats for the GCS pump (analogue of
        the reference's event_stats.h surface): per-handler call counts
        and latencies from the server's EventLoopStats, plus the native
        in-pump service's counters (frames it handled never reach the
        Python dispatch table, so they are reported separately)."""
        out = {"server": self._server.stats.snapshot()}
        if self._native_svc is not None:
            handled, appends, fails = self._native_svc.counters()
            n_ns, n_rows = self._native_svc.kv_stats()
            out["native"] = {
                "handled": handled, "wal_appends": appends,
                "wal_failures": fails,
                "proto_errors": self._native_svc.proto_errors(),
                "kv_namespaces": n_ns, "kv_rows": n_rows,
            }
        else:
            out["native"] = None
        out["native_control"] = self._native_control_stats()
        return out

    async def handle_get_config(self, conn, payload):
        return {"config": self.config.to_json()}


def main():
    """Entrypoint: `python -m ray_tpu_torch._private.gcs --port=... `"""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--config", default="")
    parser.add_argument("--persist", default="")
    parser.add_argument("--ready-fd", type=int, default=-1)
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[gcs] %(asctime)s %(levelname)s %(message)s")
    import faulthandler

    faulthandler.enable()  # segfault/abort tracebacks land in gcs.log
    _maybe_attach_daemon_profiler("gcs")

    async def run():
        # Eager tasks (3.12): an RPC dispatch that completes without
        # blocking never round-trips through the scheduler — one fewer
        # loop hop per table mutation on the daemon hot path. Absent on
        # older interpreters; the daemon must still boot there.
        if hasattr(asyncio, "eager_task_factory"):
            asyncio.get_running_loop().set_task_factory(
                asyncio.eager_task_factory)
        config = Config.from_json(args.config) if args.config else Config()
        server = GcsServer(config, persistence_path=args.persist or None)
        host, port = await server.start(args.host, args.port)
        if args.ready_fd >= 0:
            import os
            os.write(args.ready_fd, f"{host}:{port}\n".encode())
            os.close(args.ready_fd)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
