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

Tables live in memory only: the reference persists them through its
native WAL store (src/gcs_store.cc), which returns in the port with the
other native control planes (ROADMAP A1, second part). This is the
Python control path the reference keeps behind RAY_TPU_NATIVE_CONTROL=0.
"""

from __future__ import annotations

import asyncio
import logging
import os
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
    def __init__(self, config: Config | None = None):
        self.config = config or Config()
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
        # Fanout: one _SubscriberPump per subscriber conn + shared
        # counters. Surfaced in GetClusterStatus -> status CLI.
        self._fanout_pumps: dict = {}
        self._fanout_stats = {"enqueued": 0, "sent": 0, "coalesced": 0,
                              "dropped": 0, "batches": 0, "max_depth": 0}
        from ray_tpu_torch._private.fast_rpc import make_server

        self._server = make_server(self._handlers(), name="gcs")
        self._health_task: asyncio.Task | None = None
        self._aux_tasks: list = []
        self._actor_seq = 0
        self.start_time = time.time()

    def _handlers(self):
        return {
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
        }

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        addr = await self._server.start(host, port)
        self._health_task = supervised_task(self._health_check_loop(),
                                            name="gcs-health-loop")
        logger.info("GCS listening on %s:%s", *addr)
        return addr

    async def stop(self):
        for pump in list(self._fanout_pumps.values()):
            pump.close()
        self._fanout_pumps.clear()
        if self._health_task:
            self._health_task.cancel()
        for t in self._aux_tasks:
            t.cancel()
        self._aux_tasks = []
        await self._server.stop()

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

    async def publish(self, channel: str, message):
        # Enqueue-and-return into per-subscriber
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
        conn.on_close(lambda: supervised_task(
            self._on_node_conn_lost(node.node_id, conn)))
        await self.publish("NODE", {
            "event": "reconnected" if was_suspect else "alive",
            "node": node.to_wire()})
        return {"ok": True, "config": self.config.to_json(),
                "reconnected": True}

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
                # memcpy, no sockets) — see raylet._local_peer_copy.
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
        # Placement mirror: stop picking the node for new actors/PGs
        # (the data plane keeps treating it as alive — objects are still
        # being pulled off it).
        def rollback():
            # The raylet never accepted the drain: a node left DRAINING
            # here would be wedged out of placement forever (no
            # _run_drain is running, so DrainComplete never comes).
            if already_draining:
                return
            node.state = NODE_ALIVE
            node.drain_reason = ""

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
        stats = dict(payload.get("stats") or {})
        # Merge: migrated_actors is GCS-side accounting, the rest is the
        # raylet's evacuation report.
        node.drain_stats.update(stats)
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
        self.node_conns.pop(node_id, None)
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
        self.node_conns.pop(node_id, None)
        self._node_call_sessions.pop(node_id, None)
        self.pending_demand.pop(node_id, None)
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
        return {"added": True}

    async def handle_kv_get(self, conn, payload):
        require_fields(payload, "key", method="handle_kv_get")
        return {"value": self.kv[payload.get("ns", "")].get(payload["key"])}

    async def handle_kv_del(self, conn, payload):
        require_fields(payload, "key", method="handle_kv_del")
        existed = self.kv[payload.get("ns", "")].pop(payload["key"], None) is not None
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
        # DRAINING/DRAINED nodes take no new placements.
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
        a["node_id"] = node_id
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
        can_restart = (not intended) and (
            a["max_restarts"] == -1 or a["restarts"] < a["max_restarts"])
        logger.info("actor %s worker died (%s), restart=%s (%d/%s)",
                    actor_id[:8], reason, can_restart, a["restarts"],
                    a["max_restarts"])
        if can_restart:
            a["restarts"] += 1
            a["state"] = ACTOR_RESTARTING
            a["address"] = None
            await self.publish("ACTOR", {"actor_id": actor_id, "state": ACTOR_RESTARTING,
                                         "reason": reason})
            supervised_task(self._schedule_actor(actor_id))
        else:
            a["state"] = ACTOR_DEAD
            a["address"] = None
            a["death_cause"] = reason
            self.named_actors.pop((a["namespace"], a["name"]), None)
            from ray_tpu_torch.util import events

            events.record("WARNING", "gcs", "actor dead",
                          actor_id=actor_id)
            await self.publish("ACTOR", {"actor_id": actor_id, "state": ACTOR_DEAD,
                                         "reason": reason})

    async def handle_get_actor_info(self, conn, payload):
        require_fields(payload, "actor_id", method="handle_get_actor_info")
        a = self.actors.get(payload["actor_id"])
        if a is None:
            return {"found": False}
        return {"found": True, "state": a["state"], "address": a["address"],
                "death_cause": a["death_cause"], "restarts": a["restarts"],
                "class_name": a["class_name"], "name": a["name"]}

    async def handle_get_named_actor(self, conn, payload):
        require_fields(payload, "name", method="handle_get_named_actor")
        key = (payload.get("namespace") or "default", payload["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None or actor_id not in self.actors:
            return {"found": False}
        a = self.actors[actor_id]
        return {"found": True, "actor_id": actor_id, "state": a["state"],
                "address": a["address"], "spec_meta": a["spec"].get("meta")
                if isinstance(a["spec"], dict) else None}

    async def handle_list_actors(self, conn, payload):
        return {"actors": [
            {k: a[k] for k in ("actor_id", "job_id", "name", "namespace", "class_name",
                               "state", "node_id", "restarts", "resources")}
            for a in self.actors.values()]}

    async def handle_kill_actor(self, conn, payload):
        require_fields(payload, "actor_id", method="handle_kill_actor")
        actor_id = payload["actor_id"]
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
        return {"ok": True}

    async def handle_finish_job(self, conn, payload):
        require_fields(payload, "job_id", method="handle_finish_job")
        job = self.jobs.get(payload["job_id"])
        if job:
            job["status"] = payload.get("status", "SUCCEEDED")
            job["end_time"] = time.time()
        # Raylets release the job's runtime-env references on this event
        # (reference: runtime-env URI GC when the last referencing job
        # exits, runtime_env ARCHITECTURE.md).
        await self.publish("JOB", {"event": "finished",
                                   "job_id": payload["job_id"]})
        return {"ok": True}

    async def handle_list_jobs(self, conn, payload):
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
        await self.publish("PG", {"pg_id": pg_id, "state": PG_CREATED,
                                  "bundles": [(b["node_id"]) for b in pg["bundles"]]})

    def _pack_bundles(self, pg) -> list[tuple[int, str]] | None:
        """Returns [(bundle_index, node_id)] or None if infeasible now."""
        strategy = pg["strategy"]
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

    async def handle_remove_pg(self, conn, payload):
        require_fields(payload, "pg_id", method="handle_remove_pg")
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
        # Waiters on ready() promises fail instead of hanging forever.
        await self.publish("PG", {"pg_id": payload["pg_id"],
                                  "state": PG_REMOVED})
        return {"ok": True}

    async def handle_get_pg(self, conn, payload):
        require_fields(payload, "pg_id", method="handle_get_pg")
        pg = self.placement_groups.get(payload["pg_id"])
        if pg is None:
            return {"found": False}
        return {"found": True, "state": pg["state"],
                "bundles": [{"node_id": b["node_id"], "resources": b["resources"]}
                            for b in pg["bundles"]],
                "strategy": pg["strategy"], "name": pg["name"]}

    async def handle_list_pgs(self, conn, payload):
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
            "fanout": dict(self._fanout_stats),
            # Top-level packages this daemon has loaded (what a port
            # process may not load — jax, ray_tpu, msgpack — is checked
            # against this).
            "loaded_packages": loaded_packages(),
        }

    async def handle_get_event_loop_stats(self, conn, payload):
        """Event-loop/RPC dispatch stats for the GCS server (analogue of
        the reference's event_stats.h surface): per-handler call counts
        and latencies from the server's EventLoopStats."""
        return {"server": self._server.stats.snapshot()}

    async def handle_get_config(self, conn, payload):
        return {"config": self.config.to_json()}


def main():
    """Entrypoint: `python -m ray_tpu_torch._private.gcs --port=... `"""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--config", default="")
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
        server = GcsServer(config)
        host, port = await server.start(args.host, args.port)
        if args.ready_fd >= 0:
            import os
            os.write(args.ready_fd, f"{host}:{port}\n".encode())
            os.close(args.ready_fd)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
