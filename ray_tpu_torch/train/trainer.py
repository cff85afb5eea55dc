"""TorchTrainer: the Train entry point. Port of ray_tpu/train/trainer.py
(reference: python/ray/train/data_parallel_trainer.py,
DataParallelTrainer.fit -> BackendExecutor -> WorkerGroup -> per-worker
session).

The reference's entry point is JaxTrainer, and its own TorchTrainer
(ray_tpu/train/torch.py) is a JaxTrainer with a torch process group.
Every gang of the port is that, so the port's trainer is TorchTrainer:
its workers form one process group (NCCL on cards, gloo on the CPU),
installed as torch.distributed's default group. `collective_backend`
takes "nccl", "gloo" or None (no group), and the reference's "xla" (one
world over the gang) and "cpu" as "nccl" and "gloo".

fit() retries a failed run up to FailureConfig.max_failures times from
the last checkpoint a worker reported.

Elastic mode (ScalingConfig.elastic): a gang member's node entering
DRAINING is a resize, not a failure. The trainer listens to the GCS's
NODE transitions, pauses the gang at its next step boundary (session's
voted keep_state), re-homes the departing ranks' kept state through the
device plane (the drain's evacuation, or a pull), retires them, gives
the survivors a new group and their new ranks (a group per epoch,
`train:{run_id}:{epoch}`), hands the state over and resumes at step
N+1. Grow-back seeds new members from rank 0 the same way. The fallback
ladder: re-shard, then a counted checkpoint restart, then fail. The
elastic path counts its resizes, shrinks, grows, steps lost, fallbacks
and full restarts in `telemetry`, where the reference also exports them
as util/metrics gauges (the port has no util/metrics yet: ROADMAP A1's
second part); `telemetry["resize_log"]` holds one entry a resize, with
its seconds, the bytes re-homed and the routes each hand-off took.
"""

from __future__ import annotations

import queue as _queue
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import serialization
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (ElasticConfig, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.worker_group import WorkerGroup

_BACKENDS = {"nccl": "nccl", "xla": "nccl", "gloo": "gloo", "cpu": "gloo"}
_BY_DEVICE = object()


@dataclass
class Result:
    """Parity: ray.air.result.Result."""

    metrics: dict
    checkpoint: Checkpoint | None
    error: str | None
    metrics_history: list = field(default_factory=list)

    @property
    def best_checkpoint(self):
        return self.checkpoint


class TorchTrainer:
    """Runs `train_loop_per_worker` on a gang of workers.

    collective_backend: left out, "nccl" when the workers take GPUs and
    "gloo" otherwise; None forms no group.
    initial_weights: a tree of tensors sent to every worker through the
    device plane (WorkerGroup.broadcast_weights) before the loop starts;
    the loop reads it with session.get_broadcast_weights().
    """

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 collective_backend: Any = _BY_DEVICE,
                 initial_weights: Any = None):
        self._train_loop = train_loop_per_worker
        self._config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        if collective_backend is _BY_DEVICE:
            collective_backend = "nccl" if self.scaling_config.use_gpu \
                else "gloo"
        if collective_backend is not None \
                and collective_backend not in _BACKENDS:
            raise ValueError("collective_backend must be 'nccl', 'gloo' or "
                             "None (or the reference's 'xla' or 'cpu'), got "
                             f"{collective_backend!r}")
        self.collective_backend = _BACKENDS.get(collective_backend)
        self._initial_weights = initial_weights
        # Resizes the gang survived, steps lost to them, checkpoint
        # fallbacks (an elastic resume failed) and full restarts.
        self.telemetry = {"resizes": 0, "shrinks": 0, "grows": 0,
                          "steps_lost": 0, "elastic_fallbacks": 0,
                          "full_restarts": 0, "resize_log": []}
        # Rank-0's newest report, readable while fit() runs.
        self.latest_metrics: dict = {}
        # What broadcast_weights reported for the last gang, one dict a
        # worker.
        self.weights_received: list = []

    def _check_cluster(self) -> None:
        sc = self.scaling_config
        if not sc.use_gpu:
            return
        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        need = sc.num_workers * sc.gpus_per_worker
        if have < need:
            raise RuntimeError(
                f"ScalingConfig(use_gpu=True) asks for {need:g} GPUs and "
                f"the cluster has {have:g}; a gang that asks for cards does "
                "not run on the CPU (pass use_gpu=False for that)")

    def fit(self) -> Result:
        self._check_cluster()
        max_failures = self.run_config.failure_config.max_failures
        elastic = self.scaling_config.elastic
        attempt = 0
        restore_from: Checkpoint | None = None
        # Survives retries and resizes: Result.metrics_history reflects
        # the whole run, not just the last attempt.
        history: list[dict] = []
        while True:
            try:
                if elastic is not None:
                    return self._fit_elastic(restore_from, history)
                return self._fit_once(restore_from, history)
            except exc.RayTpuError as e:
                attempt += 1
                if attempt > max_failures:
                    raise
                # Checkpoint restart (reference: FailureConfig retries
                # restore from the latest reported checkpoint). In elastic
                # mode this is the COUNTED fallback rung: the happy path
                # resumes by re-sharding and never lands here.
                restore_from = getattr(e, "_last_checkpoint", None) \
                    or restore_from
                self.telemetry["full_restarts"] += 1
                if elastic is not None:
                    self.telemetry["elastic_fallbacks"] += 1
                time.sleep(1.0)

    def _fit_once(self, restore_from: "Checkpoint | None" = None,
                  history: list | None = None) -> Result:
        run_id = uuid.uuid4().hex[:8]
        group = WorkerGroup(self.scaling_config)
        try:
            cfg = dict(self._config)
            if self.collective_backend and self.scaling_config.num_workers > 1:
                group_name = f"train:{run_id}"
                group.run_on_all("setup_collective", group_name,
                                 self.collective_backend)
                cfg["_collective_group"] = group_name
            if self._initial_weights is not None:
                self.weights_received = group.broadcast_weights(
                    self._initial_weights)
            if restore_from is not None:
                cfg["_checkpoint_path"] = restore_from.path
            if self.run_config.storage_path:
                cfg["_storage_path"] = self.run_config.storage_path
            blob = serialization.dumps_func(self._train_loop)
            group.run_on_all("run", blob, cfg)
            return self._drive(group, history if history is not None else [])
        finally:
            group.shutdown()

    def _drive(self, group: WorkerGroup, history: list) -> Result:
        """Poll workers, surface rank-0 reports (reference:
        TrainingIterator in data_parallel_trainer.py)."""
        last_ckpt: Checkpoint | None = None
        done = [False] * len(group.workers)
        error: str | None = None
        final_metrics: dict = dict(history[-1]) if history else {}
        while not all(done):
            try:
                polls = ray_tpu_torch.get(
                    [w.poll.remote() for w in group.workers], timeout=300)
            except exc.RayTpuError as e:
                # Worker actor died (node loss, OOM kill): the retry loop
                # needs the newest checkpoint seen before the crash.
                e._last_checkpoint = last_ckpt
                raise
            for i, p in enumerate(polls):
                for rep in p["reports"]:
                    if rep["rank"] == 0:
                        history.append(rep["metrics"])
                        final_metrics = rep["metrics"]
                        self.latest_metrics = final_metrics
                        if rep.get("checkpoint_path"):
                            last_ckpt = Checkpoint(rep["checkpoint_path"])
                if p["done"]:
                    done[i] = True
                    if p["error"] and error is None:
                        error = f"worker {i}: {p['error']}"
            if error:
                err = exc.RayTpuError(f"training failed: {error}")
                # Carried to fit()'s retry loop for checkpoint restore.
                err._last_checkpoint = last_ckpt
                raise err
            if not all(done):
                time.sleep(0.05)
        return Result(metrics=final_metrics, checkpoint=last_ckpt,
                      error=None, metrics_history=history)

    # ---------- elastic path ----------

    def _fit_elastic(self, restore_from: "Checkpoint | None",
                     history: list) -> Result:
        from ray_tpu_torch._private.api_internal import get_core_worker

        cw = get_core_worker()
        run_id = uuid.uuid4().hex[:8]
        blob = serialization.dumps_func(self._train_loop)
        node_events: "_queue.Queue" = _queue.Queue()
        listener = node_events.put
        cw.add_node_event_listener(listener)
        group = WorkerGroup(self.scaling_config)
        try:
            if self._initial_weights is not None:
                self.weights_received = group.broadcast_weights(
                    self._initial_weights)
            self._start_epoch(group, run_id, 0, blob, restore_from)
            return self._drive_elastic(group, node_events, history,
                                       run_id, blob)
        finally:
            cw.remove_node_event_listener(listener)
            group.shutdown()

    def _start_epoch(self, group: WorkerGroup, run_id: str, epoch: int,
                     blob: bytes, restore_from: "Checkpoint | None",
                     workers=None) -> None:
        """(Re-)launch the user loop on `workers` (default: the whole
        gang) for one membership epoch, over a group of its own."""
        from ray_tpu_torch._private.api_internal import get_core_worker

        cw = get_core_worker()
        elastic: ElasticConfig = self.scaling_config.elastic
        cfg = dict(self._config)
        cfg["_elastic"] = True
        cfg["_elastic_epoch"] = epoch
        cfg["_elastic_park_s"] = elastic.reshard_timeout_s
        if cw.address is not None:
            # The trainer owns every keep_state pin: a node drain then
            # evacuates the pins HERE, off the dying node.
            cfg["_elastic_owner"] = cw.address.to_wire()
        if self.collective_backend and len(group.workers) > 1:
            group_name = f"train:{run_id}:{epoch}"
            group.run_on_all("setup_collective", group_name,
                             self.collective_backend)
            cfg["_collective_group"] = group_name
        if restore_from is not None and epoch == 0:
            cfg["_checkpoint_path"] = restore_from.path
        if self.run_config.storage_path:
            cfg["_storage_path"] = self.run_config.storage_path
        targets = group.workers if workers is None else workers
        ray_tpu_torch.get([w.run.remote(blob, cfg) for w in targets],
                          timeout=300)

    def _drive_elastic(self, group: WorkerGroup,
                       node_events: "_queue.Queue",
                       history: list, run_id: str, blob: bytes) -> Result:
        elastic: ElasticConfig = self.scaling_config.elastic
        target_size = elastic.max_workers or self.scaling_config.num_workers
        last_ckpt: Checkpoint | None = None
        final_metrics: dict = dict(history[-1]) if history else {}
        epoch = 0
        node_of = dict(zip(group.workers, group.run_on_all("node_id")))
        next_grow_check = time.monotonic() + elastic.grow_poll_s
        grow_hint = False

        def fold(w_polls):
            nonlocal final_metrics, last_ckpt
            for p in w_polls:
                if p is None:
                    continue
                for rep in p.get("reports", []):
                    if rep.get("rank") == 0 and "metrics" in rep:
                        history.append(rep["metrics"])
                        final_metrics = rep["metrics"]
                        self.latest_metrics = final_metrics
                        if rep.get("checkpoint_path"):
                            last_ckpt = Checkpoint(rep["checkpoint_path"])

        def ckpt():
            return last_ckpt

        while True:
            # 1. Pre-death signals: NODE transitions from the GCS.
            shrink_nodes: set[str] = set()
            while True:
                try:
                    ev = node_events.get_nowait()
                except _queue.Empty:
                    break
                nid = ev.get("node_id") \
                    or (ev.get("node") or {}).get("node_id")
                if ev.get("event") in ("draining", "dead") \
                        and nid in node_of.values():
                    shrink_nodes.add(nid)
                elif ev.get("event") == "alive":
                    grow_hint = True  # capacity restored: probe now

            # 2. Poll the gang, worker by worker: a drained member may be
            # killed between its pre-death signal and the resize. A
            # death with a pre-death signal (its node draining or dead)
            # is still a resize; one with no signal is the next rung.
            polls = []
            for w in list(group.workers):
                try:
                    polls.append(ray_tpu_torch.get(w.poll.remote(),
                                                   timeout=300))
                except exc.RayTpuError as e:
                    nid = node_of.get(w)
                    if nid and (nid in shrink_nodes
                                or not _node_is_alive(nid)):
                        shrink_nodes.add(nid)
                        polls.append(None)
                        continue
                    e._last_checkpoint = last_ckpt
                    raise
            fold(polls)
            error = next((f"worker {i}: {p['error']}"
                          for i, p in enumerate(polls)
                          if p and p["done"] and p["error"]), None)
            if error:
                err = exc.RayTpuError(f"training failed: {error}")
                err._last_checkpoint = last_ckpt
                raise err
            if not shrink_nodes and all(p["done"] for p in polls):
                return Result(metrics=final_metrics, checkpoint=last_ckpt,
                              error=None, metrics_history=history)

            # 3. Shrink: re-shard off the draining members.
            if shrink_nodes:
                survivors = [w for w in group.workers
                             if node_of.get(w) not in shrink_nodes]
                if len(survivors) < elastic.min_workers:
                    err = exc.RayTpuError(
                        f"elastic shrink would leave {len(survivors)} < "
                        f"min_workers={elastic.min_workers} workers")
                    err._last_checkpoint = last_ckpt
                    raise err
                epoch += 1
                self._resize(group, survivors, 0, elastic, run_id, blob,
                             epoch, fold, ckpt, node_of, direction="shrink")
                node_of = dict(zip(group.workers,
                                   group.run_on_all("node_id")))
                continue

            # 4. Grow back when capacity returns.
            now = time.monotonic()
            if (grow_hint or now >= next_grow_check) \
                    and len(group.workers) < target_size \
                    and not any(p["done"] for p in polls if p):
                grow_hint = False
                next_grow_check = now + elastic.grow_poll_s
                room = _free_worker_slots(self.scaling_config,
                                          exclude=set(node_of.values()))
                n_new = min(room, target_size - len(group.workers))
                if n_new > 0:
                    epoch += 1
                    self._resize(group, list(group.workers), n_new,
                                 elastic, run_id, blob, epoch, fold, ckpt,
                                 node_of, direction="grow")
                    node_of = dict(zip(group.workers,
                                       group.run_on_all("node_id")))
            time.sleep(0.05)

    def _resize(self, group: WorkerGroup, survivors: list, n_new: int,
                elastic: ElasticConfig, run_id: str, blob: bytes,
                epoch: int, fold, ckpt, node_of: dict, *,
                direction: str) -> None:
        """One membership change: pause at the step boundary, re-home
        state through the device plane, rebuild the group, resume. Any
        failure raises RayTpuError carrying the newest checkpoint: fit()'s
        retry loop is the (counted) fallback rung."""
        from ray_tpu_torch._private import device_objects
        from ray_tpu_torch._private.api_internal import get_core_worker

        cw = get_core_worker()
        t0 = time.monotonic()
        started = time.time()
        deadline = t0 + elastic.reshard_timeout_s
        departing = [w for w in group.workers if w not in survivors]
        evac0 = device_objects.counters().get("evacuated_in", 0)

        def fallback(why: str):
            err = exc.RayTpuError(f"elastic {direction} failed: {why}")
            err._last_checkpoint = ckpt()
            return err

        # a. Pause everyone at the next step boundary.
        for w in group.workers:
            w.request_pause.remote()
        lost_alive: set = set()
        max_step = -1
        survivor_steps: list[int] = []
        while True:
            parked = True
            survivor_steps = []
            for w in group.workers:
                if w in lost_alive:
                    continue
                try:
                    p = ray_tpu_torch.get(w.poll.remote(), timeout=30)
                except exc.RayTpuError:
                    # A departing member may already be dead (its drain's
                    # deadline expired); a survivor dying here takes the
                    # elastic path off the table.
                    if w in departing:
                        lost_alive.add(w)
                        continue
                    raise fallback("survivor died during pause")
                fold([p])
                max_step = max(max_step, p.get("state_step", -1))
                if not (p.get("paused") or p.get("done")):
                    parked = False
                elif w in survivors and p.get("state_step", -1) >= 0:
                    # state_step < 0: still warming up, nothing lost.
                    survivor_steps.append(p["state_step"])
            if parked:
                break
            if time.monotonic() > deadline:
                raise fallback("gang did not reach a step boundary "
                               f"within {elastic.reshard_timeout_s:g}s")
            time.sleep(0.02)
        paused_s = time.monotonic() - t0

        # b. Re-home the departing state: each departing rank's kept tree
        # through the device plane, found in OUR registry once the drain
        # evacuated it, else pulled from the worker (same keys either
        # way). A drain under way is waited for (within the budget): its
        # evacuation brings the tree here, and a re-pin landing after the
        # resize had released the tree would stay pinned for nothing.
        _wait_drains({node_of.get(w) for w in departing}, deadline)
        handoffs = []
        peer_states: dict[int, Any] = {}
        rehomed: list[str] = []
        for w in departing:
            if w in lost_alive:
                continue
            old_rank = group.workers.index(w)
            try:
                exp = ray_tpu_torch.get(
                    w.export_state.remote(),
                    timeout=max(5.0, deadline - time.monotonic()))
            except exc.RayTpuError:
                lost_alive.add(w)
                continue
            if exp.get("stub") is None:
                continue
            before = device_objects.counters()
            try:
                peer_states[old_rank] = device_objects.resolve_value(
                    exp["stub"], cw)
            except Exception as e:
                raise fallback(f"could not re-shard rank {old_rank} "
                               f"state: {e}") from e
            handoffs.append({"what": f"rank {old_rank} to the trainer",
                             "bytes": _stub_bytes(exp["stub"]),
                             "routes": _routes_since(before)})
            rehomed.extend(_stub_prefixes(exp["stub"]))

        # c. Retire the departing members now: it frees their leases, so
        # the draining raylet's bounded lease wait ends promptly.
        for w in departing:
            group.remove_worker(w, stop_timeout_s=1.0)

        # d. Grow: schedule the new members (DRAINING nodes are already
        # excluded from placement).
        new_world = len(survivors) + n_new
        new_workers = [group.add_worker(len(survivors) + j, new_world)
                       for j in range(n_new)]

        # e. The new gang shape: ranks follow list order.
        ray_tpu_torch.get([w.reconfigure.remote(i, new_world)
                           for i, w in enumerate(group.workers)],
                          timeout=120)

        # f. Hand the state over. Shrink: every survivor gets the
        # departed ranks' trees through ONE device object. Grow: new
        # members get rank 0's stub tree and pull the tensors straight
        # from rank 0's process.
        try:
            if peer_states:
                ref = device_objects.device_put(peer_states)
                try:
                    got = ray_tpu_torch.get(
                        [w.receive_peer_states.remote([ref])
                         for w in survivors], timeout=300)
                finally:
                    del ref
                handoffs += [{"what": f"to survivor rank {g['rank']}",
                              "bytes": g["bytes"], "routes": g["routes"]}
                             for g in got]
            if new_workers:
                seed = ray_tpu_torch.get(survivors[0].export_state.remote(),
                                         timeout=60)
                if seed.get("stub") is not None:
                    got = ray_tpu_torch.get(
                        [w.receive_peer_states.remote({0: seed["stub"]})
                         for w in new_workers], timeout=300)
                    handoffs += [{"what": f"rank 0 to new rank {g['rank']}",
                                  "bytes": g["bytes"], "routes": g["routes"]}
                                 for g in got]
        except exc.RayTpuError as e:
            raise fallback(f"state hand-off failed: {e}") from e
        finally:
            # The re-homed tensors served their hand-off: unpin them here.
            reg = device_objects.registry()
            for prefix in rehomed:
                reg.release_prefix(prefix, counted=False)
            peer_states.clear()

        # g. Rebuild the group and resume at step N+1.
        self._start_epoch(group, run_id, epoch, blob, None)

        resumed_from = min(survivor_steps) if survivor_steps else -1
        lost = max(0, max_step - resumed_from) \
            if (max_step >= 0 and survivor_steps) else 0
        self.telemetry["resize_log"].append({
            "direction": direction, "epoch": epoch, "world": new_world,
            "lost": lost, "max_step": max_step,
            "resumed_from": resumed_from, "started": started,
            "resumed": time.time(), "pause_s": paused_s,
            "total_s": time.monotonic() - t0,
            "evacuated_in": device_objects.counters().get("evacuated_in", 0)
            - evac0,
            "handoffs": handoffs})
        self.telemetry["resizes"] += 1
        self.telemetry[direction + "s"] += 1
        self.telemetry["steps_lost"] += lost


def _stub_leaves(stub) -> list:
    from ray_tpu_torch._private import device_objects

    leaves: list = []
    device_objects.tree_map(stub, leaves.append, device_objects._is_stub)
    return leaves


def _stub_bytes(stub) -> int:
    return int(sum(s.meta.nbytes for s in _stub_leaves(stub)))


def _stub_prefixes(stub) -> set:
    return {s.meta.key.split("#", 1)[0] for s in _stub_leaves(stub)}


def _routes_since(before: dict) -> dict:
    from ray_tpu_torch._private import device_objects

    after = device_objects.counters()
    return {k: after[k] - before.get(k, 0)
            for k in ("in_process", "ipc", "collective", "host_fallback")}


def _wait_drains(node_ids: set, deadline: float) -> None:
    """Wait (until `deadline`, monotonic) while any of these nodes is
    DRAINING."""
    ids = {n for n in node_ids if n}
    while ids and time.monotonic() < deadline:
        try:
            states = {n["node_id"]: n.get("state")
                      for n in ray_tpu_torch.nodes()}
        except Exception:
            return
        if not any(states.get(i) == "DRAINING" for i in ids):
            return
        time.sleep(0.05)


def _node_is_alive(node_id: str) -> bool:
    try:
        for node in ray_tpu_torch.nodes():
            if node.get("node_id") == node_id:
                return bool(node.get("alive")) \
                    and node.get("state") in (None, "ALIVE")
    except Exception:
        pass
    return False


def _free_worker_slots(scaling: ScalingConfig, exclude: set) -> int:
    """How many more workers the cluster could place now, from the node
    table's available resources: ALIVE nodes that are not draining and
    do not already host a member of this gang (`exclude`)."""
    need = scaling.worker_resources()
    slots = 0
    try:
        nodes = ray_tpu_torch.nodes()
    except Exception:
        return 0
    for node in nodes:
        if not node.get("alive", False):
            continue
        if node.get("state") not in (None, "ALIVE"):
            continue
        if node.get("node_id") in exclude:
            continue
        avail = node.get("available_resources") or {}
        per_node = None
        for res, amount in need.items():
            if amount <= 0:
                continue
            fit = int(avail.get(res, 0.0) // amount)
            per_node = fit if per_node is None else min(per_node, fit)
        slots += per_node if per_node is not None else 0
    return slots
