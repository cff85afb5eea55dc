"""ServeController: the reconciling control loop.

Parity: reference python/ray/serve/_private/controller.py:87 (detached
controller actor; control loop :312 reconciles DeploymentState →
replica actors; autoscaling decision from handle-reported metrics
:221 + autoscaling_policy.py:117 with a look-back window), long_poll.py
LongPollHost:63 (held-connection config push to proxies/handles), and
deployment_state.py:1149 (versioned rolling updates with graceful
drain).
"""

from __future__ import annotations

import time
from collections import deque

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.serve.deployment import AutoscalingConfig, ReplicaActor

CONTROLLER_NAME = "SERVE_CONTROLLER"

# The controller must serve many parked long_poll calls CONCURRENTLY with
# deploys/health work; a max_concurrency=1 actor would deadlock the
# control plane behind the first parked poll.
CONTROLLER_CONCURRENCY = 32

# Parked long_poll calls may hold at most this many of the concurrency
# slots; excess pollers get an immediate empty reply (they degrade to
# fast re-polling) so control-plane RPCs always have free lanes.
MAX_PARKED_POLLS = 20


@ray_tpu_torch.remote(max_concurrency=CONTROLLER_CONCURRENCY)
class ServeController:
    def __init__(self):
        import threading

        # name -> {config fields, replicas: [handle], rver: [int], ...}
        self.deployments: dict[str, dict] = {}
        self._last_scale: dict[str, float] = {}
        # name -> deque[(ts, load)] — look-back window for autoscaling
        # (reference: autoscaling_policy.py:117 averages over
        # look_back_period_s instead of acting on instantaneous gauges).
        self._load_samples: dict[str, deque] = {}
        self._stop = threading.Event()
        # Guards replica-list mutation: the health loop runs on its own
        # thread, concurrent with actor methods (deploy/record_handle_load)
        # that also reconcile.
        self._rlock = threading.Lock()
        # Long-poll state (reference: long_poll.py LongPollHost): key ->
        # monotonically-increasing version + current value; listeners park
        # on the condition until something they watch changes.
        self._poll_versions: dict[str, int] = {}
        self._poll_values: dict[str, object] = {}
        self._poll_cv = threading.Condition()
        self._poll_slots = threading.BoundedSemaphore(MAX_PARKED_POLLS)
        # Health-check loop: replace crashed replicas (reference: the
        # controller control loop at controller.py:312 reconciles
        # DeploymentState each tick; a dead replica actor is restarted).
        self._hc_thread = threading.Thread(target=self._health_loop,
                                           daemon=True)
        self._hc_thread.start()

    # ---------- long poll (reference: long_poll.py:63) ----------

    def _publish(self, key: str, value) -> None:
        with self._poll_cv:
            self._poll_versions[key] = self._poll_versions.get(key, 0) + 1
            self._poll_values[key] = value
            self._poll_cv.notify_all()

    def _publish_replicas(self, name: str) -> None:
        d = self.deployments.get(name)
        reps = list(d["replicas"]) if d else []
        self._publish(f"replicas:{name}", reps)

    def _publish_routes(self) -> None:
        self._publish("routes", self.route_table())

    def long_poll(self, known: dict, timeout_s: float = 10.0) -> dict:
        """Held-connection config push: blocks until any watched key has a
        version newer than the caller's, then returns {key: [version,
        value]}. Callers loop — this is the reference's
        LongPollHost.listen_for_change contract."""
        deadline = time.monotonic() + timeout_s
        parked = False
        try:
            with self._poll_cv:
                while True:
                    updates = {}
                    for key, ver in known.items():
                        cur = self._poll_versions.get(key, 0)
                        if cur > ver:
                            updates[key] = [cur, self._poll_values.get(key)]
                    if updates:
                        return updates
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        return {}
                    if not parked:
                        # Bounded parking: when every poll slot is taken,
                        # answer empty NOW instead of occupying a
                        # concurrency lane the control plane needs.
                        if not self._poll_slots.acquire(blocking=False):
                            return {}
                        parked = True
                    self._poll_cv.wait(remaining)
        finally:
            if parked:
                self._poll_slots.release()

    # ---------- health ----------

    def _probe_replicas(self, probes: list, fails: dict) -> set:
        """CONCURRENT health probes: one wait over all replicas instead of
        serial O(replicas x timeout) gets (reference: health checks fan
        out in deployment_state)."""
        dead = set()
        refs = []
        for key, r in probes:
            try:
                refs.append((key, r, r.health_check.remote()))
            except Exception:
                dead.add(key)
        if not refs:
            return dead
        ray_tpu_torch.wait([ref for _, _, ref in refs],
                     num_returns=len(refs), timeout=10)
        for key, r, ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=0.5)
                fails.pop(key, None)
            except ray_tpu_torch.exceptions.ActorDiedError:
                dead.add(key)
                fails.pop(key, None)
            except Exception:
                fails[key] = fails.get(key, 0) + 1
                if fails[key] >= 3:
                    dead.add(key)
                    fails.pop(key, None)
                    try:
                        ray_tpu_torch.kill(r)
                    except Exception:
                        pass
        return dead

    def _health_loop(self):
        # A busy replica answers slowly (requests are serviced in order),
        # so one slow/timed-out probe is not death: require 3 consecutive
        # failures, like the reference's consecutive health-check-failure
        # threshold (deployment_state.py replica health tracking).
        fails: dict[str, int] = {}
        while not self._stop.wait(2.0):
            current = {r._actor_id.hex() for dd in self.deployments.values()
                       for r in dd["replicas"]}
            for k in list(fails):
                if k not in current:
                    del fails[k]
            for name in list(self.deployments):
                d = self.deployments.get(name)
                if d is None:
                    continue
                probes = [(r._actor_id.hex(), r) for r in list(d["replicas"])]
                dead_ids = self._probe_replicas(probes, fails)
                if dead_ids:
                    with self._rlock:
                        keep = [(r, v) for r, v in zip(d["replicas"], d["rver"])
                                if r._actor_id.hex() not in dead_ids]
                        d["replicas"] = [r for r, _ in keep]
                        d["rver"] = [v for _, v in keep]
                    try:
                        self._reconcile(name)
                    except Exception:
                        pass
                    self._publish_replicas(name)
                try:
                    self._autoscale_on_metrics(name, d)
                except Exception:
                    pass

    def _autoscale_on_metrics(self, name: str, d: dict):
        """Per-pool autoscaling on a REPLICA-REPORTED named metric
        (autoscaling.metric / target_value): each health tick polls every
        replica's report_metrics(), sums the named gauge, windows it over
        look_back_period_s, and reconciles toward ceil(avg / target).
        Deployments without `metric` keep the handle-side
        outstanding-request signal (record_handle_load)."""
        asc = d.get("autoscaling") or {}
        metric = asc.get("metric")
        target = asc.get("target_value")
        if not metric or not target:
            return
        refs = []
        for r in list(d["replicas"]):
            try:
                refs.append(r.report_metrics.remote())
            except Exception:
                pass
        if refs:
            ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=5)
        total = 0.0
        for ref in refs:
            try:
                total += float(
                    ray_tpu_torch.get(ref, timeout=0.5).get(metric, 0.0))
            except Exception:
                pass
        now = time.time()
        samples = self._load_samples.setdefault(name, deque(maxlen=256))
        samples.append((now, total))
        look_back = asc.get("look_back_period_s", 10.0)
        window = [v for ts, v in samples if now - ts <= look_back]
        avg = sum(window) / max(1, len(window))
        desired = max(asc.get("min_replicas", 1),
                      min(asc.get("max_replicas", 4),
                          int(-(-avg // target))))
        last = self._last_scale.get(name, 0.0)
        if desired > d["target"] and \
                now - last > asc.get("upscale_delay_s", 0.5):
            d["target"] = desired
            self._last_scale[name] = now
            self._reconcile(name)
        elif desired < d["target"] and \
                now - last > asc.get("downscale_delay_s", 5.0):
            d["target"] = desired
            self._last_scale[name] = now
            self._reconcile(name)

    # ---------- deploy / reconcile / rolling update ----------

    def deploy(self, name: str, callable_blob: bytes, init_args_blob: bytes,
               num_replicas: int, actor_options: dict,
               autoscaling: dict | None, user_config_blob: bytes | None,
               route_prefix: str | None = None):
        d = self.deployments.get(name)
        if d is None:
            d = self.deployments[name] = {
                "replicas": [], "rver": [], "version": 0, "code_version": 0}
        code_changed = (
            d.get("callable_blob") != callable_blob
            or d.get("init_args_blob") != init_args_blob
            or (d.get("actor_options") or {}) != (actor_options or {}))
        d["callable_blob"] = callable_blob
        d["init_args_blob"] = init_args_blob
        d["actor_options"] = actor_options or {}
        d["autoscaling"] = autoscaling
        d["user_config_blob"] = user_config_blob
        d["route_prefix"] = route_prefix if route_prefix is not None \
            else f"/{name}"
        d["target"] = (autoscaling or {}).get("min_replicas", num_replicas) \
            if autoscaling else num_replicas
        d["version"] += 1
        if code_changed:
            d["code_version"] += 1
        self._reconcile(name)
        if code_changed and any(v != d["code_version"] for v in d["rver"]):
            # Versioned ROLLING update: replace old-code replicas one at a
            # time — start new, wait healthy, publish, drain old
            # (reference: deployment_state.py:1149 rolling updates with
            # graceful draining).
            self._rolling_update(name)
        elif user_config_blob is not None:
            # Config-only redeploy reconfigures LIVE replicas in place
            # (reference: lightweight user_config updates don't restart).
            user_config = serialization.loads_func(user_config_blob)
            for r in list(d["replicas"]):
                try:
                    r.reconfigure.remote(user_config)
                except Exception:
                    pass
        self._publish_routes()
        self._publish_replicas(name)
        return True

    def _make_replica(self, d):
        init_args, init_kwargs = serialization.loads_func(d["init_args_blob"])
        user_config = (serialization.loads_func(d["user_config_blob"])
                       if d["user_config_blob"] else None)
        opts = dict(d["actor_options"])
        kwargs = {}
        # num_gpus: a replica that holds a card gets a GPU lease, which
        # pins its worker to that card (the reference's replicas take
        # TPUs through `resources`).
        for key in ("num_cpus", "num_gpus", "resources"):
            if key in opts:
                kwargs[key] = opts[key]
        if "max_concurrency" in opts:
            # Streaming engine replicas need concurrent lanes: a
            # prepare_drain that blocks until streams finish would
            # otherwise deadlock against the next_chunks pulls those
            # streams need to finish.
            kwargs["max_concurrency"] = opts["max_concurrency"]
        cls = ReplicaActor.options(**kwargs) if kwargs else ReplicaActor
        return cls.remote(d["callable_blob"], init_args, init_kwargs,
                          user_config)

    def _reconcile(self, name: str):
        d = self.deployments[name]
        with self._rlock:
            while len(d["replicas"]) < d["target"]:
                d["replicas"].append(self._make_replica(d))
                d["rver"].append(d["code_version"])
            victims = []
            while len(d["replicas"]) > d["target"]:
                victims.append(d["replicas"].pop())
                d["rver"].pop()
        if victims:
            import threading

            # Drain in the background: a downscale decision must not
            # stall the control plane for the drain duration.
            for victim in victims:
                threading.Thread(target=self._drain_and_kill,
                                 args=(victim,), daemon=True).start()
        self._publish_replicas(name)

    def _rolling_update(self, name: str):
        d = self.deployments[name]
        while True:
            with self._rlock:
                idx = next((i for i, v in enumerate(d["rver"])
                            if v != d["code_version"]), None)
                if idx is None:
                    return
                old = d["replicas"][idx]
            new = self._make_replica(d)
            try:
                # New replica must be HEALTHY before the old one leaves
                # the pool — this is what makes the update zero-downtime.
                ray_tpu_torch.get(new.health_check.remote(), timeout=120)
            except Exception:
                try:
                    ray_tpu_torch.kill(new)
                except Exception:
                    pass
                raise RuntimeError(
                    f"rolling update of {name!r} aborted: new replica "
                    f"failed its initial health check")
            import threading

            with self._rlock:
                # Re-locate by IDENTITY: the list may have shifted while
                # the new replica came up (health-loop removal,
                # autoscaling) — a stale index would swap out the wrong
                # replica.
                try:
                    cur = d["replicas"].index(old)
                except ValueError:
                    # Old replica already gone (died / scaled away):
                    # nothing to replace; drop the spare and re-check.
                    try:
                        ray_tpu_torch.kill(new)
                    except Exception:
                        pass
                    continue
                d["replicas"][cur] = new
                d["rver"][cur] = d["code_version"]
            self._publish_replicas(name)
            # Drain in the background: the old replica is already out of
            # the routed set; blocking deploy() on its in-flight work
            # adds nothing to correctness (same policy as _reconcile).
            threading.Thread(target=self._drain_and_kill, args=(old,),
                             daemon=True).start()

    def _drain_and_kill(self, replica):
        """Graceful drain: give routers a beat to observe the published
        replica set, then wait for everything already queued on the
        replica (single execution lane => a sentinel call returning means
        all earlier-arrived requests finished), then kill. Stragglers that
        still raced a request in are resubmitted by the handle's
        replica-death retry path."""
        time.sleep(1.0)
        try:
            # Scale-in drain protocol: let the callable finish (or
            # evacuate) its in-flight streams before the kill — this is
            # what makes a decode-pool downscale lose zero requests.
            ray_tpu_torch.get(replica.prepare_drain.remote(), timeout=300)
        except Exception:
            pass
        try:
            ray_tpu_torch.get(replica.health_check.remote(), timeout=300)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def get_replicas(self, name: str):
        d = self.deployments.get(name)
        return list(d["replicas"]) if d else []

    def route_table(self) -> dict:
        """{route_prefix: deployment_name} for proxy-side caching (the
        proxy does the longest-prefix match against this table)."""
        return {d.get("route_prefix") or f"/{name}": name
                for name, d in self.deployments.items()}

    def list_deployments(self):
        return {name: {"num_replicas": len(d["replicas"]),
                       "target": d["target"], "version": d["version"],
                       "code_version": d["code_version"]}
                for name, d in self.deployments.items()}

    def record_handle_load(self, name: str, outstanding: float):
        """Handle-side queue metric → autoscaling decision over a
        look-back WINDOW (reference: controller.py:221
        record_autoscaling_metrics + BasicAutoscalingPolicy:117 averaging
        over look_back_period_s — instantaneous gauges flap under bursty
        load)."""
        now = time.time()
        d = self.deployments.get(name)
        if d is None or not d.get("autoscaling"):
            return
        asc = d["autoscaling"]
        if asc.get("metric"):
            # This pool scales on a replica-reported named metric polled
            # by the health loop; the handle-side queue signal would
            # fight it (and its samples would pollute the same window).
            return
        samples = self._load_samples.setdefault(name, deque(maxlen=256))
        samples.append((now, outstanding))
        look_back = asc.get("look_back_period_s", 10.0)
        window = [v for ts, v in samples if now - ts <= look_back]
        avg = sum(window) / max(1, len(window))
        target_per = asc.get("target_ongoing_requests", 2.0)
        desired = max(asc.get("min_replicas", 1),
                      min(asc.get("max_replicas", 4),
                          int((avg + target_per - 1) // target_per)))
        last = self._last_scale.get(name, 0.0)
        if desired > d["target"] and now - last > asc.get("upscale_delay_s", 0.5):
            d["target"] = desired
            self._last_scale[name] = now
            self._reconcile(name)
        elif desired < d["target"] and now - last > asc.get(
                "downscale_delay_s", 5.0):
            d["target"] = desired
            self._last_scale[name] = now
            self._reconcile(name)

    def delete_deployment(self, name: str):
        d = self.deployments.pop(name, None)
        if d:
            for r in d["replicas"]:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:
                    pass
        self._publish_routes()
        self._publish(f"replicas:{name}", [])
        return True

    def shutdown(self):
        self._stop.set()
        with self._poll_cv:
            self._poll_cv.notify_all()
        for name in list(self.deployments):
            self.delete_deployment(name)
        return True
