"""Deployments, replicas, handles, and routing.

Parity: reference python/ray/serve — @serve.deployment (api.py:258),
replica actors (_private/replica.py), handle-side Router with
PowerOfTwoChoicesReplicaScheduler (router.py:290), @serve.batch dynamic
batching (batching.py). Differences this round: request routing and
dynamic batching live entirely handle-side (the newer reference also moved
queue-length metrics into the handle), and replicas execute requests
through the ordered actor queue.
"""

from __future__ import annotations

import queue as _queue
import random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch


@dataclass
class AutoscalingConfig:
    """Parity: serve/_private/autoscaling_policy.py BasicAutoscalingPolicy."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 5.0
    # Replica-reported named metric ("queue_depth", "tokens_in_flight",
    # ...): when set, the controller polls each replica's report_metrics()
    # and scales this pool on sum(metric)/target_value instead of the
    # handle-side outstanding-request count. This is what lets a
    # disaggregated prefill pool scale on queue depth while the decode
    # pool scales on tokens-in-flight (reference: Serve autoscaling on
    # custom metrics).
    metric: str | None = None
    target_value: float | None = None
    look_back_period_s: float = 10.0


@dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    ray_actor_options: dict = field(default_factory=dict)
    autoscaling_config: AutoscalingConfig | None = None
    max_ongoing_requests: int = 100
    user_config: Any = None


# --- model multiplexing (parity: serve/multiplex.py) -----------------------

# Plain module global, not TLS: replica actors execute requests serially
# (ordered actor queue), and a threading.local here would make the replica
# class blob unpicklable (cloudpickle captures referenced globals by value).
_current_model_id: str = ""


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id the current request was routed with
    (reference: serve.get_multiplexed_model_id)."""
    import ray_tpu_torch.serve.deployment as _dep

    return _dep._current_model_id


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for a per-model loader method: results are LRU-cached on
    the replica, at most `max_num_models_per_replica` resident (reference:
    serve/multiplex.py _ModelMultiplexWrapper)."""

    def wrap(fn):
        def loader(self, model_id: str):
            cache = getattr(self, "_serve_model_cache", None)
            if cache is None:
                from collections import OrderedDict

                cache = self._serve_model_cache = OrderedDict()
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = fn(self, model_id)
            cache[model_id] = model
            while len(cache) > max_num_models_per_replica:
                cache.popitem(last=False)
            return model

        loader._serve_multiplexed = True
        return loader

    if _fn is not None:
        return wrap(_fn)
    return wrap


@ray_tpu_torch.remote
class ReplicaActor:
    """Hosts one copy of the deployment callable."""

    def __init__(self, callable_blob: bytes, init_args, init_kwargs,
                 user_config=None):
        from ray_tpu_torch._private import serialization

        target = serialization.loads_func(callable_blob)
        if isinstance(target, type):
            self._instance = target(*init_args, **(init_kwargs or {}))
        else:
            self._instance = target
        if user_config is not None and hasattr(self._instance,
                                               "reconfigure"):
            self._instance.reconfigure(user_config)

    def handle_request(self, method: str, args, kwargs, model_id: str = ""):
        import ray_tpu_torch.serve.deployment as _dep

        fn = self._instance if method == "__call__" \
            else getattr(self._instance, method)
        _dep._current_model_id = model_id
        try:
            return fn(*args, **(kwargs or {}))
        finally:
            _dep._current_model_id = ""

    def loaded_model_ids(self) -> list[str]:
        cache = getattr(self._instance, "_serve_model_cache", None)
        return list(cache.keys()) if cache else []

    def handle_batch(self, method: str, batched_args: list):
        fn = self._instance if method == "__call__" \
            else getattr(self._instance, method)
        return fn([args[0] if args else None for args, _kwargs in batched_args])

    def reconfigure(self, user_config):
        if hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)
        return True

    def health_check(self):
        return True

    def report_metrics(self) -> dict:
        """Named metrics for per-pool autoscaling: forwarded from the
        deployment callable when it implements report_metrics()."""
        fn = getattr(self._instance, "report_metrics", None)
        if fn is None:
            return {}
        try:
            return dict(fn())
        except Exception:
            return {}

    def prepare_drain(self) -> bool:
        """Called by the controller before killing this replica on
        scale-in: blocks until the callable has finished (or evacuated)
        its in-flight work. Replicas hosting streaming engines need
        max_concurrency > 1 so concurrent next_chunks pulls can keep
        draining streams while this call waits."""
        fn = getattr(self._instance, "prepare_drain", None)
        if fn is None:
            return True
        try:
            fn()
        except Exception:
            pass
        return True

    # -- streaming (reference: serve streaming responses / generator
    # deployments, serve/handle.py DeploymentResponseGenerator). The
    # generator lives on the replica; the client pulls chunks with
    # follow-up actor calls, so memory stays bounded on both sides. --

    def start_stream(self, method: str, args, kwargs, model_id: str = ""):
        import uuid

        fn = self._instance if method == "__call__" \
            else getattr(self._instance, method)
        # Calling a generator function only CREATES the generator — the
        # body runs inside next(), so the model id must be active around
        # every next_chunks pull, not just here. Stored per-stream.
        gen = fn(*args, **(kwargs or {}))
        if not hasattr(gen, "__next__"):
            gen = iter(gen)
        sid = uuid.uuid4().hex
        if not hasattr(self, "_streams"):
            self._streams = {}
        self._streams[sid] = (gen, model_id)
        return sid

    def next_chunks(self, stream_id: str, max_chunks: int = 8):
        import ray_tpu_torch.serve.deployment as _dep

        entry = self._streams.get(stream_id)
        if entry is None:
            raise KeyError(f"unknown stream {stream_id}")
        gen, model_id = entry
        values, done = [], False
        _dep._current_model_id = model_id
        try:
            for _ in range(max_chunks):
                try:
                    values.append(next(gen))
                except StopIteration:
                    done = True
                    del self._streams[stream_id]
                    break
        finally:
            _dep._current_model_id = ""
        return {"values": values, "done": done}

    def cancel_stream(self, stream_id: str):
        entry = self._streams.pop(stream_id, None)
        if entry is not None and hasattr(entry[0], "close"):
            entry[0].close()
        return True


class Deployment:
    """The declarative object produced by @serve.deployment."""

    def __init__(self, target, config: DeploymentConfig,
                 init_args=(), init_kwargs=None):
        self._target = target
        self._config = config
        self._init_args = init_args
        self._init_kwargs = init_kwargs or {}

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **kwargs) -> "Deployment":
        cfg = DeploymentConfig(**{**self._config.__dict__, **{
            k: v for k, v in kwargs.items()
            if k in DeploymentConfig.__dataclass_fields__}})
        return Deployment(self._target, cfg, self._init_args, self._init_kwargs)

    def bind(self, *args, **kwargs) -> "Deployment":
        return Deployment(self._target, self._config, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self._config.num_replicas})"


def deployment(target=None, *, name: str | None = None, num_replicas: int = 1,
               ray_actor_options: dict | None = None,
               autoscaling_config: dict | AutoscalingConfig | None = None,
               max_ongoing_requests: int = 100, user_config=None):
    """@serve.deployment decorator (parity: serve/api.py:258)."""

    def wrap(t):
        asc = autoscaling_config
        if isinstance(asc, dict):
            asc = AutoscalingConfig(**asc)
        cfg = DeploymentConfig(
            name=name or getattr(t, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=asc,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config)
        return Deployment(t, cfg)

    if target is not None:
        return wrap(target)
    return wrap


class _BatchQueue:
    """Handle-side dynamic batching (parity: serve/batching.py)."""

    def __init__(self, submit_batch: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.submit_batch = submit_batch
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.pending: list = []
        self.lock = threading.Lock()
        self.timer: threading.Timer | None = None

    def add(self, item, result_slot):
        with self.lock:
            self.pending.append((item, result_slot))
            if len(self.pending) >= self.max_batch_size:
                batch, self.pending = self.pending, []
                if self.timer:
                    self.timer.cancel()
                    self.timer = None
            else:
                batch = None
                if self.timer is None:
                    self.timer = threading.Timer(self.timeout, self._flush)
                    self.timer.daemon = True
                    self.timer.start()
        if batch:
            self.submit_batch(batch)

    def _flush(self):
        with self.lock:
            batch, self.pending = self.pending, []
            self.timer = None
        if batch:
            self.submit_batch(batch)


class DeploymentResponse:
    """Future-like response from handle.remote()."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self._ref = None
        self._retry: Callable | None = None  # death-retry hook (handle sets)

    def _resolve_ref(self, ref):
        self._ref = ref
        self._event.set()

    def _resolve_value(self, value):
        self._value = value
        self._event.set()

    def _resolve_error(self, err: BaseException):
        self._error = err
        self._event.set()

    def __await__(self):
        """Async callers `await handle.remote(...)` directly (reference:
        DeploymentResponse is awaitable in async contexts, with no
        implicit deadline). The wait is poll-based — no executor thread is
        parked per pending response, so wide async fan-outs aren't capped
        by the thread pool."""
        import asyncio

        async def waiter():
            while True:
                if self._event.is_set():
                    if self._ref is None:
                        return self.result(timeout=None)
                    ready, _ = ray_tpu_torch.wait([self._ref], timeout=0)
                    if ready:
                        return self.result(timeout=None)
                await asyncio.sleep(0.005)

        return waiter().__await__()

    def result(self, timeout: float | None = 60.0):
        start = time.monotonic()

        def remaining():
            if timeout is None:
                return None
            return max(0.1, timeout - (time.monotonic() - start))

        if not self._event.wait(timeout):
            raise TimeoutError("deployment response timed out")
        if self._error is not None:
            raise self._error
        if self._ref is not None:
            try:
                return ray_tpu_torch.get(self._ref, timeout=remaining())
            except ray_tpu_torch.exceptions.ActorError:
                # Replica died mid-request: retry on another replica within
                # the caller's ORIGINAL timeout budget (reference: handles
                # retry system-level replica failures).
                if self._retry is not None:
                    retry, self._retry = self._retry, None
                    return retry(remaining())
                raise
        return self._value


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response (reference:
    serve/handle.py DeploymentResponseGenerator for generator handlers)."""

    def __init__(self, handle: "DeploymentHandle", idx: int, replica,
                 stream_id: str):
        self._handle = handle
        self._idx = idx
        self._replica = replica
        self._sid = stream_id
        self._buffer: list = []
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        while not self._buffer:
            if self._done:
                raise StopIteration
            chunk = ray_tpu_torch.get(
                self._replica.next_chunks.remote(self._sid), timeout=60)
            self._buffer.extend(chunk["values"])
            if chunk["done"]:
                self._done = True
                self._handle._done(self._idx)
                if not self._buffer:
                    raise StopIteration
        return self._buffer.pop(0)

    def cancel(self):
        if not self._done:
            self._done = True
            self._handle._done(self._idx)
            try:
                self._replica.cancel_stream.remote(self._sid)
            except Exception:
                pass


class _RouterState:
    """Shared routing state for a deployment: replica cache, per-replica
    outstanding counts, and multiplexed-model residency.  One instance is
    shared by a handle and every handle derived from it via .options()
    (reference: handle clones share one Router, router.py)."""

    def __init__(self):
        self.replicas: list = []
        self.outstanding: dict[int, int] = {}
        self.model_replicas: dict[str, set[int]] = {}
        self.lock = threading.Lock()
        self.last_refresh = 0.0
        # Long-poll push state (reference: long_poll.py LongPollClient):
        # a daemon thread parks on the controller and applies replica-set
        # updates the moment they are published.
        self.poll_version = 0
        self.poll_thread: threading.Thread | None = None
        self.poll_stop = threading.Event()

    def start_long_poll(self, name: str, controller) -> None:
        key = f"replicas:{name}"

        def loop():
            while not self.poll_stop.is_set():
                t0 = time.monotonic()
                try:
                    upd = ray_tpu_torch.get(
                        controller.long_poll.remote(
                            {key: self.poll_version}, 10.0),
                        timeout=30)
                except Exception:
                    if self.poll_stop.wait(1.0):
                        return
                    continue
                if key not in upd and time.monotonic() - t0 < 1.0:
                    # Instant empty reply = the controller's parked-poll
                    # slots are exhausted (it answers {} immediately, not
                    # after the 10s park). Re-calling in a tight loop
                    # would hammer its concurrency lanes; back off.
                    if self.poll_stop.wait(0.5):
                        return
                if key in upd:
                    ver, reps = upd[key]
                    with self.lock:
                        self.poll_version = ver
                        if len(reps) != len(self.replicas):
                            self.model_replicas.clear()
                        self.replicas = reps
                        self.last_refresh = time.monotonic()
                        for i in range(len(reps)):
                            self.outstanding.setdefault(i, 0)

        with self.lock:  # check-and-start must be atomic across threads
            if self.poll_thread is not None and self.poll_thread.is_alive():
                return
            self.poll_thread = threading.Thread(
                target=loop, daemon=True, name="serve-longpoll")
            self.poll_thread.start()


class DeploymentHandle:
    """Routes requests to replicas: power-of-two-choices on outstanding
    per-replica request counts (reference: router.py:290)."""

    def __init__(self, deployment_name: str, controller, method: str = "__call__",
                 batching: tuple[int, float] | None = None,
                 multiplexed_model_id: str = "",
                 router: _RouterState | None = None, stream: bool = False):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method = method
        self._model_id = multiplexed_model_id
        self._stream = stream
        self._router = router or _RouterState()
        self._batchq: _BatchQueue | None = None
        if batching:
            self._batchq = _BatchQueue(self._submit_batch, batching[0],
                                       batching[1])
        # (idx, ref) pairs not yet observed complete; a reaper thread
        # retires them so "ongoing requests" means submitted-but-unfinished
        # (the autoscaling metric), not merely mid-submit.
        self._inflight: list = []
        self._reaper: threading.Thread | None = None

    def __reduce__(self):
        # Handles travel into replicas (deployment-graph composition) and
        # rebuild with fresh router state there — the lock/queues are
        # process-local; the batching CONFIG survives the trip.
        batching = (self._batchq.max_batch_size, self._batchq.timeout) \
            if self._batchq is not None else None
        return (_rebuild_handle, (self.deployment_name, self._controller,
                                  self._method, self._model_id, batching))

    def options(self, method_name: str | None = None,
                batching: tuple[int, float] | None = None,
                multiplexed_model_id: str | None = None,
                stream: bool | None = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self._controller,
            method_name or self._method, batching,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            router=self._router,
            stream=self._stream if stream is None else stream)

    # Routing state lives on the shared router; these aliases keep the
    # method bodies below reading naturally.

    @property
    def _lock(self):
        return self._router.lock

    @property
    def _replicas(self):
        return self._router.replicas

    @_replicas.setter
    def _replicas(self, value):
        self._router.replicas = value

    @property
    def _outstanding(self):
        return self._router.outstanding

    @property
    def _model_replicas(self):
        return self._router.model_replicas

    @property
    def _last_refresh(self):
        return self._router.last_refresh

    @_last_refresh.setter
    def _last_refresh(self, value):
        self._router.last_refresh = value

    # -- replica set maintenance: long-poll push with a slow TTL-refresh
    # fallback (reference: router updates via LongPollClient) --

    def _get_replicas(self):
        self._router.start_long_poll(self.deployment_name, self._controller)
        now = time.monotonic()
        # The push thread keeps last_refresh current; the pull below only
        # fires when the push path is unavailable (controller restart) or
        # before the first push lands.
        if now - self._last_refresh > 5.0 or not self._replicas:
            reps = ray_tpu_torch.get(self._controller.get_replicas.remote(
                self.deployment_name))
            with self._lock:
                if len(reps) != len(self._replicas):
                    # Replica set changed: cached model->index residency is
                    # no longer valid.
                    self._model_replicas.clear()
                self._replicas = reps
                self._last_refresh = now
                for i in range(len(reps)):
                    self._outstanding.setdefault(i, 0)
        return self._replicas

    def _pick_replica(self):
        reps = self._get_replicas()
        if not reps:
            raise RuntimeError(
                f"deployment {self.deployment_name!r} has no replicas")
        # Multiplexing: prefer the least-loaded replica that already has
        # this model resident (reference: router.py multiplexed routing).
        # Residency is tracked handle-side — recorded when a request for a
        # model is routed — not probed per request (a per-request RPC to
        # every replica would queue behind in-flight inference).
        if self._model_id and len(reps) > 1:
            with self._lock:
                cached = [i for i in self._model_replicas.get(
                    self._model_id, ()) if i < len(reps)]
                if cached:
                    idx = min(cached,
                              key=lambda i: self._outstanding.get(i, 0))
                    self._outstanding[idx] = self._outstanding.get(idx, 0) + 1
                    return idx, reps[idx]
        with self._lock:
            if len(reps) == 1:
                idx = 0
            else:
                a, b = random.sample(range(len(reps)), 2)
                idx = a if self._outstanding.get(a, 0) <= \
                    self._outstanding.get(b, 0) else b
            self._outstanding[idx] = self._outstanding.get(idx, 0) + 1
        return idx, reps[idx]

    def _done(self, idx):
        with self._lock:
            self._outstanding[idx] = max(0, self._outstanding.get(idx, 0) - 1)

    def _report_load(self):
        with self._lock:
            total = sum(self._outstanding.values())
        try:
            self._controller.record_handle_load.remote(
                self.deployment_name, total)
        except Exception:
            pass

    # -- request path --

    def remote(self, *args, **kwargs):
        if self._stream:
            return self._remote_stream(args, kwargs)
        resp = DeploymentResponse()
        if self._batchq is not None:
            self._batchq.add((args, kwargs), resp)
            return resp
        idx, replica = self._pick_replica()
        try:
            ref = replica.handle_request.remote(self._method, list(args), kwargs,
                                                self._model_id)
            if self._model_id:
                with self._lock:
                    self._model_replicas.setdefault(
                        self._model_id, set()).add(idx)
            resp._resolve_ref(ref)

            def retry_on_death(timeout):
                # The dead replica's cached set is stale: refresh and
                # resubmit. The controller needs a few health-check ticks
                # to replace dead replicas, so back off between attempts
                # (reference: handles retry system-level replica failures
                # until the deployment is available again).
                # timeout=None means wait indefinitely — same contract as
                # the normal result() path.
                deadline = (float("inf") if timeout is None
                            else time.monotonic() + timeout)
                last_err = None
                while time.monotonic() < deadline:
                    self._last_refresh = 0.0
                    try:
                        r_idx, r_replica = self._pick_replica()
                    except RuntimeError as e:  # no replicas yet
                        last_err = e
                        time.sleep(1.0)
                        continue
                    try:
                        budget = None if deadline == float("inf") else \
                            max(1.0, deadline - time.monotonic())
                        return ray_tpu_torch.get(r_replica.handle_request.remote(
                            self._method, list(args), kwargs, self._model_id),
                            timeout=budget)
                    except ray_tpu_torch.exceptions.ActorError as e:
                        last_err = e
                        time.sleep(1.0)
                    finally:
                        self._done(r_idx)
                raise last_err or TimeoutError("deployment retry timed out")

            resp._retry = retry_on_death
            with self._lock:
                self._inflight.append((idx, ref))
            self._ensure_reaper()
        except BaseException as e:  # noqa: BLE001
            resp._resolve_error(e)
            self._done(idx)
        self._report_load()
        return resp

    def _remote_stream(self, args, kwargs) -> DeploymentResponseGenerator:
        idx, replica = self._pick_replica()
        try:
            sid = ray_tpu_torch.get(replica.start_stream.remote(
                self._method, list(args), kwargs, self._model_id), timeout=60)
        except BaseException:
            self._done(idx)
            raise
        return DeploymentResponseGenerator(self, idx, replica, sid)

    def _ensure_reaper(self):
        if self._reaper is None or not self._reaper.is_alive():
            self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
            self._reaper.start()

    def _reap_loop(self):
        while True:
            with self._lock:
                inflight = list(self._inflight)
            if not inflight:
                time.sleep(0.1)
                with self._lock:
                    if not self._inflight:
                        continue
                continue
            refs = [ref for _idx, ref in inflight]
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.2)
            except Exception:
                time.sleep(0.2)
                continue
            ready_set = set(ready)
            finished = [(i, r) for i, r in inflight if r in ready_set]
            if finished:
                with self._lock:
                    for item in finished:
                        if item in self._inflight:
                            self._inflight.remove(item)
                for idx, _r in finished:
                    self._done(idx)
            self._report_load()

    def _submit_batch(self, batch):
        idx, replica = self._pick_replica()
        try:
            ref = replica.handle_batch.remote(
                self._method, [item for item, _slot in batch])
            results = ray_tpu_torch.get(ref, timeout=120)
            for (item, slot), value in zip(batch, results):
                slot._resolve_value(value)
        except BaseException as e:  # noqa: BLE001
            for _item, slot in batch:
                slot._resolve_error(e)
        finally:
            self._done(idx)


def _rebuild_handle(name, controller, method, model_id, batching=None):
    return DeploymentHandle(name, controller, method, batching=batching,
                            multiplexed_model_id=model_id)
