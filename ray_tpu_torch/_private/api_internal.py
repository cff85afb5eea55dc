"""ObjectRef / RemoteFunction / ActorClass plumbing behind the public API.

Parity: reference python/ray/_private/worker.py (global worker),
remote_function.py:257 (_remote), actor.py (ActorClass/ActorHandle/
ActorMethod), _private/ray_option_utils.py (options validation).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.common import Address, TaskSpec, normalize_resources
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch.util import tracing

_core_worker = None
_lock = threading.RLock()


def set_core_worker(cw) -> None:
    global _core_worker
    with _lock:
        _core_worker = cw


def get_core_worker():
    if _core_worker is None:
        raise exc.RayTpuError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _core_worker



def core_worker_or_none():
    return _core_worker


_nested_ctx = threading.local()


@contextlib.contextmanager
def collect_nested_refs():
    """Serialize-side collector: while active, ObjectRef.__reduce__ appends
    (oid_hex, owner_wire) here instead of job-lifetime pinning — the caller
    then applies borrower-protocol accounting to the collected refs
    (reference: reference_count.cc tracks refs found while serializing
    arguments/returns)."""
    prev = getattr(_nested_ctx, "ser_sink", None)
    sink: list = []
    _nested_ctx.ser_sink = sink
    try:
        yield sink
    finally:
        _nested_ctx.ser_sink = prev


@contextlib.contextmanager
def deser_context(preregistered: set | None = None):
    """Deserialize-side collector: rebuilt borrowed refs are recorded here;
    `preregistered` oids are ones the payload's sender already registered
    with their owners on our behalf (no BorrowRef needed from us)."""
    prev = (getattr(_nested_ctx, "deser_sink", None),
            getattr(_nested_ctx, "deser_prereg", None))
    sink: list = []
    _nested_ctx.deser_sink = sink
    _nested_ctx.deser_prereg = preregistered or set()
    try:
        yield sink
    finally:
        _nested_ctx.deser_sink, _nested_ctx.deser_prereg = prev


class ObjectRef:
    """A reference to an object owned by some worker (reference:
    python/ray ObjectRef; owner address travels with the ref as in
    src/ray/protobuf/common.proto ObjectReference)."""

    __slots__ = ("id", "owner", "_registered", "_borrowed")

    def __init__(self, oid: ObjectID, owner: Address | None, _register: bool = True):
        self.id = oid
        self.owner = owner
        self._registered = False
        self._borrowed = False
        cw = _core_worker
        if _register and cw is not None:
            cw.add_local_ref(oid.hex())
            self._registered = True

    def hex(self) -> str:
        return self.id.hex()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __del__(self):
        cw = _core_worker
        if cw is None:
            return
        try:
            if self._registered:
                cw.remove_local_ref(self.id.hex())
            elif self._borrowed:
                cw.borrow_decr(self.id.hex())
        except Exception:
            pass

    def __reduce__(self):
        # Nested-ref serialization (ref inside a value arg / return / put
        # payload). Inside a runtime serialization context the ref is
        # COLLECTED and handled by the borrower protocol
        # (reference: reference_count.cc). A bare out-of-band pickle (user
        # calling pickle.dumps directly) falls back to the job-lifetime
        # owner pin, the only safe default without a recipient to track.
        sink = getattr(_nested_ctx, "ser_sink", None)
        owner_wire = self.owner.to_wire() if self.owner else None
        if sink is not None:
            sink.append((self.id.hex(), owner_wire))
        else:
            cw = _core_worker
            if cw is not None and self.owner is not None \
                    and self.owner.worker_id == cw.worker_id:
                cw.pin_nested_ref(self.id.hex())
        # type(self): a subclass must survive the pickle hop as one
        # (isinstance routing on the receiver would silently break).
        return (_rebuild_object_ref,
                (self.id.binary(), owner_wire, type(self)))

    # Allow `await ref` patterns later; for now block via global get.
    def future(self):
        raise NotImplementedError


class DeviceObjectRef(ObjectRef):
    """Reference to an object whose tensors stay pinned on the producing
    worker (device object plane, _private/device_objects.py); only a
    descriptor travels the object path. Flows through task args and
    ray_tpu_torch.get like any ObjectRef; resolution picks the cheapest
    transfer route."""

    __slots__ = ()

    def __repr__(self):
        return f"DeviceObjectRef({self.id.hex()})"


def _rebuild_object_ref(id_bytes, owner_wire, ref_cls=None):
    owner = Address.from_wire(owner_wire) if owner_wire else None
    ref = (ref_cls or ObjectRef)(ObjectID(id_bytes), owner, _register=False)
    cw = _core_worker
    if cw is None or owner is None:
        return ref
    oid_hex = ref.id.hex()
    if owner.worker_id == cw.worker_id:
        # Deserializing our own ref: count it like any locally created
        # handle so user-held copies keep the object alive.
        cw.add_local_ref(oid_hex)
        ref._registered = True
        return ref
    # Borrowed ref: one local count per live handle (reference:
    # reference_count.cc borrower accounting).
    prereg = getattr(_nested_ctx, "deser_prereg", None)
    cw.borrow_incr(oid_hex, owner,
                   registered=bool(prereg and oid_hex in prereg))
    ref._borrowed = True
    sink = getattr(_nested_ctx, "deser_sink", None)
    if sink is not None:
        sink.append((oid_hex, owner))
    return ref


_OPTION_DEFAULTS = {
    "num_cpus": None,
    "num_gpus": None,
    "num_tpus": None,
    "resources": None,
    "num_returns": 1,
    "max_retries": 3,
    "retry_exceptions": False,
    "name": None,
    "max_restarts": 0,
    "max_task_retries": 0,
    "max_concurrency": 1,
    "scheduling_strategy": None,
    "placement_group": None,
    "placement_group_bundle_index": -1,
    "lifetime": None,
    "namespace": None,
    "get_if_exists": False,
    "runtime_env": None,
    "memory": None,
    "accelerator_type": None,
    "tensor_transport": None,
}


def _check_transport(tt) -> None:
    if tt not in (None, "object_store", "device"):
        raise ValueError("tensor_transport must be None, 'object_store', "
                         "or 'device'")


def _validate_options(opts: dict, for_actor: bool) -> dict:
    out = dict(_OPTION_DEFAULTS)
    for k, v in opts.items():
        if k not in _OPTION_DEFAULTS:
            raise ValueError(f"unknown option {k!r}")
        out[k] = v
    if out["lifetime"] not in (None, "detached", "non_detached"):
        raise ValueError("lifetime must be None, 'detached', or 'non_detached'")
    _check_transport(out["tensor_transport"])
    if not for_actor and out["max_restarts"]:
        raise ValueError("max_restarts is an actor option")
    return out


def _build_resources(opts: dict, default_cpus: float) -> dict:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = opts["num_cpus"]
    elif "CPU" not in res:
        res["CPU"] = default_cpus
    if opts.get("num_gpus") is not None:
        res["GPU"] = opts["num_gpus"]
    if opts.get("num_tpus") is not None:
        res["TPU"] = opts["num_tpus"]
    if opts.get("memory") is not None:
        res["memory"] = opts["memory"]
    if opts.get("accelerator_type"):
        res[f"accelerator_type:{opts['accelerator_type']}"] = 0.001
    return normalize_resources(res)


_runtime_env_mod = None


def _effective_runtime_env(task_env: dict | None) -> dict | None:
    """Task env merged over the job-level default (reference semantics:
    job runtime_env inherited unless the task overrides per-field), with
    local working_dir/py_modules dirs packed + uploaded to the GCS KV as
    content-addressed packages (reference: working_dir upload)."""
    global _runtime_env_mod
    if _runtime_env_mod is None:
        from ray_tpu_torch import runtime_env as _runtime_env_mod_  # cycle-free
        _runtime_env_mod = _runtime_env_mod_
    m = _runtime_env_mod
    if task_env is None and m.get_job_runtime_env() is None:
        return None  # hot path: no env anywhere, skip merge machinery
    return m.prepare_for_wire(
        m.RuntimeEnv.merge(m.get_job_runtime_env(), task_env))


def _wire_strategy(opts: dict):
    """Convert a SchedulingStrategy option to wire form."""
    strategy = opts.get("scheduling_strategy")
    pg_id = ""
    bundle_index = opts.get("placement_group_bundle_index", -1)
    if opts.get("placement_group") is not None:
        pg = opts["placement_group"]
        pg_id = pg.id.hex() if hasattr(pg, "id") else str(pg)
    if strategy is None:
        return None, pg_id, bundle_index
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return ["spread"], pg_id, bundle_index
        if strategy == "DEFAULT":
            return None, pg_id, bundle_index
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return ["node_affinity", strategy.node_id, strategy.soft], pg_id, bundle_index
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        return None, pg.id.hex(), strategy.placement_group_bundle_index
    raise ValueError(f"unsupported scheduling strategy {strategy!r}")


class RemoteFunction:
    def __init__(self, fn, opts: dict):
        self._fn = fn
        self._opts = _validate_options(opts, for_actor=False)
        # Registration cache keyed per job: decorated module-level functions
        # outlive clusters (tests start many), so one cached key would point
        # at a GCS that no longer exists.
        self._func_keys: dict[str, str] = {}
        self._wire_cache = None  # (strategy triple, resources) per-opts
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = {k: v for k, v in self._opts.items() if v != _OPTION_DEFAULTS[k]}
        merged.update(opts)
        rf = RemoteFunction(self._fn, merged)
        rf._func_keys = self._func_keys
        return rf

    def remote(self, *args, **kwargs):
        cw = get_core_worker()
        func_key = self._func_keys.get(cw.job_id)
        if func_key is None:
            func_key = self._func_keys[cw.job_id] = cw.register_function(self._fn)
        wire_args, kwargs_keys, _deps, nested = cw.serialize_args(args, kwargs)
        # Options are immutable per RemoteFunction (options() returns a new
        # instance): derive strategy/resources once, not per .remote().
        cached = self._wire_cache
        if cached is None:
            cached = self._wire_cache = (
                _wire_strategy(self._opts),
                _build_resources(self._opts, default_cpus=1.0))
        (strategy, pg_id, bundle_index), resources = cached
        task_id = cw.next_task_id()
        streaming = self._opts["num_returns"] in ("streaming", "dynamic")
        transport = self._opts["tensor_transport"]
        spec = TaskSpec(
            task_id=task_id.hex(),
            job_id=cw.job_id,
            name=self._opts["name"] or getattr(self._fn, "__name__", "anonymous"),
            func_key=func_key,
            args=wire_args,
            kwargs_keys=kwargs_keys,
            num_returns=-1 if streaming else self._opts["num_returns"],
            resources=dict(resources),  # spec owns a private copy
            # Streaming tasks retry like plain tasks: a retried
            # generator re-executes from scratch and the owner
            # fast-forwards already-delivered yields by index
            # (reference: generator retry semantics in task_manager.cc
            # HandleReportGeneratorItemReturns).
            max_retries=self._opts["max_retries"],
            retry_exceptions=bool(self._opts["retry_exceptions"]),
            owner=cw.address.to_wire(),
            strategy=strategy,
            placement_group=pg_id,
            pg_bundle_index=bundle_index,
            runtime_env=_effective_runtime_env(self._opts["runtime_env"]),
            tensor_transport=transport if transport == "device" else "",
        )
        submit = cw.submit_streaming_task if streaming else cw.submit_task
        if tracing.enabled():
            with tracing.submit_span(spec.name, spec.task_id) as trace_ctx:
                spec.trace_ctx = trace_ctx
                out = submit(spec, nested_args=nested, task_id=task_id)
        else:  # hot path: skip two contextmanager frames per task
            out = submit(spec, nested_args=nested, task_id=task_id)
        if streaming:
            return ObjectRefGenerator(spec.task_id, cw.address, out)
        ref_cls = DeviceObjectRef if transport == "device" else ObjectRef
        refs = [ref_cls(oid, cw.address) for oid in out]
        if self._opts["num_returns"] == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__!r} cannot be called directly; "
            f"use .remote()")


class ObjectRefGenerator:
    """Iterator of ObjectRefs from a num_returns="streaming" task
    (reference: ray ObjectRefGenerator / DynamicObjectRefGenerator).
    Items arrive as the remote generator yields; iteration blocks until
    the next item, raises the task's error at the failure point, and
    stops when the task completes."""

    def __init__(self, task_id_hex: str, owner, queue):
        self._task_id = task_id_hex
        self._owner = owner
        self._q = queue
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item[0] == "item":
            from ray_tpu_torch._private.ids import ObjectID

            return ObjectRef(ObjectID.from_hex(item[1]), self._owner)
        self._done = True
        cw = _core_worker
        if cw is not None:
            # Exhausted/failed: nothing buffered left to free — drop the
            # owner-side stream bookkeeping now (close() after this is a
            # no-op thanks to _done).
            cw.stream_finished(self._task_id)
        if item[0] == "end":
            raise StopIteration
        from ray_tpu_torch import exceptions as _exc
        from ray_tpu_torch._private import serialization

        kind, value = serialization.deserialize(bytes(item[1]),
                                                bytes(item[2]))
        if kind == serialization.KIND_EXCEPTION:
            cause, tb = value
            if isinstance(cause, _exc.RayTpuError):
                raise cause
            raise _exc.TaskError(cause, tb)
        raise RuntimeError(str(value))

    def completed(self) -> bool:
        return self._done

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        """`async for ref in gen` — the blocking queue wait offloads to
        a thread so the event loop stays free (reference: ObjectRef
        generators are async-iterable inside async actors)."""
        import asyncio

        _end = object()

        def step():
            # StopIteration cannot cross a Future boundary; sentinel it.
            try:
                return self.__next__()
            except StopIteration:
                return _end

        out = await asyncio.to_thread(step)
        if out is _end:
            raise StopAsyncIteration
        return out

    def close(self) -> None:
        """Release unconsumed yields (reference: Ray frees unconsumed
        generator returns when the generator is destructed). The core
        worker's IO loop drains buffered items and frees later arrivals
        — draining here would race an in-flight yield dispatch."""
        if self._done:
            return
        self._done = True
        cw = _core_worker
        if cw is not None:
            cw.abandon_stream(self._task_id)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, tensor_transport: str | None = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._tensor_transport = tensor_transport

    def options(self, **opts):
        bad = set(opts) - {"num_returns", "tensor_transport"}
        if bad:
            raise ValueError(f"unknown actor-method options {sorted(bad)}")
        n = opts.get("num_returns", self._num_returns)
        tt = opts.get("tensor_transport", self._tensor_transport)
        _check_transport(tt)
        return ActorMethod(self._handle, self._method_name, n, tt)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, self._num_returns,
            tensor_transport=self._tensor_transport)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._method_name!r} cannot be called directly; "
            f"use .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str,
                 max_task_retries: int = 0,
                 tensor_transport: str | None = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        # Class-level @ray_tpu_torch.remote(tensor_transport=...) default;
        # per-method .options(tensor_transport=...) overrides.
        self._tensor_transport = tensor_transport

    @property
    def _id_hex(self) -> str:
        return self._actor_id.hex()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name,
                           tensor_transport=self._tensor_transport)

    def _submit_method(self, method_name: str, args, kwargs, num_returns,
                       tensor_transport: str | None = None):
        cw = get_core_worker()
        streaming = num_returns in ("streaming", "dynamic")
        wire_args, kwargs_keys, _, nested = cw.serialize_args(args, kwargs)
        task_id = cw.next_task_id()
        spec = TaskSpec(
            task_id=task_id.hex(),
            job_id=cw.job_id,
            name=f"{self._class_name}.{method_name}",
            func_key="",
            args=wire_args,
            kwargs_keys=kwargs_keys,
            num_returns=-1 if streaming else num_returns,
            resources={},
            max_retries=0,
            owner=cw.address.to_wire(),
            actor_id=self._actor_id.hex(),
            tensor_transport=("device" if tensor_transport == "device"
                              else ""),
        )
        with tracing.submit_span(spec.name, spec.task_id) as trace_ctx:
            spec.trace_ctx = trace_ctx
            out = cw.submit_actor_task(self._actor_id.hex(), spec,
                                       self._max_task_retries,
                                       nested_args=nested)
        if streaming:
            return ObjectRefGenerator(spec.task_id, cw.address, out)
        ref_cls = (DeviceObjectRef if tensor_transport == "device"
                   else ObjectRef)
        refs = [ref_cls(oid, cw.address) for oid in out]
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (_rebuild_actor_handle,
                (self._actor_id.binary(), self._class_name,
                 self._max_task_retries, self._tensor_transport))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


def _rebuild_actor_handle(id_bytes, class_name, max_task_retries,
                          tensor_transport=None):
    return ActorHandle(ActorID(id_bytes), class_name, max_task_retries,
                       tensor_transport)


class ActorClass:
    def __init__(self, cls, opts: dict):
        self._cls = cls
        self._opts = _validate_options(opts, for_actor=True)
        self._class_keys: dict[str, str] = {}  # per-job, see RemoteFunction

    def options(self, **opts) -> "ActorClass":
        merged = {k: v for k, v in self._opts.items() if v != _OPTION_DEFAULTS[k]}
        merged.update(opts)
        ac = ActorClass(self._cls, merged)
        ac._class_keys = self._class_keys
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        cw = get_core_worker()
        class_key = self._class_keys.get(cw.job_id)
        if class_key is None:
            class_key = self._class_keys[cw.job_id] = cw.register_function(self._cls)
        actor_id = ActorID.from_random()
        # Constructor args are held for the actor's lifetime (the actor
        # may stash nested refs in self; released with the job).
        wire_args, kwargs_keys, _, _nested = cw.serialize_args(args, kwargs)
        strategy, pg_id, bundle_index = _wire_strategy(self._opts)
        task_id = cw.next_task_id()
        spec = TaskSpec(
            task_id=task_id.hex(),
            job_id=cw.job_id,
            name=f"{self._cls.__name__}.__init__",
            func_key=class_key,
            args=wire_args,
            kwargs_keys=kwargs_keys,
            num_returns=0,
            # Actors with no explicit resources hold 0 CPU while alive
            # (reference: python/ray/actor.py default num_cpus=0 for
            # running — long-lived actors must not starve task scheduling).
            resources=_build_resources(self._opts, default_cpus=0.0),
            owner=cw.address.to_wire(),
            actor_id=actor_id.hex(),
            actor_creation=True,
            max_restarts=self._opts["max_restarts"],
            max_task_retries=self._opts["max_task_retries"],
            strategy=strategy,
            placement_group=pg_id,
            pg_bundle_index=bundle_index,
            runtime_env=_effective_runtime_env(self._opts["runtime_env"]),
            max_concurrency=int(self._opts["max_concurrency"] or 1),
        )
        with tracing.submit_span(spec.name, spec.task_id) as trace_ctx:
            spec.trace_ctx = trace_ctx
            resp = cw.create_actor(
                spec,
                name=self._opts["name"] or "",
                namespace=self._opts["namespace"] or "default",
                class_name=self._cls.__name__,
                detached=self._opts["lifetime"] == "detached",
                get_if_exists=self._opts["get_if_exists"])
        if not resp.get("ok"):
            raise exc.RayTpuError(resp.get("reason", "actor registration failed"))
        transport = self._opts["tensor_transport"]
        if resp.get("existing"):
            return ActorHandle(ActorID.from_hex(resp["actor_id"]),
                               self._cls.__name__,
                               self._opts["max_task_retries"], transport)
        return ActorHandle(actor_id, self._cls.__name__,
                           self._opts["max_task_retries"], transport)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use .remote()")


def make_remote(obj, opts: dict):
    if isinstance(obj, type):
        return ActorClass(obj, opts)
    if callable(obj):
        return RemoteFunction(obj, opts)
    raise TypeError("@ray_tpu_torch.remote requires a function or class")
