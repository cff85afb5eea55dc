"""PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` stays the reference; this package keeps its
module layout and names so each counterpart is easy to find:

- The runtime (`_private/`): a GCS, a raylet per node with its shared
  memory object store (`_private/csrc/object_store.cc`, built with g++ at
  first use) and worker processes forked from a torch-warm zygote. Tasks,
  actors, `put`/`get`/`wait` and placement groups work as in `ray_tpu`.
  A node reports its cards as `GPU`, and a lease of `num_gpus` pins the
  worker's CUDA_VISIBLE_DEVICES to distinct cards.
- `ray_tpu_torch.serve`: deployments, handles, the HTTP proxy and the
  binary RPC ingress, config deploys; the continuous-batching
  `LLMEngine` and `LLMServer` over a dense or paged KV cache, its decode
  chunk a CUDA graph on the card; disaggregated prefill and decode pools
  behind one router (`deploy_disagg`).
- `ray_tpu_torch.cluster_utils` and `test_utils`: fake multi-node
  clusters on one machine, and node killers and preempters for drains.
- `ray_tpu_torch.ops`: the hand-written Hopper kernels (paged decode
  attention, flash attention) beside their plain PyTorch versions.
- `ray_tpu_torch.models`, `parallel`, `train`, `rllib`: the model
  families, the mesh and sharding rules, the training step, checkpoints,
  the training gang (fixed or elastic) and learners.

Nothing here imports jax or ray_tpu, and importing a module starts no
process and does no CUDA work: kernels are built with nvcc at first use
(`_build.py`). Compute entry points take `device=None`, which means
CUDA, and raise where no card is present; pass `device="cpu"` to run the
plain versions on the CPU.

The top-level API mirrors the reference's (ray_tpu/__init__.py), which
mirrors the `ray` package surface.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import api_internal
from ray_tpu_torch._private.api_internal import (ActorClass, ActorHandle,
                                                 DeviceObjectRef, ObjectRef,
                                                 ObjectRefGenerator)
from ray_tpu_torch._private.config import Config

__version__ = "0.1.0"

_init_lock = threading.RLock()
_runtime_node = None  # RuntimeNode when this process started the cluster
_driver_core_worker = None


def init(address: str | None = None, *, resources: dict | None = None,
         labels: dict | None = None, num_cpus: float | None = None,
         object_store_memory: int | None = None, namespace: str | None = None,
         config: Config | None = None, ignore_reinit_error: bool = False,
         log_to_driver: bool | None = None, runtime_env: dict | None = None):
    """Start (or connect to) a cluster and attach this process as a driver.

    address=None starts a local head (GCS + raylet) like the reference's
    `ray.init()`; its node reports the cards it sees as `GPU` unless
    `resources` says otherwise. address="host:port" connects
    to an existing GCS. address="client://host:port" (client mode) waits
    for ROADMAP A1's second part.
    """
    global _runtime_node, _driver_core_worker
    from ray_tpu_torch._private.node import RuntimeNode
    from ray_tpu_torch._private.worker import CoreWorker

    if address is not None and address.startswith("client://"):
        raise NotImplementedError(
            "init(address='client://...') needs client mode, which comes "
            "with ROADMAP A1's second part; start or join a cluster with "
            "address=None or address='host:port'")
    with _init_lock:
        if _driver_core_worker is not None:
            if ignore_reinit_error:
                return
            raise exceptions.RayTpuError("ray_tpu_torch.init() called twice")
        cfg = config or Config()
        if object_store_memory:
            cfg.object_store_memory = int(object_store_memory)
        if log_to_driver is not None:  # explicit kwarg wins over Config
            cfg.log_to_driver = bool(log_to_driver)
        if address is None:
            node = RuntimeNode(cfg)
            try:
                gcs_host, gcs_port = node.start_gcs()
                head_res = dict(resources or {})
                if num_cpus is not None:
                    head_res.setdefault("CPU", num_cpus)
                handle = node.start_raylet(resources=head_res or None,
                                           labels=labels, is_head=True)
            except BaseException:
                node.shutdown()
                raise
            _runtime_node = node
            raylet_host, raylet_port = handle.host, handle.port
            store_path = handle.store_path
            node_id = handle.node_id
        else:
            gcs_host, gcs_port_s = address.rsplit(":", 1)
            gcs_port = int(gcs_port_s)
            # Attach to a raylet from the GCS node table (reference:
            # ray.init(address=...) bootstraps from the GCS): prefer this
            # host's raylet (the shared-memory store is local), else the
            # head node's.
            import socket

            local_names = {"127.0.0.1", "localhost", socket.gethostname()}
            try:
                local_names.add(socket.gethostbyname(socket.gethostname()))
            except OSError:
                pass
            alive = [n for n in _query_nodes(gcs_host, gcs_port, cfg)
                     if n.get("alive")]
            alive.sort(key=lambda n: (n["host"] not in local_names,
                                      not n.get("is_head")))
            if not alive:
                raise exceptions.RayTpuError(
                    f"no alive nodes in cluster at {address}")
            chosen = alive[0]
            raylet_host = chosen["host"]
            raylet_port = chosen["raylet_port"]
            store_path = chosen["store_path"]
            node_id = chosen["node_id"]
        cw = CoreWorker(
            gcs_host=gcs_host, gcs_port=gcs_port,
            raylet_host=raylet_host, raylet_port=raylet_port,
            store_path=store_path, node_id=node_id,
            is_driver=True, config=cfg, owns_cluster=address is None)
        _driver_core_worker = cw
        api_internal.set_core_worker(cw)
        if runtime_env is not None:
            from ray_tpu_torch.runtime_env import set_job_runtime_env

            set_job_runtime_env(runtime_env)


def _query_nodes(gcs_host: str, gcs_port: int, cfg: Config) -> list[dict]:
    """One-shot GCS query usable before a CoreWorker exists."""
    import asyncio
    import concurrent.futures

    from ray_tpu_torch._private import rpc

    async def go():
        conn = await rpc.dial(
            gcs_host, gcs_port, name="init-bootstrap",
            timeout=cfg.rpc_connect_timeout_s)
        try:
            resp = await conn.call("GetAllNodes", {},
                                   timeout=cfg.rpc_call_timeout_s)
            return resp["nodes"]
        finally:
            await conn.close()

    # A dedicated thread, not asyncio.run(): init() may be called from
    # inside a running event loop (notebook cell, async web handler).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(asyncio.run, go()).result()


def is_initialized() -> bool:
    return api_internal.core_worker_or_none() is not None


def shutdown():
    global _runtime_node, _driver_core_worker
    with _init_lock:
        cw = api_internal.core_worker_or_none()
        if cw is not None:
            cw.shutdown()
        api_internal.set_core_worker(None)
        _driver_core_worker = None
        from ray_tpu_torch.runtime_env import set_job_runtime_env

        set_job_runtime_env(None)
        if _runtime_node is not None:
            _runtime_node.shutdown()
            _runtime_node = None


def remote(*args, **kwargs):
    """@ray_tpu_torch.remote decorator for functions and classes."""
    if len(args) == 1 and not kwargs and (callable(args[0])
                                          or isinstance(args[0], type)):
        return api_internal.make_remote(args[0], {})
    if args:
        raise TypeError("@ray_tpu_torch.remote takes keyword options only")

    def wrap(obj):
        return api_internal.make_remote(obj, kwargs)

    return wrap


def put(value: Any) -> ObjectRef:
    cw = api_internal.get_core_worker()
    if isinstance(value, ObjectRef):
        raise TypeError("ray_tpu_torch.put() of an ObjectRef is not allowed")
    oid, owner = cw.put(value)
    return ObjectRef(oid, owner)


def get(refs, timeout: float | None = None):
    cw = api_internal.get_core_worker()
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"ray_tpu_torch.get() takes ObjectRefs, got {type(r)}")
    values = cw.get([(r.id, r.owner) for r in refs], timeout=timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None):
    cw = api_internal.get_core_worker()
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    ready_idx, not_ready_idx = cw.wait(
        [(r.id, r.owner) for r in refs], num_returns=num_returns,
        timeout=timeout)
    return [refs[i] for i in ready_idx], [refs[i] for i in not_ready_idx]


def kill(actor, *, no_restart: bool = True):
    cw = api_internal.get_core_worker()
    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill() takes an ActorHandle")
    cw.kill_actor(actor._id_hex, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    """Best-effort cancellation of a pending task (reference:
    worker.py:2850)."""
    cw = api_internal.get_core_worker()
    task_id = ref.id.task_id().hex()

    def _cancel_on_loop():
        # Queue/pending-task state is owned by the IO loop thread.
        pt = cw.pending_tasks.get(task_id)
        if pt is None or pt.pushed_to is not None:
            return
        from ray_tpu_torch._private import serialization

        err = serialization.serialize_exception(
            exceptions.TaskCancelledError(f"task {task_id[:12]} cancelled"))
        for q in cw._queues.values():
            if task_id in q:
                q.remove(task_id)
        cw._complete_task_error(pt, err)

    cw.loop.call_soon_threadsafe(_cancel_on_loop)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    cw = api_internal.get_core_worker()
    resp = cw._run(cw.gcs.call("GetNamedActor", {
        "name": name, "namespace": namespace or "default"}))
    if not resp.get("found"):
        raise ValueError(f"named actor {name!r} not found")
    from ray_tpu_torch._private.ids import ActorID

    return ActorHandle(ActorID.from_hex(resp["actor_id"]), name)


def nodes() -> list[dict]:
    cw = api_internal.get_core_worker()
    return cw._run(cw.gcs.call("GetAllNodes", {}))["nodes"]


def _sum_resources(key: str) -> dict:
    total: dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for k, v in n[key].items():
                total[k] = total.get(k, 0.0) + v
    return total


def cluster_resources() -> dict:
    return _sum_resources("total_resources")


def available_resources() -> dict:
    return _sum_resources("available_resources")


class _RuntimeContext:
    def __init__(self, cw):
        self._cw = cw

    @property
    def job_id(self) -> str:
        return self._cw.job_id

    @property
    def node_id(self) -> str:
        return self._cw.node_id

    @property
    def worker_id(self) -> str:
        return self._cw.worker_id

    @property
    def task_id(self) -> str:
        return self._cw._current_task_id.hex()

    @property
    def actor_id(self) -> str | None:
        return self._cw._actor_id

    def get_node_id(self) -> str:
        return self._cw.node_id

    def get_accelerator_ids(self) -> dict[str, list[str]]:
        """The cards this worker's lease holds (reference:
        RuntimeContext.get_accelerator_ids)."""
        return {"GPU": list(getattr(self._cw, "_lease_gpu_ids", []))}


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext(api_internal.get_core_worker())


def method(num_returns: int = 1):
    """@ray_tpu_torch.method decorator for actor methods (parity:
    ray.method)."""

    def wrap(fn):
        fn._ray_tpu_num_returns = num_returns
        return fn

    return wrap


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "put", "get", "wait",
    "ObjectRefGenerator",
    "kill", "cancel", "get_actor", "nodes", "cluster_resources",
    "available_resources", "get_runtime_context", "method",
    "ObjectRef", "DeviceObjectRef", "ActorHandle", "ActorClass", "Config",
    "exceptions",
]
