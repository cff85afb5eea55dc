"""WorkerGroup: the Train actor topology. Port of
ray_tpu/train/worker_group.py (reference: python/ray/train/_internal/
worker_group.py, WorkerGroup over RayTrainWorker actors; session.py, the
per-worker session runs the user loop in a thread and streams reports).

Each TrainWorker holds a lease of `ScalingConfig.worker_resources()`,
which pins it to its cards. A gang's collective group is a
torch.distributed process group (NCCL on cards, gloo on the CPU),
installed as the worker's default group so DDP, DeviceMesh and DCP
checkpoints run over it. Weights reach the workers through the device
plane (`broadcast_weights`). The reference's elastic members (pauses,
kept state, peer states) wait for ROADMAP A5's elastic gang.
"""

from __future__ import annotations

import os
import queue
import threading
import traceback

import ray_tpu_torch
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy


@ray_tpu_torch.remote
class TrainWorker:
    """One training worker process (reference: RayTrainWorker)."""

    def __init__(self, rank: int, world_size: int, env: dict | None = None):
        self.rank = rank
        self.world_size = world_size
        self._reports: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._done = False
        self._error: str | None = None
        self._result = None
        self._ctl = None
        self._broadcast_weights = None
        for k, v in (env or {}).items():
            os.environ[k] = str(v)
        os.environ["RAY_TPU_TORCH_TRAIN_RANK"] = str(rank)
        os.environ["RAY_TPU_TORCH_TRAIN_WORLD_SIZE"] = str(world_size)

    def setup_collective(self, group_name: str, backend: str) -> bool:
        from ray_tpu_torch.util.collective import init_collective_group

        init_collective_group(self.world_size, self.rank, backend=backend,
                              group_name=group_name, as_default_group=True)
        return True

    def run(self, fn_blob: bytes, config: dict) -> bool:
        """Start the user train loop in a thread (session semantics)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.train import session

        prev = self._thread
        if prev is not None and prev.is_alive():
            prev.join(timeout=5.0)
        fn = serialization.loads_func(fn_blob)
        ctl = session._SessionControl()
        self._ctl = ctl
        self._done = False
        self._error = None

        def target():
            session._set_session(session._Session(
                rank=self.rank, world_size=self.world_size,
                report_queue=self._reports,
                collective_group=config.get("_collective_group"),
                restore_checkpoint_path=config.get("_checkpoint_path"),
                storage_path=config.get("_storage_path"),
                control=ctl,
                broadcast_weights=self._broadcast_weights))
            try:
                self._result = fn(config) if _wants_arg(fn) else fn()
            except session.SessionStopped:
                pass
            except BaseException as e:  # noqa: BLE001
                self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            finally:
                self._done = True
                session._set_session(None)

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def poll(self, max_items: int = 100) -> dict:
        """Drain buffered report()s; say whether the loop finished."""
        items = []
        while len(items) < max_items:
            try:
                items.append(self._reports.get_nowait())
            except queue.Empty:
                break
        return {"reports": items, "done": self._done, "error": self._error,
                "result": self._result if self._done and not self._error
                else None}

    def stop(self, timeout: float = 5.0) -> dict:
        """Graceful session shutdown: request a stop at the next step
        boundary and join the user-loop thread, so teardown never kills
        the worker mid-report()."""
        ctl = self._ctl
        if ctl is not None:
            ctl.stop_requested.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        out = self.poll(max_items=1_000_000)
        out["joined"] = t is None or not t.is_alive()
        return out

    def receive_weights(self, weights) -> dict:
        """Device-plane weight broadcast sink: `weights` arrives resolved
        (the ref's descriptor took the tensors straight from the
        broadcaster's registry: IPC on a shared card, NCCL across cards,
        the host otherwise). Kept for the train loop
        (session.get_broadcast_weights)."""
        from ray_tpu_torch._private.device_objects import _is_tensor, tree_map

        self._broadcast_weights = weights
        leaves: list = []
        tree_map(weights, leaves.append, _is_tensor)
        return {"rank": self.rank, "leaves": len(leaves),
                "bytes": int(sum(x.numel() * x.element_size()
                                 for x in leaves))}

    def node_id(self) -> str:
        return ray_tpu_torch.get_runtime_context().node_id

    def shutdown(self) -> bool:
        return True


def _wants_arg(fn) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) > 0
    except (TypeError, ValueError):
        return False


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, env: dict | None = None):
        self.scaling = scaling
        self.env = env or {}
        self.pg = None
        n = scaling.num_workers
        if n > 1 or scaling.placement_strategy != "PACK":
            self.pg = placement_group(scaling.as_placement_group_bundles(),
                                      strategy=scaling.placement_strategy)
            if not self.pg.wait(timeout=120):
                from ray_tpu_torch import exceptions as exc

                remove_placement_group(self.pg)
                raise exc.PlacementGroupSchedulingError(
                    f"train worker placement group "
                    f"({scaling.as_placement_group_bundles()}) not schedulable "
                    f"within 120s — not enough free cluster resources")
        self.workers = [self._spawn(rank, n) for rank in range(n)]

    def _spawn(self, rank: int, world_size: int):
        res = self.scaling.worker_resources()
        opts = {"num_cpus": res.get("CPU", 1.0),
                "resources": {k: v for k, v in res.items()
                              if k not in ("CPU", "GPU")}}
        if res.get("GPU"):
            opts["num_gpus"] = res["GPU"]
        if self.pg is not None:
            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                placement_group=self.pg, placement_group_bundle_index=rank)
        return TrainWorker.options(**opts).remote(rank, world_size, self.env)

    def run_on_all(self, method: str, *args, **kwargs) -> list:
        return ray_tpu_torch.get([getattr(w, method).remote(*args, **kwargs)
                                  for w in self.workers], timeout=300)

    def broadcast_weights(self, params) -> list:
        """Broadcast initial weights to every worker through ONE device
        object: the driver pins the tensor tree in its own registry, the
        object path carries only the descriptor, and each worker takes
        the tensors from the driver by the device plane's route. Trees
        with no tensor leaves take a plain put."""
        from ray_tpu_torch._private import device_objects

        ref = device_objects.device_put(params)
        try:
            return ray_tpu_torch.get(
                [w.receive_weights.remote(ref) for w in self.workers],
                timeout=300)
        finally:
            del ref  # drop the pin once every worker has its copy

    def shutdown(self, graceful_timeout_s: float = 2.0):
        # Graceful first: stop() parks each user loop at a step boundary
        # and joins, so teardown never kills a worker mid-report().
        stops = []
        for w in self.workers:
            try:
                stops.append(w.stop.remote(graceful_timeout_s))
            except Exception:
                pass
        if stops:
            try:
                ray_tpu_torch.wait(stops, num_returns=len(stops),
                                   timeout=graceful_timeout_s + 3)
            except Exception:
                pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
