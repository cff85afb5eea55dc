"""WorkerGroup: the Train actor topology. Port of
ray_tpu/train/worker_group.py (reference: python/ray/train/_internal/
worker_group.py, WorkerGroup over RayTrainWorker actors; session.py, the
per-worker session runs the user loop in a thread and streams reports).

Each TrainWorker holds a lease of `ScalingConfig.worker_resources()`,
which pins it to its cards. A gang's collective group is a
torch.distributed process group (NCCL on cards, gloo on the CPU),
installed as the worker's default group so DDP, DeviceMesh and DCP
checkpoints run over it. Weights reach the workers through the device
plane (`broadcast_weights`).

An elastic gang's worker also keeps its loop's state (`_keep_state`:
the tensors pinned with the trainer as ref owner, so a drain re-homes
them to the trainer), parks at the step boundary on request or on its
node's drain notice, and takes a new rank, a new group and peer states
between two runs of the loop. Its evacuation preparer parks the loop
before a drain gathers the pins: the pins are the live tensors, which
the next optimizer step overwrites in place, and a gather in the middle
of a step would read a torn mix of two steps.
"""

from __future__ import annotations

import os
import queue
import threading
import time
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
        import uuid

        self.rank = rank
        self.world_size = world_size
        self._reports: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._done = False
        self._paused = False
        self._error: str | None = None
        self._result = None
        self._ctl = None
        self._broadcast_weights = None
        self._group: str | None = None
        # Elastic: the loop's kept tree, its registry pin prefix and the
        # stub tree the trainer resolves it through. _uid (not the rank)
        # keys the prefix: ranks change across resizes, registry keys
        # must not.
        self._elastic_state = None
        self._elastic_stub = None
        self._state_step = -1
        self._elastic_prefix: str | None = None
        self._pin_seq = 0
        self._owner_wire = None
        self._peer_states: dict | None = None
        self._elastic_epoch = 0
        self._park_timeout_s = 30.0
        self._uid = uuid.uuid4().hex[:8]
        self._elastic_hooks = False
        for k, v in (env or {}).items():
            os.environ[k] = str(v)
        os.environ["RAY_TPU_TORCH_TRAIN_RANK"] = str(rank)
        os.environ["RAY_TPU_TORCH_TRAIN_WORLD_SIZE"] = str(world_size)

    def setup_collective(self, group_name: str, backend: str) -> bool:
        from ray_tpu_torch.util.collective import init_collective_group

        self._leave_group()
        init_collective_group(self.world_size, self.rank, backend=backend,
                              group_name=group_name, as_default_group=True)
        self._group = group_name
        return True

    def _leave_group(self) -> None:
        """Destroy the gang group of an earlier membership epoch: a resize
        gives each epoch a group of its own."""
        if self._group is not None:
            from ray_tpu_torch.util.collective import \
                destroy_collective_group

            destroy_collective_group(self._group)
            self._group = None

    def run(self, fn_blob: bytes, config: dict) -> bool:
        """Start the user train loop in a thread (session semantics)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.train import session

        prev = self._thread
        if prev is not None and prev.is_alive():
            prev.join(timeout=5.0)
        fn = serialization.loads_func(fn_blob)
        self._owner_wire = config.get("_elastic_owner") or self._owner_wire
        self._elastic_epoch = int(config.get("_elastic_epoch", 0))
        self._park_timeout_s = float(config.get("_elastic_park_s", 30.0))
        if config.get("_elastic") and not self._elastic_hooks:
            self._register_elastic_hooks()
        ctl = session._SessionControl()
        self._ctl = ctl
        self._paused = False
        self._done = False
        self._error = None
        # Peer states go to one run: the one that follows the hand-off.
        peers, self._peer_states = self._peer_states, None

        def target():
            session._set_session(session._Session(
                rank=self.rank, world_size=self.world_size,
                report_queue=self._reports,
                collective_group=config.get("_collective_group"),
                restore_checkpoint_path=config.get("_checkpoint_path"),
                storage_path=config.get("_storage_path"),
                control=ctl,
                broadcast_weights=self._broadcast_weights,
                elastic_state=self._elastic_state,
                elastic_state_step=(self._state_step
                                    if self._state_step >= 0 else None),
                peer_states=peers,
                elastic_epoch=self._elastic_epoch,
                on_keep_state=self._keep_state))
            try:
                self._result = fn(config) if _wants_arg(fn) else fn()
            except session.ElasticPauseInterrupt:
                self._paused = True
            except session.SessionStopped:
                pass
            except BaseException as e:  # noqa: BLE001
                self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            finally:
                if not self._paused:
                    self._done = True
                session._set_session(None)

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def _register_elastic_hooks(self):
        """The worker-side pre-death signals, beside the trainer's GCS
        NODE subscription: the raylet's DrainNotice asks the loop to park
        at its next boundary, and the evacuation preparer parks it before
        the drain gathers this process's pins."""
        try:
            from ray_tpu_torch._private import device_objects
            from ray_tpu_torch._private.api_internal import get_core_worker

            get_core_worker().add_drain_notice_listener(
                lambda payload: self.request_pause())
            device_objects.add_evacuation_preparer(self._park_for_evacuation)
            self._elastic_hooks = True
        except Exception:
            pass  # the trainer-side signal still pauses the gang

    def _park_for_evacuation(self):
        """Evacuation preparer: park the loop at its boundary and wait for
        it (at most the resize budget), so the gathered pins are the
        state of the step they were kept at."""
        t = self._thread
        if t is None or not t.is_alive():
            return
        self.request_pause()
        deadline = time.monotonic() + self._park_timeout_s
        while t.is_alive() and not self._paused \
                and time.monotonic() < deadline:
            time.sleep(0.01)

    def _keep_state(self, state, step: int):
        """session.keep_state's hook (on the loop's thread): pin the
        tree's tensors with the TRAINER as ref owner, so a drain
        evacuates them to the trainer, and keep a stub tree the trainer
        resolves from either end. The previous step's pins are released:
        they are the same live tensors."""
        self._elastic_state = state
        self._state_step = int(step)
        stub = state
        if self._owner_wire is not None:
            from ray_tpu_torch._private import device_objects
            from ray_tpu_torch._private.api_internal import get_core_worker

            self._pin_seq += 1
            prefix = f"elastic:{self._uid}:{self._pin_seq}"
            stubbed, _nbytes, n = device_objects.extract_arrays(
                state, prefix, get_core_worker())
            if n:
                reg = device_objects.registry()
                reg.note_ref_owner(prefix, self._owner_wire)
                old, self._elastic_prefix = self._elastic_prefix, prefix
                stub = stubbed
                if old:
                    reg.release_prefix(old, counted=False)
        self._elastic_stub = stub

    def poll(self, max_items: int = 100) -> dict:
        """Drain buffered report()s; say whether the loop finished or
        parked."""
        items = []
        while len(items) < max_items:
            try:
                items.append(self._reports.get_nowait())
            except queue.Empty:
                break
        return {"reports": items, "done": self._done, "error": self._error,
                "paused": self._paused, "state_step": self._state_step,
                "result": self._result if self._done and not self._error
                else None}

    def request_pause(self) -> bool:
        """Ask the loop to park at its next step boundary."""
        ctl = self._ctl
        if ctl is not None:
            ctl.pause_requested.set()
        return ctl is not None

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

    def reconfigure(self, rank: int, world_size: int) -> bool:
        """Adopt a new gang shape (only while parked or done); the old
        epoch's group goes."""
        self._leave_group()
        self.rank = rank
        self.world_size = world_size
        os.environ["RAY_TPU_TORCH_TRAIN_RANK"] = str(rank)
        os.environ["RAY_TPU_TORCH_TRAIN_WORLD_SIZE"] = str(world_size)
        return True

    def export_state(self) -> dict:
        """The kept state as a stub tree (the trainer resolves it through
        the device plane: from this process while it lives, from its own
        registry once a drain re-homed the pins there) and its step."""
        return {"stub": self._elastic_stub, "step": self._state_step}

    def receive_peer_states(self, states) -> dict:
        """Peer state trees for the next run: [a device-object ref] (the
        shrink's hand-off from the trainer) or a stub tree (grow: from
        the pinning survivor), both resolved HERE. Returns the bytes and
        the device plane's routes this took."""
        from ray_tpu_torch._private import device_objects
        from ray_tpu_torch._private.api_internal import get_core_worker

        before = device_objects.counters()
        if isinstance(states, list):
            states = ray_tpu_torch.get(states[0], timeout=300)
        self._peer_states = {
            k: device_objects.resolve_value(v, get_core_worker())
            for k, v in (states or {}).items()}
        after = device_objects.counters()
        leaves: list = []
        device_objects.tree_map(self._peer_states, leaves.append,
                                device_objects._is_tensor)
        return {"rank": self.rank,
                "bytes": int(sum(x.numel() * x.element_size()
                                 for x in leaves)),
                "routes": {k: after[k] - before.get(k, 0) for k in (
                    "in_process", "ipc", "collective", "host_fallback")}}

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
        self.elastic = scaling.elastic is not None
        n = scaling.num_workers
        if self.elastic:
            # Placement groups cannot resize, so an elastic gang is
            # scheduled by plain resource demand (DRAINING nodes are
            # already excluded from placement); no STRICT_* guarantee.
            if scaling.placement_strategy.startswith("STRICT"):
                raise ValueError(
                    "elastic training cannot use a STRICT_* placement "
                    f"strategy (got {scaling.placement_strategy!r}): "
                    "membership changes at runtime")
        elif n > 1 or scaling.placement_strategy != "PACK":
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
        if self.elastic:
            # poll and request_pause must land while a stop() join or a
            # slow run boundary holds another call slot.
            opts["max_concurrency"] = 4
        return TrainWorker.options(**opts).remote(rank, world_size, self.env)

    def add_worker(self, rank: int, world_size: int):
        """Grow the gang by one (elastic grow-back)."""
        w = self._spawn(rank, world_size)
        self.workers.append(w)
        return w

    def remove_worker(self, w, *, stop_timeout_s: float = 2.0) -> None:
        """Drop one member (elastic shrink): graceful stop, then kill,
        which frees its lease so a draining node's bounded lease wait
        ends promptly."""
        try:
            ray_tpu_torch.wait([w.stop.remote(stop_timeout_s)],
                               timeout=stop_timeout_s + 3)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(w)
        except Exception:
            pass
        if w in self.workers:
            self.workers.remove(w)

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
