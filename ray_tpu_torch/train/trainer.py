"""TorchTrainer: the Train entry point. Port of ray_tpu/train/trainer.py's
fixed-gang path (reference: python/ray/train/data_parallel_trainer.py,
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
the last checkpoint a worker reported. The reference's elastic path
(drain-driven resize) waits for ROADMAP A5's elastic gang.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import serialization
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
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
        self.telemetry = {"full_restarts": 0}
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
        attempt = 0
        restore_from: Checkpoint | None = None
        # Survives retries: Result.metrics_history reflects the whole
        # run, not just the last attempt.
        history: list[dict] = []
        while True:
            try:
                return self._fit_once(restore_from, history)
            except exc.RayTpuError as e:
                attempt += 1
                if attempt > max_failures:
                    raise
                # Checkpoint restart (reference: FailureConfig retries
                # restore from the latest reported checkpoint).
                restore_from = getattr(e, "_last_checkpoint", None) \
                    or restore_from
                self.telemetry["full_restarts"] += 1
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
