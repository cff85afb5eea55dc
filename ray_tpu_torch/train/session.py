"""Per-worker training session: report(), rank info, gradient sync. Port
of ray_tpu/train/session.py (reference: python/ray/train/_internal/
session.py, _TrainSession; session.report streams metrics and
checkpoints to the trainer).

The reference's elastic part (`keep_state`, peer states, pauses) waits
for ROADMAP A5's elastic gang; a fixed gang's session is here.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any

_local = threading.local()


class SessionStopped(BaseException):
    """Raised at the next step boundary after TrainWorker.stop(): graceful
    session shutdown, never mid-report(). A BaseException so a user's
    `except Exception` cannot swallow it."""


class _SessionControl:
    """Trainer-to-worker control shared between the actor thread (stop)
    and the user-loop thread (boundary checks)."""

    def __init__(self):
        self.stop_requested = threading.Event()


@dataclass
class _Session:
    rank: int
    world_size: int
    report_queue: "queue.Queue"
    collective_group: str | None = None
    # Set when this run restores: a retried trainer attempt.
    restore_checkpoint_path: str | None = None
    # Durable root for dict checkpoints (RunConfig.storage_path); None =
    # node-local tempdir.
    storage_path: str | None = None
    control: Any = None
    # The tree WorkerGroup.broadcast_weights sent this worker, if any.
    broadcast_weights: Any = None
    # Dict checkpoints reported so far (names a gang's shared path).
    n_checkpoints: int = 0


def _check_boundary(s: _Session) -> None:
    c = s.control
    if c is not None and c.stop_requested.is_set():
        raise SessionStopped()


def _set_session(s: _Session | None) -> None:
    _local.session = s


def _get_session() -> _Session:
    s = getattr(_local, "session", None)
    if s is None:
        raise RuntimeError(
            "No active train session: this API must be called inside "
            "train_loop_per_worker")
    return s


def get_checkpoint():
    """The checkpoint this run should resume from, or None on a fresh
    start (reference: ray.train.get_checkpoint())."""
    s = _get_session()
    if s.restore_checkpoint_path is None:
        return None
    from ray_tpu_torch.train.checkpoint import Checkpoint

    return Checkpoint(s.restore_checkpoint_path)


def get_broadcast_weights():
    """The tree the trainer sent this worker through the device plane
    (TorchTrainer(initial_weights=...)), or None."""
    return _get_session().broadcast_weights


def report(metrics: dict, checkpoint=None) -> None:
    """Stream metrics (and optionally a Checkpoint) to the trainer. A
    plain dict is wrapped via Checkpoint.from_dict."""
    s = _get_session()
    payload = {"metrics": dict(metrics), "rank": s.rank}
    if checkpoint is not None:
        if isinstance(checkpoint, dict):
            checkpoint = _dict_checkpoint(s, checkpoint)
        payload["checkpoint_path"] = checkpoint.path
    s.report_queue.put(payload)
    # report() is THE step boundary: a graceful stop lands here, after
    # the metrics (and checkpoint pointer) are on the queue.
    _check_boundary(s)


def _dict_checkpoint(s: _Session, data: dict):
    """A dict checkpoint at a path of its own. In a gang every rank
    reports it and saves its part (DCP saves collectively over the
    gang's default group), so the path is one name on every rank: the
    gang's group and the count of dict checkpoints so far."""
    import os
    import tempfile
    import uuid

    from ray_tpu_torch.train.checkpoint import Checkpoint

    s.n_checkpoints += 1
    if s.world_size > 1:
        name = f"ckpt-{s.collective_group}-{s.n_checkpoints}".replace(
            ":", "-")
    else:
        name = f"ckpt-{uuid.uuid4().hex[:12]}"
    root = s.storage_path or os.path.join(tempfile.gettempdir(),
                                          "ray_tpu_torch_checkpoints")
    return Checkpoint.from_dict(data, os.path.join(root, "checkpoints",
                                                   name))


class _TrainContext:
    """Reference-shaped context object (ray.train.get_context())."""

    def get_world_rank(self) -> int:
        return get_world_rank()

    def get_world_size(self) -> int:
        return get_world_size()

    def get_local_rank(self) -> int:
        return get_local_rank()

    def get_local_world_size(self) -> int:
        return 1  # one worker per host in this topology

    def get_node_rank(self) -> int:
        return get_world_rank()


def get_context() -> _TrainContext:
    _get_session()  # raise outside a train loop, like the reference
    return _TrainContext()


def get_world_rank() -> int:
    return _get_session().rank


def get_world_size() -> int:
    return _get_session().world_size


def get_local_rank() -> int:
    return _get_session().rank  # one worker per host in this topology


def set_collective_group(name: str) -> None:
    _get_session().collective_group = name


def allreduce_gradients(grads, group_name: str | None = None):
    """The mean of a tree of gradient tensors over the gang's group (the
    reference's host-plane mean; here the group's backend moves them:
    NCCL on the card, gloo on the CPU). Each leaf is averaged in place
    and the same tree returned; leaves narrower than f32 are summed in
    f32, as the reference sums, and written back."""
    import torch
    from torch.utils._pytree import tree_leaves

    from ray_tpu_torch.util.collective import allreduce

    s = _get_session()
    group = group_name or s.collective_group
    if group is None or s.world_size == 1:
        return grads
    for g in tree_leaves(grads):
        if g is None:
            continue
        if g.dtype in (torch.float32, torch.float64):
            allreduce(g, group_name=group)
            g.div_(s.world_size)
        else:
            wide = g.float()
            allreduce(wide, group_name=group)
            g.copy_(wide.div_(s.world_size))
    return grads
