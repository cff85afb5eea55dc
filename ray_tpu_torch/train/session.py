"""Per-worker training session: report(), rank info, gradient sync. Port
of ray_tpu/train/session.py (reference: python/ray/train/_internal/
session.py, _TrainSession; session.report streams metrics and
checkpoints to the trainer).

The elastic part: `keep_state` preserves the loop's state for a resize
and is the gang's pause boundary, `get_elastic_state`,
`get_elastic_state_step`, `get_peer_states` and `get_elastic_epoch`
read what a resumed or grown worker starts from.

Where a pause lands. The kept tree is the live tensors, which the next
step updates in place, so once a loop keeps state the pause lands only
at keep_state(), where the tree is exactly that step's state (at
report(), between the step's update and its keep_state, it would not
be). With a collective group of more than one rank the pause is the
gang's vote at keep_state() (a one-element MAX allreduce over the
gang's group): every rank parks at the same step when any rank was
asked to pause, where a rank that parked alone would leave its peers
blocked in the next step's gradient allreduce. A loop that keeps no
state and has no group pauses at report(), as the reference's does.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any

_local = threading.local()


class ElasticPauseInterrupt(BaseException):
    """Raised inside the user loop at a step boundary when the trainer
    (or this node's drain notice) asked for a pause for an elastic
    resize. A BaseException so a user's `except Exception` cannot swallow
    it; TrainWorker.run catches it and parks the worker, which is not an
    error."""


class SessionStopped(BaseException):
    """Raised at the next step boundary after TrainWorker.stop(): graceful
    session shutdown, never mid-report(). A BaseException so a user's
    `except Exception` cannot swallow it."""


class _SessionControl:
    """Trainer-to-worker control shared between the actor thread
    (request_pause, stop) and the user-loop thread (boundary checks)."""

    def __init__(self):
        self.stop_requested = threading.Event()
        self.pause_requested = threading.Event()


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
    # Elastic: the state this worker kept before its last pause, its
    # step, peer states handed over from departed ranks (or seeded from
    # rank 0 on a grown worker), the resize epoch (0: never resized) and
    # the worker's keep_state hook.
    elastic_state: Any = None
    elastic_state_step: int | None = None
    peer_states: dict | None = None
    elastic_epoch: int = 0
    on_keep_state: Any = None


def _grouped(s: _Session) -> bool:
    return s.collective_group is not None and s.world_size > 1


def _vote_pause(s: _Session, pause: bool) -> bool:
    """Whether any rank of the gang was asked to pause: a MAX allreduce
    of one flag over the gang's group (on the card for NCCL)."""
    import torch

    from ray_tpu_torch.util.collective import allreduce
    from ray_tpu_torch.util.collective.collective import _manager

    dev = "cuda" if _manager.get(s.collective_group).backend == "nccl" \
        else "cpu"
    flag = torch.tensor([1.0 if pause else 0.0], device=dev)
    allreduce(flag, group_name=s.collective_group, op="max")
    return bool(flag.item())


def _check_boundary(s: _Session, at_keep_state: bool = False) -> None:
    """Step-boundary control check: stop wins over pause. A pause lands
    at keep_state once the loop keeps state (its tree is that step's
    state only there: report() comes after the step's in-place update
    and before its keep_state), and with a group it is the gang's vote;
    a loop that keeps no state and has no group pauses at report()."""
    c = s.control
    if c is None:
        return
    if c.stop_requested.is_set():
        raise SessionStopped()
    if not at_keep_state and (_grouped(s)
                              or s.elastic_state_step is not None):
        return
    pause = c.pause_requested.is_set()
    if _grouped(s):
        pause = _vote_pause(s, pause)
    if pause:
        raise ElasticPauseInterrupt()


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
    # report() is a step boundary: a graceful stop (and, in a loop that
    # keeps no state and has no group, a pause) lands here, after the
    # metrics and checkpoint pointer are on the queue.
    _check_boundary(s)


def keep_state(state, step: int | None = None) -> None:
    """Preserve `state` (a tree of tensors: the model's parameters and
    the optimizer's state) for an elastic resume; call it once a step,
    after report().

    The worker pins the tree's tensors in its device registry with the
    trainer as ref owner, so a node drain evacuates them through the
    device plane and a resize hands them to the gang without a
    checkpoint. Survivors read their own tree back with
    get_elastic_state(); departed ranks' trees reach the survivors, and a
    survivor's the grown workers, through get_peer_states().

    The pins are the live tensors, which the next step updates in place:
    the tree is the step's state only while the loop is parked. It is the
    gang's pause boundary (see the module docstring), and a drain's
    evacuation parks the loop here before it gathers the pins, so a
    resize always reads a tree equal to the state of the step it
    records."""
    s = _get_session()
    s.elastic_state = state
    s.elastic_state_step = int(step) if step is not None \
        else (s.elastic_state_step or 0) + 1
    if s.on_keep_state is not None:
        s.on_keep_state(state, s.elastic_state_step)
    _check_boundary(s, at_keep_state=True)


def get_elastic_state():
    """This worker's own kept state (from keep_state) when the run
    resumes after an elastic pause; None on a fresh start."""
    return _get_session().elastic_state


def get_elastic_state_step() -> int | None:
    """The step kept with that state, or None."""
    return _get_session().elastic_state_step


def get_peer_states() -> dict:
    """{old_rank: state tree} handed over from ranks that left (shrink)
    or, on a freshly grown worker, seeded from rank 0. Empty on a fresh
    start and for survivors whose peers did not change."""
    return dict(_get_session().peer_states or {})


def get_elastic_epoch() -> int:
    """How many elastic resizes this run has been through (0: none)."""
    return _get_session().elastic_epoch


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
    if _grouped(s):
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
