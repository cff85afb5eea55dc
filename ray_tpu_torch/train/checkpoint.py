"""Checkpoints on torch.distributed.checkpoint (DCP). Port of
ray_tpu/train/checkpoint.py:27-160, with DCP where the reference has
orbax.

- `Checkpoint`: a directory-backed checkpoint with an optional tree
  payload (under `state/`) and metrics (`metrics.json`).
- `save_pytree` / `restore_pytree`: a nested dict, list or tuple of
  tensors, numpy arrays and Python scalars, or a `TrainState`. A
  TrainState is saved as {"model", "optim", "step"}, the first two from
  `get_state_dict` (keys by parameter name; DTensors saved shard by
  shard), and restored in place into a template TrainState: with DTensor
  parameters each rank reads only its own shards onto the template's
  layout, whatever layout wrote them (orbax's sharded restore).
- `CheckpointManager`: keeps the latest k checkpoints under a run
  directory.

In a process group every rank calls save and restore (DCP plans them
together); rank 0 alone deletes directories and writes metrics. Without
a process group DCP saves and loads in this process.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.checkpoint.state_dict import (get_state_dict,
                                                     set_state_dict)
from torch.distributed.tensor import DTensor, distribute_tensor

from ray_tpu_torch.train.spmd import TrainState

_ROOT = "__root__"  # the key a tree that is not a dict is saved under


class Checkpoint:
    """A directory-backed checkpoint with optional pytree payload."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_pytree(cls, tree: Any, path: str | None = None,
                    metrics: dict | None = None) -> "Checkpoint":
        path = path or tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        save_pytree(tree, os.path.join(path, "state"))
        if metrics is not None and _is_writer():
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        _barrier()
        return cls(path)

    @classmethod
    def from_dict(cls, data: dict, path: str | None = None) -> "Checkpoint":
        """Dict-backed checkpoint (reference: air/checkpoint.py
        Checkpoint.from_dict) — stored as a pytree directory."""
        return cls.from_pytree(dict(data), path)

    def to_dict(self) -> dict:
        return dict(self.to_pytree())

    def to_pytree(self, template: Any | None = None) -> Any:
        return restore_pytree(os.path.join(self.path, "state"), template)

    def metrics(self) -> dict:
        p = os.path.join(self.path, "metrics.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def as_directory(self) -> str:
        return self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _is_writer() -> bool:
    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def _train_state_dict(state: TrainState) -> dict:
    """The DCP state dict of a TrainState. get_state_dict gives the
    optimizer's state (made by a step at lr 0 if the optimizer has none
    yet) keyed by parameter name."""
    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    return {"model": model_sd, "optim": optim_sd, "step": state.step}


def _to_tensors(tree):
    """numpy arrays and scalars become CPU tensors; containers recurse."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def save_pytree(tree: Any, path: str) -> None:
    path = os.path.abspath(path)
    if _is_writer() and os.path.exists(path):
        shutil.rmtree(path)
    _barrier()
    if isinstance(tree, TrainState):
        state_dict = _train_state_dict(tree)
    else:
        tree = _to_tensors(tree)
        state_dict = tree if isinstance(tree, dict) else {_ROOT: tree}
    with _single_process_quiet():
        dcp.save(state_dict, checkpoint_id=path, no_dist=not _distributed())


def _load(state_dict: dict, path: str) -> None:
    with _single_process_quiet():
        dcp.load(state_dict, checkpoint_id=path, no_dist=not _distributed())


@contextlib.contextmanager
def _single_process_quiet():
    """DCP warns on every call without a process group that it assumes
    one process; that is this module's intent there."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _restore_whole(path: str) -> Any:
    """The saved tree as CPU tensors and Python objects, rebuilt from the
    checkpoint's own metadata: each entry's size and dtype, and the
    mapping of its flat key to its path in the tree (string keys are
    dicts, integers lists; a tuple comes back as a list)."""
    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {fqn: torch.empty(m.size, dtype=m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else None
            for fqn, m in meta.state_dict_metadata.items()}
    _load(flat, path)
    root: dict = {}
    for fqn, value in flat.items():
        obj_path = meta.planner_data[fqn]
        node = root
        for key in obj_path[:-1]:
            node = node.setdefault(key, {})
        node[obj_path[-1]] = value
    tree = _as_lists(root)
    return tree[_ROOT] if set(tree) == {_ROOT} else tree


def _as_lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _place(template, value, where: str = "tree"):
    """The reference's unsharded fallback: a restored whole tree placed
    as the template's leaves are (a DTensor leaf's layout, a tensor
    leaf's device, a numpy leaf as numpy). The structure and the leaves'
    shapes must match the template's."""
    if isinstance(template, dict):
        keys = {str(k): k for k in template}
        got = sorted(value) if isinstance(value, dict) else value
        if not isinstance(value, dict) or set(value) != set(keys):
            raise ValueError(f"{where}: keys {sorted(keys)} in the template, "
                             f"{got} in the checkpoint")
        return {keys[k]: _place(template[keys[k]], v, f"{where}/{k}")
                for k, v in value.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(value, list) or len(value) != len(template):
            raise ValueError(f"{where}: {len(template)} items in the "
                             f"template, not so in the checkpoint")
        return type(template)(_place(t, v, f"{where}/{i}") for i, (t, v)
                              in enumerate(zip(template, value)))
    if isinstance(template, (torch.Tensor, np.ndarray)):
        if tuple(value.shape) != tuple(template.shape):
            raise ValueError(f"{where}: shape {tuple(template.shape)} in the "
                             f"template, {tuple(value.shape)} in the "
                             "checkpoint")
        if isinstance(template, DTensor):
            return distribute_tensor(value.to(template.device),
                                     template.device_mesh,
                                     template.placements)
        if isinstance(template, torch.Tensor):
            return value.to(template.device)
        return value.numpy()
    return value


def restore_pytree(path: str, template: Any | None = None) -> Any:
    """The tree saved at `path`. Without a template: CPU tensors and
    Python scalars. A TrainState template is restored in place (each
    rank loading only its shards onto its layout) and returned; any
    other template restores whole and is then placed as its leaves are."""
    path = os.path.abspath(path)
    if isinstance(template, TrainState):
        state_dict = _train_state_dict(template)
        _load(state_dict, path)
        set_state_dict(template.model, template.optimizer,
                       model_state_dict=state_dict["model"],
                       optim_state_dict=state_dict["optim"])
        template.step = int(state_dict["step"])
        return template
    tree = _restore_whole(path)
    return tree if template is None else _place(template, tree)


class CheckpointManager:
    """Keeps the latest-k checkpoints under a run directory
    (parity: train checkpoint manager + Tune trial checkpointing)."""

    def __init__(self, root: str, num_to_keep: int | None = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self._index = 0

    def save(self, tree: Any, metrics: dict | None = None) -> Checkpoint:
        self._index += 1
        path = os.path.join(self.root, f"checkpoint_{self._index:06d}")
        ckpt = Checkpoint.from_pytree(tree, path, metrics)
        self._gc()
        return ckpt

    def latest(self) -> Checkpoint | None:
        cs = self.list()
        return cs[-1] if cs else None

    def list(self) -> list[Checkpoint]:
        names = sorted(n for n in os.listdir(self.root)
                       if n.startswith("checkpoint_"))
        return [Checkpoint(os.path.join(self.root, n)) for n in names]

    def _gc(self) -> None:
        if self.num_to_keep is None:
            return
        cs = self.list()
        while len(cs) > self.num_to_keep:
            path = cs.pop(0).path
            if _is_writer():
                shutil.rmtree(path, ignore_errors=True)
        _barrier()
