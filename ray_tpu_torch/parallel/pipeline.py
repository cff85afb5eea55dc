"""Pipeline parallelism: a GPipe microbatch pipeline over the `pp` axis.
Port of ray_tpu/parallel/pipeline.py.

The layer stack is split over the pp axis (stage i holds layers
[i L/p, (i+1) L/p)), and microbatches stream through the stages, a
permute moving each stage's activation to the next one every step. The
reference compiles the schedule into one program; here each rank runs it
eagerly on its own shard, inside `mesh_context(mesh)`.
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.util.collective.ops import (allreduce, axis_index,
                                               axis_size, permute)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   axis: str = "pp"):
    """Runs a GPipe pipeline on this rank's stage.

    stage_fn(params, x) -> y: one stage's computation (same shape in and
    out). stage_params: this rank's stage parameters. x_microbatches:
    (num_micro, mb, ...), the same on every stage; stage 0 feeds it in,
    later stages take what arrives over the ring. Total steps are
    num_micro + num_stages - 1 (fill and drain), and every stage computes
    on every step, as in the reference. Returns (num_micro, mb, ...) on
    every stage: the last stage's results, broadcast by summing them with
    the other stages' zeros.
    """
    n_stages = axis_size(axis)
    stage = axis_index(axis)
    num_micro = x_microbatches.shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    state = torch.zeros_like(x_microbatches[0])
    outputs = [None] * num_micro
    for step in range(num_micro + n_stages - 1):
        x_in = x_microbatches[min(step, num_micro - 1)] if stage == 0 \
            else state
        y = stage_fn(stage_params, x_in)
        if stage == n_stages - 1 and step >= n_stages - 1:
            outputs[step - (n_stages - 1)] = y
        state = permute(y, axis, perm)
    mine = torch.stack(outputs) if stage == n_stages - 1 \
        else torch.zeros_like(x_microbatches)
    return allreduce(mine, axis)


def split_microbatches(x, num_micro: int):
    """(B, ...) -> (num_micro, B / num_micro, ...)."""
    B = x.shape[0]
    if B % num_micro:
        raise ValueError(f"batch {B} not divisible by {num_micro} microbatches")
    return x.reshape(num_micro, B // num_micro, *x.shape[1:])


def merge_microbatches(y):
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def stage_slice_params(params: dict, n_stages: int, stage_axis: int = 0):
    """Splits each stacked-layer tensor of params into per-stage chunks
    along the layer axis: (L, ...) -> (n_stages, L / n_stages, ...)."""
    def split(leaf):
        L = leaf.shape[stage_axis]
        if L % n_stages:
            raise ValueError(f"layer count {L} not divisible by {n_stages} "
                             "stages")
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])

    return {name: split(leaf) for name, leaf in params.items()}
