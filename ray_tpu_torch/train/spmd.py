"""Training-step construction on one device. Port of the single-device
part of ray_tpu/train/spmd.py.

JAX builds one compiled, sharded program from a pure step over
(params, opt_state, step). Here the step runs eagerly on one card:
`TrainState` holds the model (the params), the torch optimizer (which
holds the opt state and applies the update) and the step count, and the
step updates them in place.

The mesh-sharded parts, `init_sharded_state`, `shard_train_step`,
`state_specs_from_rules` and `reshard_to_mesh`, with parallel/mesh.py and
parallel/sharding.py, belong to the port's multi-GPU slice (ROADMAP
queue A, item 4, second bullet).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import init_params
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel


@dataclasses.dataclass
class TrainState:
    model: LlamaModel                   # the params
    optimizer: torch.optim.Optimizer   # the opt state and the update
    step: int = 0


def adamw(learning_rate: float, weight_decay: float = 1e-4):
    """optax.adamw with its defaults (b1 0.9, b2 0.999, eps 1e-8, every
    parameter decayed) as a factory: optimizer(params) -> torch AdamW.
    torch keeps each moment in its parameter's dtype, as optax does."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(cfg: LlamaConfig, optimizer: Callable,
                     params: dict | None = None, *, seed: int = 0,
                     device=None) -> TrainState:
    """A TrainState on `device` (None means CUDA): the model from `params`
    (a state_dict from init_params or params_from_flax; drawn with
    init_params(cfg, seed) when None) and optimizer(model.parameters()).
    The model takes over tensors already on `device`: give each state
    its own dict."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    model = LlamaModel.from_params(cfg, params, device, trainable=True)
    return TrainState(model, optimizer(model.parameters()))


def make_train_step(loss_fn: Callable) -> Callable:
    """loss_fn(model, batch) -> scalar loss. Returns step(state, batch) ->
    (state, {"loss": the loss tensor, "step": int}), which updates the
    state in place. The step never reads a device value on the host.

    JAX's make_train_step also takes the optax transformation: here the
    state's torch optimizer is that transformation and its state."""

    def train_step(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "step": state.step}

    return train_step
