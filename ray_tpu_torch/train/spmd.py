"""Training-step construction. Port of ray_tpu/train/spmd.py.

JAX builds one compiled, sharded program from a pure step over
(params, opt_state, step). Here the step runs eagerly: `TrainState` holds
the model (the params), the torch optimizer (which holds the opt state
and applies the update) and the step count, and the step updates them in
place.

The sharded half lays the state out over a mesh with DTensor placements
made from sharding rules (`init_sharded_state`, `state_specs_from_rules`),
and `shard_train_step` runs a step on it: DTensor's sharding propagation
inserts the collectives the layouts imply, as GSPMD does in the
reference, and the step pins what jit's in and out shardings pin there.
The DTensors live on the mesh's layout sub-mesh
(`parallel.sharding.layout_mesh`).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import init_params, model_class
from ray_tpu_torch.models.layers import ParamModel
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import (P, ShardingRules, distribute,
                                             layout_mesh, spec_axes,
                                             spec_placements)
from ray_tpu_torch.util.collective.ops import mesh_context


@dataclasses.dataclass
class TrainState:
    model: ParamModel                  # the params
    optimizer: torch.optim.Optimizer   # the opt state and the update
    step: int = 0


def adamw(learning_rate: float, weight_decay: float = 1e-4):
    """optax.adamw with its defaults (b1 0.9, b2 0.999, eps 1e-8, every
    parameter decayed) as a factory: optimizer(params) -> torch AdamW.
    torch keeps each moment in its parameter's dtype, as optax does."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_train_state(cfg, optimizer: Callable,
                     params: dict | None = None, *, seed: int = 0,
                     device=None) -> TrainState:
    """A TrainState on `device` (None means CUDA): the model of cfg's type
    (`models.convert.model_class`) from `params`
    (a state_dict from init_params or params_from_flax; drawn with
    init_params(cfg, seed) when None) and optimizer(model.parameters()).
    The model takes over tensors already on `device`: give each state
    its own dict."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    model = model_class(cfg).from_params(cfg, params, device,
                                         trainable=True)
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


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _lay_out(model: ParamModel, tensors: dict, lmesh: DeviceMesh,
             placements: dict) -> None:
    """Puts each full tensor (the same on every rank) into the model as a
    DTensor parameter with its placements on lmesh (each rank keeps its
    shard), and its buffers (the decoders' RoPE tables) as replicated
    DTensors."""
    model.load_state_dict(
        {name: distribute(t, lmesh, placements[name])
         for name, t in tensors.items()}, strict=True, assign=True)
    for name, buf in list(model.named_buffers()):
        full = buf.full_tensor() if isinstance(buf, DTensor) else buf
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr,
                distribute(full, lmesh, [Replicate()] * lmesh.ndim))


def state_specs_from_rules(state: TrainState, rules: ShardingRules) -> dict:
    """Specs for a TrainState: {"params": {name: P}, "opt_state": {name: P},
    "step": P()}. Params by the rules; the optimizer state of each
    parameter (AdamW's two moments) takes its parameter's spec and its
    scalar step count is replicated. The reference keys the moments' specs
    by shape, so parameters of one shape and different specs give their
    moments one spec there (a layout, not a value, difference); torch
    makes each moment from its own parameter, so each takes that spec."""
    specs = rules.tree_specs(dict(state.model.named_parameters()))
    return {"params": specs, "opt_state": dict(specs), "step": P()}


def init_sharded_state(mesh: DeviceMesh, cfg, init,
                       rules: ShardingRules, optimizer: Callable,
                       *init_args) -> tuple[TrainState, dict]:
    """A TrainState laid out on the mesh by the rules, and its specs.

    init: a function, init(*init_args) -> the full params (a state_dict,
    as init_params gives it), or such a dict itself (as params_from_flax
    gives it); the same on every rank. The model is built on the meta
    device, then each parameter becomes a DTensor with its rule's
    placements on the mesh's device, each rank keeping its shard; the
    optimizer is optimizer(model.parameters()), so its moments are laid
    out as their parameters."""
    params = init(*init_args) if callable(init) else init
    model = model_class(cfg)(cfg, device="meta")
    meta = dict(model.named_parameters())
    if set(params) != set(meta):
        raise ValueError(f"params do not match the model: "
                         f"{sorted(set(params) ^ set(meta))}")
    specs = rules.tree_specs(meta)
    lmesh = layout_mesh(mesh, specs.values())
    device = _mesh_device(mesh)
    model._set_buffers(device)
    _lay_out(model, {n: t.to(device=device, dtype=meta[n].dtype)
                     for n, t in params.items()}, lmesh,
             {n: spec_placements(spec, lmesh) for n, spec in specs.items()})
    model.requires_grad_(True).train(True)
    state = TrainState(model, optimizer(model.parameters()))
    return state, state_specs_from_rules(state, rules)


def _pin_grads(optimizer, args, kwargs):
    """Before the update: each gradient redistributed to its parameter's
    placements (a reduce-scatter over fsdp, an all-reduce over dp), as
    out_shardings pins the layout in JAX; autograd leaves them partial."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            g = p.grad
            if isinstance(g, DTensor) and tuple(g.placements) != \
                    tuple(p.placements):
                p.grad = g.redistribute(p.device_mesh, p.placements)


def _map_spec(fn, tree, spec):
    """fn(tensor, spec) over a batch tree (tuple, list or dict of tensors)
    and its spec tree of the same structure."""
    if isinstance(spec, P):
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in tree}
    return type(tree)(_map_spec(fn, t, s) for t, s in zip(tree, spec,
                                                         strict=True))


def shard_train_step(train_step: Callable, mesh: DeviceMesh, state_specs,
                     batch_spec) -> Callable:
    """The step of make_train_step run on a sharded state.

    Each call checks the state's params against state_specs (jit's
    in_shardings), lays the batch out by batch_spec on the params' mesh (a
    plain tensor is the global batch, the same on every rank, and each
    rank keeps its shard; a DTensor is redistributed; a dim that does not
    split evenly raises ValueError), runs the step inside
    mesh_context(mesh), with each gradient pinned to its parameter's
    placements before the update, and returns the loss replicated on
    every rank as a plain tensor (out_shardings P()). It reads no device
    value on the host."""
    sizes = axis_sizes(mesh)
    pinned = weakref.WeakSet()

    def place(t, spec, lmesh):
        for a in spec_axes(spec):
            if a not in lmesh.mesh_dim_names and sizes.get(a, 1) != 1:
                raise ValueError(f"batch spec {spec} names {a!r}, which the "
                                 f"state's mesh {lmesh} does not shard")
        placements = spec_placements(spec, lmesh)
        ways = {}
        for a, pl in zip(lmesh.mesh_dim_names, placements):
            if isinstance(pl, Shard):
                ways[pl.dim] = ways.get(pl.dim, 1) * sizes[a]
        for d, n in ways.items():
            if t.shape[d] % n:    # jit refuses it too; local_map would
                raise ValueError(  # infer wrong global shapes
                    f"dim {d} of the batch's {tuple(t.shape)} does not "
                    f"split into {n} equal shards")
        if isinstance(t, DTensor):
            return t.redistribute(lmesh, placements)
        return distribute(t, lmesh, placements)

    def step(state: TrainState, batch):
        lmesh = None
        for name, p in state.model.named_parameters():
            lmesh = p.device_mesh
            want = spec_placements(state_specs["params"][name], lmesh)
            if tuple(p.placements) != want:
                raise ValueError(f"{name} is laid out {p.placements}, its "
                                 f"spec gives {want}")
        if state.optimizer not in pinned:
            state.optimizer.register_step_pre_hook(_pin_grads)
            pinned.add(state.optimizer)
        batch = _map_spec(functools.partial(place, lmesh=lmesh), batch,
                          batch_spec)
        with mesh_context(mesh):
            state, metrics = train_step(state, batch)
        return state, {**metrics, "loss": metrics["loss"].full_tensor()}

    return step


def reshard_to_mesh(state: TrainState, specs: dict,
                    mesh: DeviceMesh) -> TrainState:
    """Lays the state out again, by the same specs, on another mesh shape
    over the same processes: each parameter and each of its optimizer
    moments is gathered and each rank keeps its new shard (the reference
    moves only the shards that change owner). The parameters are new
    objects, in the model and in the optimizer. A sharded state onto a
    world of another size (a new process group, shards moved between
    ranks) is not supported: the elastic gang re-homes replicated
    data-parallel state (train/trainer.py)."""
    if mesh.size() != dist.get_world_size():
        raise NotImplementedError(
            f"a mesh of {mesh.size()} ranks over a world of "
            f"{dist.get_world_size()}: a sharded state onto a world of "
            "another size is not supported (ROADMAP A5's remainder)")
    model, opt = state.model, state.optimizer
    lmesh = layout_mesh(mesh, specs["params"].values())
    old = dict(model.named_parameters())
    placements = {n: spec_placements(specs["params"][n], lmesh) for n in old}
    _lay_out(model, {n: p.detach().full_tensor() for n, p in old.items()},
             lmesh, placements)
    new = dict(model.named_parameters())
    moved = {old[n]: new[n] for n in old}
    for group in opt.param_groups:
        group["params"] = [moved[p] for p in group["params"]]
    by_param = {p: n for n, p in old.items()}
    for p in list(opt.state):
        name = by_param[p]
        want = spec_placements(specs["opt_state"][name], lmesh)
        opt.state[moved[p]] = {
            k: distribute(v.full_tensor(), lmesh, want)
            if isinstance(v, DTensor) else v
            for k, v in opt.state.pop(p).items()}
    return state
