"""Sharding rules: map the Llama's parameters to partition specs and
DTensor placements. Port of ray_tpu/parallel/sharding.py.

In the reference, regex rules over pytree paths give `PartitionSpec`s and
GSPMD inserts the collectives they imply. Here the same rules give DTensor
placements, and DTensor's sharding propagation inserts the collectives:
sharding params and optimizer state over fsdp is sharded data parallelism,
with no wrapper engine.

The rules match flax paths (`layers_0/attn/q_proj/kernel`), so a port
name (`layers.0.attn.q_proj.weight`) is mapped back to its flax path
before matching, the inverse of models/convert.py's naming, and the spec
of a Linear weight is transposed: a flax kernel is (in, out), a torch
weight (out, in). The embedding table is (vocab, d_model) in both.
"""

from __future__ import annotations

import math
import re

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, submesh


class P(tuple):
    """Stands in for jax's PartitionSpec: one entry per tensor dim, each
    None (not sharded), a mesh axis name, or a tuple of axis names (the
    dim sharded over their product, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):      # pickle: P(*entries), not P(entries)
        return tuple(self)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def flax_path(name: str) -> tuple[str, bool]:
    """(the flax path of the port's parameter `name`, whether its tensor is
    the transpose of the flax leaf): `layers.0.attn.q_proj.weight` is
    `layers_0/attn/q_proj/kernel`, transposed; `embed.weight` is
    `embed/embedding`; a norm's `scale` keeps its name."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts[:2] = [f"layers_{parts[1]}"]
    if name == "embed.weight":
        return "embed/embedding", False
    if parts[-1] == "weight":
        parts[-1] = "kernel"
        return "/".join(parts), True
    return "/".join(parts), False


class ShardingRules:
    """Ordered (regex, P) rules over flax paths; first match wins."""

    def __init__(self, rules: list[tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, name: str, leaf=None) -> P:
        """The spec of the port's parameter `name` (clipped to the leaf's
        rank, as the reference clips, then transposed for a Linear
        weight)."""
        path, transposed = flax_path(name)
        spec = next((s for pat, s in self.rules if pat.search(path)),
                    self.default)
        spec = _clip_spec(spec, leaf)
        if transposed and leaf is not None and leaf.dim() == 2:
            spec = P(*reversed(tuple(spec) + (None,) * (2 - len(spec))))
        return spec

    def tree_specs(self, tree: dict) -> dict[str, P]:
        return {name: self.spec_for(name, leaf) for name, leaf in tree.items()}

    def tree_shardings(self, mesh: DeviceMesh, tree: dict):
        """{name: DTensor placements on `mesh`} for each tensor of tree."""
        return {name: spec_placements(spec, mesh)
                for name, spec in self.tree_specs(tree).items()}


def _clip_spec(spec: P, leaf) -> P:
    """Drop trailing spec entries that exceed the leaf's rank."""
    if leaf is None or not hasattr(leaf, "dim") or len(spec) <= leaf.dim():
        return spec
    return P(*tuple(spec)[: leaf.dim()])


# The reference's rule set for transformer decoders, the same regexes and
# specs over flax paths (its comment gives the reasons: TP shards the
# heads and the MLP hidden, FSDP the other dim of each matrix; the
# embedding table shards vocab over fsdp and d_model over tp).
TRANSFORMER_RULES = ShardingRules([
    (r"embed/embedding", P("fsdp", "tp")),
    (r"(q_proj|k_proj|v_proj)/kernel", P("fsdp", "tp")),
    (r"o_proj/kernel", P("tp", "fsdp")),
    (r"(gate_proj|up_proj)/kernel", P("fsdp", "tp")),
    (r"down_proj/kernel", P("tp", "fsdp")),
    (r"lm_head/kernel", P("fsdp", "tp")),
    (r"(norm|ln|scale|bias)", P()),
], default=P())


def batch_spec(extra_dims: int = 1) -> P:
    """Global-batch sharding: batch over (dp, fsdp), sequence over sp."""
    return P(("dp", "fsdp"), "sp", *([None] * (extra_dims - 1)))


def spec_axes(spec: P) -> list[str]:
    """The mesh axes a spec names, in the order it names them."""
    return [a for entry in spec if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)]


def spec_placements(spec: P, mesh: DeviceMesh) -> tuple[Placement, ...]:
    """DTensor placements on `mesh` for a spec: Shard(d) on each mesh dim
    that entry d names, Replicate on the others. An entry that is a tuple
    of axes is sharded over them major to minor, which DTensor does in
    mesh-dim order, so the tuple must follow AXIS_ORDER. An axis the mesh
    lacks is one that `submesh` dropped for having size 1."""
    dims = {}
    for d, entry in enumerate(spec):
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        if list(names) != sorted(names, key=AXIS_ORDER.index):
            raise ValueError(f"{spec}: axes {names} are not in AXIS_ORDER "
                             "order")
        for a in names:
            if a in dims:
                raise ValueError(f"{spec} names axis {a!r} twice")
            dims[a] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.mesh_dim_names)


def distribute(t, mesh: DeviceMesh, placements) -> DTensor:
    """t, a full tensor that is the same on every rank, as a DTensor with
    these placements: each rank copies out its own shard, so no data
    moves, and the DTensor neither aliases t nor keeps it alive."""
    dt = distribute_tensor(t, mesh, placements, src_data_rank=None)
    return DTensor.from_local(dt.to_local().clone(), mesh, placements,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def layout_mesh(mesh: DeviceMesh, specs) -> DeviceMesh:
    """The sub-mesh the DTensors of a sharded state live on: the axes that
    `specs` or batch_spec() name (see `submesh`). The batch's axes are
    always in it, so activations and params share one mesh."""
    axes = set(spec_axes(batch_spec()))
    for spec in specs:
        axes.update(spec_axes(spec))
    return submesh(mesh, axes)


def shard_tree(mesh: DeviceMesh, tree: dict, rules: ShardingRules) -> dict:
    """{name: DTensor}: each full tensor of tree (the same on every rank)
    laid out by the rules on the layout mesh of `mesh` (see
    `distribute`)."""
    specs = rules.tree_specs(tree)
    lmesh = layout_mesh(mesh, specs.values())
    return {name: distribute(t, lmesh, spec_placements(specs[name], lmesh))
            for name, t in tree.items()}


def with_rules_constraint(tree: dict, rules: ShardingRules) -> dict:
    """Each DTensor of tree redistributed, on its own mesh, to the layout
    its rule gives (the counterpart of with_sharding_constraint)."""
    out = {}
    for name, t in tree.items():
        want = spec_placements(rules.spec_for(name, t), t.device_mesh)
        out[name] = t if tuple(t.placements) == want \
            else t.redistribute(t.device_mesh, want)
    return out


def num_params(tree) -> int:
    """Elements of every tensor in a dict of tensors or a module (global
    sizes for DTensors)."""
    tensors = tree.parameters() if isinstance(tree, torch.nn.Module) \
        else tree.values()
    return sum(math.prod(t.shape) for t in tensors)
