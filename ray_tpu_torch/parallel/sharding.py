"""Sharding rules: map the port's parameters to partition specs and
DTensor placements. Port of ray_tpu/parallel/sharding.py.

In the reference, regex rules over pytree paths give `PartitionSpec`s and
GSPMD inserts the collectives they imply. Here the same rules give DTensor
placements, and DTensor's sharding propagation inserts the collectives:
sharding params and optimizer state over fsdp is sharded data parallelism,
with no wrapper engine.

The rules match flax paths (`layers_0/attn/q_proj/kernel`), so a port
name (`layers.0.attn.q_proj.weight`) is mapped back to its flax path
before matching (`flax_path`, which models/convert.py's naming follows),
and the spec of a kernel is permuted as its tensor: a flax Dense kernel
is (in, out), a torch Linear weight (out, in); a flax Conv kernel is
(kh, kw, in, out), a torch Conv2d weight (out, in, kh, kw). An embedding
table is (vocab, d_model) in both.
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


# The port's nn.Embedding modules, whose `weight` is flax's `embedding`.
EMBEDDINGS = ("embed", "tok_embed", "label_embed")
# How the port lays out a flax kernel of each rank: a Linear weight is the
# (in, out) kernel transposed, a Conv2d weight (out, in, kh, kw) the
# (kh, kw, in, out) kernel permuted; dim i of the port's tensor is dim
# perm[i] of the flax leaf.
KERNEL_PERMS = {2: (1, 0), 4: (3, 2, 0, 1)}


def flax_path(name: str, ndim: int = 2) -> tuple[str, tuple | None]:
    """(the flax path of the port's parameter `name` of rank `ndim`, the
    permutation from the flax leaf's dims to the tensor's, or None):
    `layers.0.attn.q_proj.weight` is `layers_0/attn/q_proj/kernel`,
    transposed; a module list's index joins its name as flax's does
    (`blocks.3` is `blocks_3`, `norm.0` is `norm_0`); `tok_embed.weight`
    is `tok_embed/embedding`; a bias, a norm's `scale` and a raw
    parameter keep their names and layout."""
    parts = []
    for part in name.split("."):
        if part.isdigit():
            parts[-1] += f"_{part}"
        else:
            parts.append(part)
    if parts[-1] == "weight" and len(parts) > 1 and parts[-2] in EMBEDDINGS:
        return "/".join(parts[:-1] + ["embedding"]), None
    if parts[-1] == "weight":
        parts[-1] = "kernel"
        return "/".join(parts), KERNEL_PERMS[ndim]
    return "/".join(parts), None


class ShardingRules:
    """Ordered (regex, P) rules over flax paths; first match wins."""

    def __init__(self, rules: list[tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, name: str, leaf=None) -> P:
        """The spec of the port's parameter `name` (clipped to the leaf's
        rank, as the reference clips, then permuted as the port lays the
        flax kernel out: transposed for a Linear weight)."""
        ndim = 2 if leaf is None else leaf.dim()
        path, perm = flax_path(name, ndim)
        spec = next((s for pat, s in self.rules if pat.search(path)),
                    self.default)
        spec = _clip_spec(spec, leaf)
        if perm is not None and leaf is not None:
            full = tuple(spec) + (None,) * (ndim - len(spec))
            spec = P(*(full[d] for d in perm))
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
