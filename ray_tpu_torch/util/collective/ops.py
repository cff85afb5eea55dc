"""Collectives over a named mesh axis, for code that runs on each rank's
own shard. Port of ray_tpu/util/collective/ops.py.

In the reference these are `jax.lax` collectives inside `shard_map`,
whose mesh names the axes. Here `mesh_context(mesh)` makes a DeviceMesh
current, and each function runs over the process group of its `axis` on
that mesh, so the signatures stay the reference's::

    from ray_tpu_torch.util.collective import ops as col

    with col.mesh_context(mesh):
        y = col.allreduce(x, axis="dp")

`permute` (and so `shift_right` and `shift_left`), `alltoall` and
`allreduce` with op "sum" or "mean" carry gradients, as JAX transposes
them under `jax.grad`: a permute's gradient goes back the reverse way, an
all-to-all's through the inverse exchange, a sum's is the sum of the
gradients. The others are forward only and refuse an input that
requires grad. Sends and receives go out in one `batch_isend_irecv` on
every rank, so a ring step cannot deadlock.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Makes `mesh` the one whose axes the collectives name, as shard_map's
    mesh does in the reference."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


def _mesh(axis: str) -> DeviceMesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError(f"collective over axis {axis!r} outside "
                           "mesh_context(mesh)")
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"{axis!r} is not an axis of {mesh}")
    return mesh


def _group(axis: str):
    return _mesh(axis).get_group(axis)


def axis_index(axis: str) -> int:
    return _mesh(axis).get_local_rank(axis)


def axis_size(axis: str) -> int:
    return _group(axis).size()


def _forward_only(x, what: str):
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what} carries no gradient: detach its input")


_REDUCE_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _AllReduceSum.apply(dy, ctx.groups), None


def allreduce(x, axis: str | tuple[str, ...], op: str = "sum"):
    """Reduces x over one axis or over several (their product); op is
    "sum", "mean", "max", "min" or "product"."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    groups = [_group(a) for a in axes]
    if op == "sum":
        return _AllReduceSum.apply(x, groups)
    if op == "mean":
        return _AllReduceSum.apply(x, groups) / math.prod(
            g.size() for g in groups)
    if op == "product":
        return torch.exp(allreduce(torch.log(x), axes))
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    _forward_only(x, f"allreduce {op}")
    y = x.clone()
    for group in groups:
        dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    return y


def allgather(x, axis: str, *, tiled: bool = False, gather_axis: int = 0):
    """Every rank's x along the axis, stacked in a new dim `gather_axis`,
    or concatenated along it with `tiled`."""
    _forward_only(x, "allgather")
    group = _group(axis)
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, gather_axis) if tiled \
        else torch.stack(parts, gather_axis)


def reducescatter(x, axis: str, *, scatter_axis: int = 0, op: str = "sum"):
    """The sum over the axis of x, of which rank i keeps the i-th of n
    equal chunks along scatter_axis."""
    if op != "sum":
        raise ValueError("reduce-scatter supports sum")
    _forward_only(x, "reducescatter")
    group = _group(axis)
    n = group.size()
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"split into {n}")
    chunks = [c.contiguous() for c in x.chunk(n, scatter_axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def broadcast(x, axis: str, src_index: int = 0):
    """Rank src_index's x (its index along the axis) on every rank."""
    _forward_only(x, "broadcast")
    group = _group(axis)
    y = x.clone()
    dist.broadcast(y, src=dist.get_global_rank(group, src_index),
                   group=group)
    return y


def _all_to_all(x, group, split_axis: int, concat_axis: int):
    n = group.size()
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split into {n}")
    send = torch.stack(x.chunk(n, split_axis))     # chunk j goes to rank j
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_axis)  # in source-rank order


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, dy):
        group, split_axis, concat_axis = ctx.args
        return (_AllToAll.apply(dy, group, concat_axis, split_axis),
                None, None, None)


def alltoall(x, axis: str, *, split_axis: int, concat_axis: int):
    """Tiled all-to-all over the axis: x split into n chunks along
    split_axis, chunk j sent to rank j, the chunks received concatenated
    along concat_axis in rank order (Ulysses' sequence exchange)."""
    return _AllToAll.apply(x, _group(axis), split_axis, concat_axis)


def _permute(x, group, perm):
    me = group.rank()
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    ops = []
    for dst in send_to:
        if dst == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, dst), group))
    for src in recv_from:
        if src != me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.args = (group, perm)
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, dy):
        group, perm = ctx.args
        return _Permute.apply(dy, group, [(d, s) for s, d in perm]), \
            None, None


def permute(x, axis: str, perm: list[tuple[int, int]]):
    """Point-to-point shifts over the axis: for each (src, dst) in perm,
    rank dst receives rank src's x; a rank that receives nothing gets
    zeros, as lax.ppermute gives."""
    perm = [(int(s), int(d)) for s, d in perm]
    for side in (0, 1):
        ends = [p[side] for p in perm]
        if len(set(ends)) != len(ends):
            raise ValueError(f"perm {perm} is not a permutation")
    return _Permute.apply(x, _group(axis), perm)


def shift_right(x, axis: str):
    n = axis_size(axis)
    return permute(x, axis, [(i, (i + 1) % n) for i in range(n)])


def shift_left(x, axis: str):
    n = axis_size(axis)
    return permute(x, axis, [(i, (i - 1) % n) for i in range(n)])
