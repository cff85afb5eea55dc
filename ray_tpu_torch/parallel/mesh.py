"""Device meshes for SPMD parallelism. Port of ray_tpu/parallel/mesh.py.

The mesh's named axes carry the parallelism taxonomy, as in the
reference:

  dp    data parallel (replicated params, sharded batch)
  fsdp  fully-sharded data parallel (params and optimizer state sharded)
  tp    tensor parallel (intra-layer sharding of heads and MLP hidden)
  pp    pipeline parallel (stage axis, permute microbatch schedule)
  sp    sequence parallel (ring attention, Ulysses)
  ep    expert parallel

One JAX process drives every chip of its host; torch runs one process per
device. So the mesh is a `DeviceMesh` over the default process group
(NCCL on CUDA, gloo on the CPU), one rank per device, and the axis sizes
multiply to the world size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._device import resolve_device

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")


@dataclass
class MeshConfig:
    """Logical mesh shape. -1 for at most one axis: absorb remaining devices."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolved(self, num_devices: int) -> dict[str, int]:
        sizes = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                 "sp": self.sp, "ep": self.ep, "tp": self.tp}
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {known}")
            sizes[unknown[0]] = num_devices // known
        total = math.prod(sizes.values())
        if total != num_devices:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {num_devices}")
        return sizes


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        resolve_device("cuda")          # raises without a card
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh backend for device type {device_type!r}")


def make_mesh(config: MeshConfig | dict | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh with the axis names of AXIS_ORDER over the default
    process group, which must already be initialized (see
    `initialize_multihost`). None means dp over the whole world, as the
    reference's make_mesh does over all devices. CUDA unless the caller
    asks for "cpu"; raises without a card."""
    _backend(device_type)
    if isinstance(config, dict):
        config = MeshConfig(**config)
    world = dist.get_world_size()
    if config is None:
        config = MeshConfig(dp=world)
    sizes = config.resolved(world)
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def data_axes() -> tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return ("dp", "fsdp")


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh: DeviceMesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def submesh(mesh: DeviceMesh, axes) -> DeviceMesh:
    """The sub-mesh of `axes` that have size above 1, in AXIS_ORDER order;
    the first of `axes` in that order is kept when all have size 1.

    DTensors are laid out on such a sub-mesh, not on the six-axis mesh:
    DTensor's sharding propagation enumerates strategies over every mesh
    dimension, and over six of them the first forward of even a tiny
    model spends minutes there. An axis that a sub-mesh leaves out has
    size 1, so nothing is sharded over it."""
    sizes = axis_sizes(mesh)
    named = [a for a in AXIS_ORDER if a in set(axes) and a in sizes]
    if not named:
        raise ValueError(f"none of {tuple(axes)} is an axis of {mesh}")
    keep = [a for a in named if sizes[a] > 1] or named[:1]
    if tuple(keep) == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[tuple(keep)]


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device_type: str = "cuda") -> None:
    """Rendezvous of the processes: `torch.distributed.init_process_group`
    over NCCL on CUDA (raises without a card) or gloo on the CPU, at
    tcp://coordinator_address, or from the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) where no address is given. The
    reference's counterpart is `jax.distributed.initialize`."""
    backend = _backend(device_type)
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator_address}" if coordinator_address
                     else "env://"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
