"""Collective groups between processes of the runtime. Port of
ray_tpu/util/collective/collective.py.

The reference's group API runs collectives on host numpy arrays through
a rendezvous actor and a peer ring of its own. Here a group is a
`torch.distributed` process group, and the library moves the tensors:

- `backend="nccl"` for CUDA tensors (the reference's "xla": the cards
  talk to each other, NVLink within a node), `"gloo"` for CPU tensors
  (the reference's "cpu" and "gloo"). The default is "nccl" where the
  process sees a card; "nccl" without a card raises, it does not fall
  back to gloo.
- Rendezvous keeps the reference's pattern (`ray_tpu/train/torch.py`):
  the rank-0 member binds a `TCPStore` on its host and publishes host
  and port through the GCS KV; the others read them there.
- Each named group is its own process group over its own store
  (a `PrefixStore` named after the group), built directly from the
  backend's class rather than through `init_process_group`: so several
  groups live side by side in one process, the training gang's beside
  the device plane's. A gang's group may also be installed as
  torch.distributed's default group (`as_default_group=True`), which
  DDP, DeviceMesh and DCP checkpoints use.

Ops take and return torch tensors (a numpy array is taken as a CPU
tensor over its memory, and returned as numpy). Their results follow
the reference's (`collective.py:362-447`): `allreduce` and `broadcast`
write into the tensor and return it; `allgather` returns a list of the
W members' tensors; `reducescatter` returns this rank's piece of the
reduced tensor, `np.array_split(reduced, W)[rank]` along dim 0, so a
leading dim that W does not divide is legal; `recv` fills its tensor.
"""

from __future__ import annotations

import datetime
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "product": dist.ReduceOp.PRODUCT,
               "prod": dist.ReduceOp.PRODUCT, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
# The reference's backend names, and what each is here.
_BACKENDS = {"nccl": "nccl", "xla": "nccl", "gloo": "gloo", "cpu": "gloo"}
_KV_NS = "collective"
RENDEZVOUS_TIMEOUT_S = 120.0
_NO_CARD = ("backend 'nccl' needs a CUDA card, and this process sees none; "
            "use backend='gloo' for CPU tensors")


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _free_port_store(host: str, world_size: int, timeout: float):
    """A TCPStore server on a port the OS picks, on this host."""
    return dist.TCPStore(host, 0, world_size, True,
                         timeout=datetime.timedelta(seconds=timeout),
                         wait_for_workers=False)


def _kv(cw, method: str, **payload):
    return cw._run(cw.gcs.call(method, {"ns": _KV_NS, **payload}))


def rendezvous_store(key: str, rank: int, world_size: int,
                     timeout: float = RENDEZVOUS_TIMEOUT_S):
    """The store every member of `key` shares: rank 0 serves it and
    publishes its address in the GCS KV, the others connect to it."""
    from ray_tpu_torch._private.api_internal import get_core_worker

    cw = get_core_worker()
    if cw is None:
        raise RuntimeError("collective groups need a runtime: call "
                           "ray_tpu_torch.init() first")
    if rank == 0:
        store = _free_port_store(cw.address.host, world_size, timeout)
        _kv(cw, "KVPut", key=key, value=f"{cw.address.host}:{store.port}")
        return store
    deadline = time.monotonic() + timeout
    while True:
        val = _kv(cw, "KVGet", key=key).get("value")
        if val:
            host, port = val.rsplit(":", 1)
            try:
                # A stale address (a destroyed group of the same name)
                # refuses the connection; read the KV again.
                return dist.TCPStore(
                    host, int(port), world_size, False,
                    timeout=datetime.timedelta(
                        seconds=max(1.0, min(10.0, deadline
                                             - time.monotonic()))))
            except (RuntimeError, OSError):
                pass
        if time.monotonic() > deadline:
            raise TimeoutError(f"collective group {key!r}: rank 0 never "
                               f"published its address within {timeout}s")
        time.sleep(0.05)


def new_process_group(backend: str, store, rank: int, world_size: int):
    """A process group of `backend` over `store`, apart from the
    default group."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CARD)
        return dist.ProcessGroupNCCL(store, rank, world_size)
    return dist.ProcessGroupGloo(store, rank, world_size)


class _Group:
    def __init__(self, name: str, world_size: int, rank: int, backend: str,
                 pg, store, is_default: bool):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.pg = pg
        self.store = store          # rank 0's server lives as long as this
        self.is_default = is_default


class GroupManager:
    """Per-process registry of joined groups (reference: GroupManager)."""

    def __init__(self):
        self.groups: dict[str, _Group] = {}
        self._lock = threading.Lock()

    def create(self, group_name: str, world_size: int, rank: int,
               backend: str, as_default_group: bool) -> _Group:
        with self._lock:
            if group_name in self.groups:
                raise ValueError(f"collective group {group_name!r} is "
                                 "already initialized in this process")
        store = rendezvous_store(f"group:{group_name}", rank, world_size)
        prefixed = dist.PrefixStore(f"collective/{group_name}", store)
        if as_default_group:
            dist.init_process_group(backend, store=prefixed, rank=rank,
                                    world_size=world_size)
            pg = dist.group.WORLD
        else:
            pg = new_process_group(backend, prefixed, rank, world_size)
        g = _Group(group_name, world_size, rank, backend, pg, store,
                   as_default_group)
        with self._lock:
            self.groups[group_name] = g
        return g

    def get(self, group_name: str) -> _Group:
        g = self.groups.get(group_name)
        if g is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                "process; call init_collective_group first")
        return g

    def destroy(self, group_name: str):
        with self._lock:
            g = self.groups.pop(group_name, None)
        if g is None:
            return
        if g.is_default:
            if dist.is_initialized():
                dist.destroy_process_group()
        elif g.backend == "nccl":
            g.pg.shutdown()
        if g.rank == 0:
            from ray_tpu_torch._private.api_internal import get_core_worker

            cw = get_core_worker()
            if cw is not None:
                try:
                    _kv(cw, "KVDel", key=f"group:{group_name}")
                except Exception:
                    pass


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          backend: str | None = None,
                          group_name: str = "default", *,
                          as_default_group: bool = False) -> None:
    """Join `group_name` as `rank` of `world_size`; every member calls
    it. backend None means "nccl" where this process sees a card, else
    "gloo"; the reference's "xla" and "cpu" are taken as "nccl" and
    "gloo"."""
    name = backend or default_backend()
    if name not in _BACKENDS:
        raise ValueError(f"backend must be 'nccl' or 'gloo' (or the "
                         f"reference's 'xla' or 'cpu'), got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    if _BACKENDS[name] == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    _manager.create(group_name, world_size, rank, _BACKENDS[name],
                    as_default_group)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _manager.groups


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x, False
    return torch.from_numpy(np.ascontiguousarray(x)), True


def _out(t: torch.Tensor, was_numpy: bool):
    return t.numpy() if was_numpy else t


def _reduce_op(op: str):
    try:
        return _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, "
                         f"got {op!r}") from None


def _inplace(tensor: torch.Tensor, run):
    """Runs `run(t)` on a contiguous tensor and writes the result back
    into `tensor` when it was not contiguous."""
    t = tensor if tensor.is_contiguous() else tensor.contiguous()
    run(t)
    if t is not tensor:
        tensor.copy_(t)
    return tensor


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """Reduces `tensor` over the group in place and returns it."""
    g = _manager.get(group_name)
    t, was_np = _as_tensor(tensor)
    opts = dist.AllreduceOptions()
    opts.reduceOp = _reduce_op(op)
    _inplace(t, lambda c: g.pg.allreduce([c], opts).wait())
    return _out(t, was_np)


def allgather(tensor, group_name: str = "default") -> list:
    """Every member's tensor, in rank order."""
    g = _manager.get(group_name)
    t, was_np = _as_tensor(tensor)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(g.world_size)]
    g.pg.allgather([outs], [t]).wait()
    return [_out(o, was_np) for o in outs]


def _split_sizes(n: int, w: int) -> list[int]:
    """np.array_split's piece sizes: the first n % w pieces one longer."""
    q, r = divmod(n, w)
    return [q + 1 if i < r else q for i in range(w)]


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """This rank's piece of the reduced tensor: np.array_split(reduced,
    W)[rank] along dim 0. The collective needs equal pieces, so each
    array_split piece is padded to the longest one's length, and this
    rank's result cut back to its own."""
    g = _manager.get(group_name)
    t, was_np = _as_tensor(tensor)
    w = g.world_size
    sizes = _split_sizes(t.shape[0], w)
    width = sizes[0]
    pieces = []
    for piece in torch.split(t, sizes, dim=0):
        if piece.shape[0] < width:
            pad = piece.new_zeros((width - piece.shape[0],) + piece.shape[1:])
            piece = torch.cat([piece, pad])
        pieces.append(piece)
    padded = torch.cat(pieces).contiguous()
    out = padded.new_empty((width,) + t.shape[1:])
    opts = dist.ReduceScatterOptions()
    opts.reduceOp = _reduce_op(op)
    g.pg._reduce_scatter_base(out, padded, opts).wait()
    return _out(out[:sizes[g.rank]], was_np)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """`src_rank`'s tensor, written into every member's `tensor`."""
    g = _manager.get(group_name)
    t, was_np = _as_tensor(tensor)
    opts = dist.BroadcastOptions()
    opts.rootRank = src_rank
    _inplace(t, lambda c: g.pg.broadcast([c], opts).wait())
    return _out(t, was_np)


def barrier(group_name: str = "default") -> None:
    g = _manager.get(group_name)
    if g.backend == "nccl":
        # NCCL's barrier is an allreduce on a card it guesses from the
        # rank; one of this process's own tensor is the same barrier.
        g.pg.allreduce([torch.zeros(1, device="cuda")]).wait()
        torch.cuda.current_stream().synchronize()
    else:
        g.pg.barrier().wait()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    g = _manager.get(group_name)
    t, _ = _as_tensor(tensor)
    g.pg.send([t.contiguous()], dst_rank, 0).wait()


def recv(tensor, src_rank: int, group_name: str = "default"):
    """Receives `src_rank`'s send into `tensor` and returns it."""
    g = _manager.get(group_name)
    t, was_np = _as_tensor(tensor)
    _inplace(t, lambda c: g.pg.recv([c], src_rank, 0).wait())
    return _out(t, was_np)
