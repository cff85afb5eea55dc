"""Device object plane: pass torch tensors between tasks and actors
without a round trip through host memory. Port of
ray_tpu/_private/device_objects.py.

The producing worker PINS the live tensor in a per-process registry keyed
by the return object id, and only a small descriptor (shape, dtype, the
pinning worker's address, the card's UUID) travels the object path as
the object's value (serialization.KIND_DEVICE). Resolution picks a
route, each counted under its own name:

  in_process -> same process: the live tensor itself (identity), as the
                reference hands over the live jax.Array
  ipc        -> same machine, CUDA on both sides, and the consumer sees
                the producer's card: a CUDA IPC handle (torch's
                reduce_tensor / rebuild_cuda_tensor) and a device-to-
                device copy into a fresh tensor on the consumer
  collective -> CUDA on both sides otherwise (another node, or a card
                the consumer does not see): NCCL send/recv between the
                two processes, in a two-member group of the
                `__device_plane__` rendezvous
  host       -> everything else, CPU tensors included: the bytes ride
                the pull's reply, and land on the consumer's card if the
                tensor left one and the consumer sees a card (the
                reference's counted host fallback)

Failure semantics are the reference's: when the pinning worker dies the
descriptor reports the object lost, and a resolving owner re-executes
the creating task through lineage reconstruction (worker.py), which
re-pins. Releasing the owning ObjectRef unpins (worker._free_object
notifies the pinning worker). A drain evacuates pins to their ref
owners (`evacuate`), by the ipc route where the owner shares the
machine and the card, else by the host route.

The reference also exports its counters as util/metrics gauges; the
port has no util/metrics yet (ROADMAP A1, second part), so `counters()`
and the raylet's NodeDeviceObjects are the surface.

Importing this module does no CUDA work: the routes touch CUDA only on
processes that already hold or receive CUDA tensors.
"""

from __future__ import annotations

import itertools
import logging
import pickle
import sys
import threading
import time

import numpy as np

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.common import require_fields

logger = logging.getLogger(__name__)

COLLECTIVE_GROUP = "__device_plane__"

_counter_lock = threading.Lock()
_counters = {
    "total_pinned": 0,       # tensors ever pinned
    "in_process": 0,         # same-process handovers (identity)
    "ipc": 0,                # CUDA IPC transfers completed (consumer side)
    "ipc_out": 0,            # CUDA IPC handles served (producer side)
    "collective": 0,         # NCCL transfers completed
    "collective_out": 0,     # NCCL transfers served (producer side)
    "host_fallback": 0,      # host-path transfers completed
    "host_out": 0,           # host-path pulls served (producer side)
    "lost": 0,               # resolutions that found the pin gone
    "released": 0,           # tensors unpinned by refcount release
    "evacuated_out": 0,      # tensors shipped off a draining node
    "evacuated_in": 0,       # tensors re-pinned here by an evacuation
    "errors_total": 0,       # swallowed-but-logged failures on the
                             # pull/evacuation/repin degraded paths
}
_handoff_seq = itertools.count(1)
_pair_seq = itertools.count(1)
# The host route's bytes go in RPC frames (capped at 2 GiB,
# _private/rpc.py): a pull or an evacuation sends at most this many
# bytes of tensors a call.
HOST_CHUNK_BYTES = 256 << 20


def _count(name: str, n: int = 1) -> None:
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    with _counter_lock:
        return dict(_counters)


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


def _card_uuid(device) -> str:
    import torch

    return str(torch.cuda.get_device_properties(device).uuid)


def _local_card_index(uuid: str) -> int | None:
    """This process's index of the card with `uuid`, or None.

    Card numbering: a worker sees only its lease's cards
    (CUDA_VISIBLE_DEVICES), so the producer's cuda:0 may be the
    consumer's cuda:3. The descriptor carries the card's UUID and the
    consumer maps it to its own index."""
    import torch

    if not uuid or not torch.cuda.is_available():
        return None
    for i in range(torch.cuda.device_count()):
        if _card_uuid(i) == uuid:
            return i
    return None


# torch dtypes numpy cannot hold travel as a same-width integer view.
_INT_VIEW = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _to_wire(t) -> tuple[str, list, bytes]:
    """(dtype, shape, bytes) of a tensor, gathered to the host."""
    import torch

    host = t.detach().to("cpu").contiguous()
    try:
        arr = host.numpy()
    except TypeError:  # bf16, float8: no numpy dtype
        arr = host.view(getattr(torch, _INT_VIEW[host.element_size()])).numpy()
    return (str(t.dtype).removeprefix("torch."), list(t.shape),
            arr.tobytes())


def _from_wire(dtype: str, shape, data: bytes, on_card: bool):
    """A fresh tensor from wire bytes, on this process's current card when
    the tensor left one and this process sees one."""
    import torch

    want = getattr(torch, dtype)
    probe = torch.empty(0, dtype=want)
    try:
        view = probe.numpy().dtype
    except TypeError:  # bf16, float8: an integer view of the same width
        view = np.dtype(_INT_VIEW[probe.element_size()])
    t = torch.from_numpy(np.frombuffer(bytearray(data), dtype=view)
                         .reshape(shape))
    if t.dtype != want:
        t = t.view(want)
    if on_card and torch.cuda.is_available():
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


class DeviceObjectMeta:
    """Wire-light descriptor of one pinned tensor (the only thing that
    travels the object path for a device object). `platform` is the
    tensor's device type; `device_ids` its card index in the producer;
    `card_uuid` that card's UUID, which the consumer maps to its own
    index."""

    __slots__ = ("key", "shape", "dtype", "nbytes", "owner_addr",
                 "platform", "device_ids", "sharding", "card_uuid")

    def __init__(self, key, shape, dtype, nbytes, owner_addr, platform,
                 device_ids, sharding, card_uuid=""):
        self.key = key
        self.shape = shape
        self.dtype = dtype
        self.nbytes = nbytes
        self.owner_addr = owner_addr  # Address.to_wire() of pin worker
        self.platform = platform
        self.device_ids = device_ids
        self.sharding = sharding
        self.card_uuid = card_uuid

    def __reduce__(self):
        return (DeviceObjectMeta,
                (self.key, self.shape, self.dtype, self.nbytes,
                 self.owner_addr, self.platform, self.device_ids,
                 self.sharding, self.card_uuid))

    def to_dict(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}


class DeviceObjectStub:
    """Placeholder stored in place of a pinned tensor inside a
    KIND_DEVICE payload; get() swaps it for the resolved tensor."""

    __slots__ = ("meta",)

    def __init__(self, meta: DeviceObjectMeta):
        self.meta = meta

    def __reduce__(self):
        return (DeviceObjectStub, (self.meta,))

    def __repr__(self):
        return (f"DeviceObjectStub({self.meta.key}, shape="
                f"{tuple(self.meta.shape)}, dtype={self.meta.dtype}, "
                f"{self.meta.nbytes}B @ {self.meta.platform})")


class DeviceRegistry:
    """Per-process pin table: key -> live tensor. Pinning holds the
    tensor's memory for as long as the owning object is referenced."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, tuple] = {}  # key -> (tensor, meta, ts)
        # prefix -> Address wire of the process that OWNS the ObjectRef
        # whose payload these pins back (a drain evacuation re-homes the
        # tensors there).
        self._ref_owners: dict[str, list | None] = {}

    def note_ref_owner(self, prefix: str, owner_wire) -> None:
        with self._lock:
            self._ref_owners[prefix] = owner_wire

    def ref_owner(self, prefix: str):
        with self._lock:
            return self._ref_owners.get(prefix)

    def pin(self, key: str, tensor, cw=None) -> DeviceObjectMeta:
        platform = tensor.device.type
        device_ids, uuid = [], ""
        if platform == "cuda":
            import torch

            # Stream order: the producer's writes must be finished before
            # any consumer reads, whatever its stream; the pin waits for
            # the work queued on the tensor's card.
            torch.cuda.current_stream(tensor.device).synchronize()
            device_ids = [tensor.device.index]
            uuid = _card_uuid(tensor.device)
        meta = DeviceObjectMeta(
            key=key,
            shape=[int(s) for s in tensor.shape],
            dtype=str(tensor.dtype).removeprefix("torch."),
            nbytes=int(tensor.numel() * tensor.element_size()),
            owner_addr=(cw.address.to_wire()
                        if cw is not None and cw.address else None),
            platform=platform,
            device_ids=device_ids,
            sharding="",
            card_uuid=uuid)
        with self._lock:
            self._entries[key] = (tensor, meta, time.time())
        _count("total_pinned")
        return meta

    def get(self, key: str):
        with self._lock:
            entry = self._entries.get(key)
        return entry[0] if entry is not None else None

    def get_entry(self, key: str):
        with self._lock:
            return self._entries.get(key)

    def release(self, key: str) -> bool:
        with self._lock:
            gone = self._entries.pop(key, None)
        if gone is not None:
            _count("released")
        return gone is not None

    def release_prefix(self, prefix: str, *, counted: bool = True) -> int:
        """Unpin every leaf of one device object (keys are
        '<prefix>#<leaf-index>'). counted=False for internal unpins
        (a drain evacuation moves tensors, it does not release them)."""
        with self._lock:
            keys = [k for k in self._entries
                    if k == prefix or k.startswith(prefix + "#")]
            for k in keys:
                del self._entries[k]
            self._ref_owners.pop(prefix, None)
        if keys and counted:
            _count("released", len(keys))
        return len(keys)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._entries)
            total = sum(e[1].nbytes for e in self._entries.values())
        return {"pinned_objects": n, "pinned_bytes": total,
                "counters": counters()}

    def entries(self) -> list[dict]:
        with self._lock:
            snap = [(k, e[1], e[2]) for k, e in self._entries.items()]
        return [{"key": k, "shape": m.shape, "dtype": m.dtype,
                 "nbytes": m.nbytes, "platform": m.platform,
                 "device_ids": m.device_ids, "card_uuid": m.card_uuid,
                 "pinned_ts": ts}
                for k, m, ts in snap]


_registry: DeviceRegistry | None = None
_registry_lock = threading.Lock()


def registry() -> DeviceRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = DeviceRegistry()
        return _registry


# ---------- extract / resolve ----------

def tree_map(value, fn, is_leaf):
    """Minimal pytree map over dict/list/tuple/namedtuple containers:
    the one traversal shared by extraction, resolution and consumers."""

    def walk(v):
        if is_leaf(v):
            return fn(v)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, tuple):
            walked = tuple(walk(x) for x in v)
            if type(v) is not tuple and hasattr(v, "_fields"):
                return type(v)(*walked)  # namedtuple
            return walked
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    return walk(value)


def extract_arrays(value, prefix: str, cw=None):
    """Pin every tensor leaf of `value` under '<prefix>#<i>' and replace
    it with a DeviceObjectStub. Returns (stubbed_value, total_bytes,
    n_leaves); n_leaves == 0 means `value` is returned untouched and
    should take the normal host path."""
    reg = registry()
    state = {"n": 0, "bytes": 0}

    def pin(v):
        key = f"{prefix}#{state['n']}"
        meta = reg.pin(key, v, cw)
        state["n"] += 1
        state["bytes"] += meta.nbytes
        return DeviceObjectStub(meta)

    out = tree_map(value, pin, _is_tensor)
    if state["n"] == 0:
        return value, 0, 0
    return out, state["bytes"], state["n"]


def choose_route(meta: DeviceObjectMeta, cw=None) -> str:
    """Transfer route for a stub whose pin is in another process (the
    same-process case never reaches here: the registry hit wins first).

      ipc        - a CUDA tensor, the producer on this node or on this
                   host (several raylets of one machine, as a
                   cluster_utils.Cluster starts them), and this process
                   sees the producer's card (by UUID)
      collective - a CUDA tensor, and this process sees a card
      host       - everything else
    """
    import torch

    if meta.platform != "cuda" or not torch.cuda.is_available() \
            or torch.cuda.device_count() == 0:
        return "host"
    owner = meta.owner_addr
    address = getattr(cw, "address", None)
    same_host = cw is not None and owner is not None and (
        owner[3] == cw.node_id
        or (address is not None and owner[0] == address.host))
    if same_host and _local_card_index(meta.card_uuid) is not None:
        return "ipc"
    return "collective"


def _is_stub(v) -> bool:
    return isinstance(v, DeviceObjectStub)


def retarget_stubs(value, owner_addr):
    """Point every stub at a fresh pinning worker. After lineage
    reconstruction the re-executed task pins under the SAME keys (the
    prefix embeds the task id), but a store-resident stub payload is not
    rewritten; the owner's refreshed dev_info carries the live address."""

    def fix(stub):
        m = stub.meta
        return DeviceObjectStub(DeviceObjectMeta(
            m.key, m.shape, m.dtype, m.nbytes, owner_addr, m.platform,
            m.device_ids, m.sharding, m.card_uuid))

    return tree_map(value, fix, _is_stub)


def resolve_value(value, cw):
    """Swap every DeviceObjectStub in a deserialized KIND_DEVICE payload
    for a tensor, by the cheapest route. Remote leaves are grouped by
    pinning worker and fetched with ONE batched pull per worker. Raises
    DeviceObjectLostError when a pin is gone (the owner handles lineage
    reconstruction; borrowers surface the loss)."""
    reg = registry()
    resolved: dict[str, object] = {}
    remote: dict[tuple, list[DeviceObjectMeta]] = {}

    def scan(stub):
        meta = stub.meta
        if meta.key not in resolved:
            local = reg.get(meta.key)
            if local is not None:
                _count("in_process")
                resolved[meta.key] = local
            else:
                addr_key = tuple(meta.owner_addr) if meta.owner_addr \
                    else None
                group = remote.setdefault(addr_key, [])
                if all(m.key != meta.key for m in group):
                    group.append(meta)
        return stub

    tree_map(value, scan, _is_stub)
    for metas in remote.values():
        resolved.update(_pull_batch(metas, cw))
    return tree_map(value, lambda s: resolved[s.meta.key], _is_stub)


def _open_ipc(pairs: list) -> list:
    """The consumer's own copies of tensors pinned in another process on
    cards this process sees; `pairs` is [(meta, handle blob)].

    - Card numbering: each handle is opened on this process's index of
      the card with the producer's UUID, not the producer's index.
    - Stream order: the pin synchronised the producer's stream, and
      rebuild_cuda_tensor waits on the event reduce_tensor recorded.
    - Lifetime and writes: the mapped tensors are only read, each by one
      device-to-device copy into a fresh tensor; the copies finish before
      this returns and the mappings are dropped then, so the producer may
      release its pins, and no process writes into another's pinned
      tensor. The mappings are held until every copy is queued: tensors
      of one allocation segment then share one opened IPC handle (the
      caching allocator reuses an open mapping) where opening and
      closing it for each tensor costs tens of ms apiece."""
    import torch
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    mapped, out, cards = [], [], set()
    for meta, blob in pairs:
        args = list(pickle.loads(blob))
        index = _local_card_index(meta.card_uuid)
        args[6] = index  # storage_device
        with torch.cuda.device(index):
            m = rebuild_cuda_tensor(*args)
            t = torch.empty_like(m, device=torch.device("cuda", index))
            t.copy_(m)
        mapped.append(m)
        out.append(t)
        cards.add(index)
    for index in cards:
        torch.cuda.current_stream(index).synchronize()
    del mapped
    return out


def _chunked(items: list, cap: int, nbytes=lambda m: m.nbytes) -> list:
    """items (metas by default) in consecutive batches of at most `cap`
    bytes (a larger one alone)."""
    batches, cur, size = [], [], 0
    for item in items:
        if cur and size + nbytes(item) > cap:
            batches.append(cur)
            cur, size = [], 0
        cur.append(item)
        size += nbytes(item)
    if cur:
        batches.append(cur)
    return batches


def _pair_store(host: str, port: int, serve: bool):
    """The store of a two-member NCCL group of the device plane: the
    consumer serves it (port 0: one the OS picks) before it asks, so the
    producer's sends have a rendezvous to reach."""
    import datetime

    import torch.distributed as dist

    return dist.TCPStore(host, port, 2, serve,
                         timeout=datetime.timedelta(seconds=60),
                         wait_for_workers=False)


def _pair_group(store, rank: int, tag: str):
    """One pull's group: the producer is rank 0, the consumer rank 1."""
    import torch.distributed as dist

    from ray_tpu_torch.util.collective.collective import new_process_group

    return new_process_group(
        "nccl", dist.PrefixStore(f"{COLLECTIVE_GROUP}/{tag}", store), rank,
        2)


def _pull_batch(metas: list[DeviceObjectMeta], cw) -> dict:
    """Fetch the pinned tensors of ONE pinning worker; returns {key:
    tensor}. Its card tensors and its others go apart (one pull takes
    one route), each in one RPC, but the host route in calls of at most
    HOST_CHUNK_BYTES."""
    out = {}
    for group in ([m for m in metas if m.platform == "cuda"],
                  [m for m in metas if m.platform != "cuda"]):
        if not group:
            continue
        route = choose_route(group[0], cw)
        for batch in (_chunked(group, HOST_CHUNK_BYTES) if route == "host"
                      else [group]):
            out.update(_pull(batch, cw, route))
    return out


def _pull(metas: list[DeviceObjectMeta], cw, route: str) -> dict:
    """One pull RPC to the pinning worker of `metas`, by `route`."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.common import Address

    first = metas[0]
    if cw is None or first.owner_addr is None:
        raise exc.DeviceObjectLostError(
            first.key, f"device object {first.key} has no reachable pin "
                       "owner (produced by a process with no runtime?)")
    addr = Address.from_wire(first.owner_addr)
    if addr.worker_id == cw.worker_id:
        # We ARE the pinning process but the registry missed: the pin was
        # released (or this is a restarted incarnation): the data is gone.
        raise exc.DeviceObjectLostError(
            first.key, f"device object {first.key} is no longer pinned "
                       "in this process")
    keys = [m.key for m in metas]
    request = {"keys": keys, "route": route, "requester": cw.worker_id,
               "requester_addr": cw.address.to_wire()}
    store = None
    if route == "collective":
        store = _pair_store(cw.address.host, 0, serve=True)
        request["store"] = [cw.address.host, store.port]
        request["tag"] = f"{cw.worker_id[:12]}:{next(_pair_seq)}"

    async def call():
        conn = await cw._owner_conn(addr)
        return await conn.call("DeviceObjectPull", request,
                               timeout=cw.config.rpc_call_timeout_s)

    try:
        resp = cw._run(call())
    except (rpc.RpcError, OSError, ConnectionError, TimeoutError) as e:
        raise exc.DeviceObjectLostError(
            first.key, f"pin owner of device objects {keys[:3]} "
                       f"unreachable: {e}") from None
    missing = resp.get("missing") or []
    if missing:
        raise exc.DeviceObjectLostError(
            missing[0], f"device object {missing[0]} is no longer pinned "
                        f"on worker {addr.worker_id[:12]}")
    by_key = {m.key: m for m in metas}
    out = {}
    status = resp.get("status")
    if status == "ipc":
        items = resp["items"]
        got = _open_ipc([(by_key[item["key"]], item["ipc"])
                         for item in items])
        for item, t in zip(items, got):
            out[item["key"]] = t
        _count("ipc", len(items))
        return out
    if status == "collective":
        import torch

        pg = _pair_group(store, 1, request["tag"])
        try:
            for key in resp["tags"]:
                m = by_key[key]
                t = torch.empty(m.shape, dtype=getattr(torch, m.dtype),
                                device="cuda")
                pg.recv([t], 0, 0).wait()
                out[key] = t
                _count("collective")
            torch.cuda.current_stream().synchronize()
        finally:
            pg.shutdown()
        return out
    # host route: the reply carries the gathered bytes per key.
    for item in resp["items"]:
        out[item["key"]] = _from_wire(item["dtype"], item["shape"],
                                      item["data"],
                                      by_key[item["key"]].platform == "cuda")
        _count("host_fallback")
    return out


# ---------- producer-side RPC handlers (worker.py delegates here) ----------

def _ipc_blob(t) -> bytes:
    from torch.multiprocessing.reductions import reduce_tensor

    _rebuild, args = reduce_tensor(t)
    return pickle.dumps(args)


def _send_pair(store_addr, tag: str, tensors: list) -> None:
    """Producer side of the collective route, off the RPC loop: join the
    pair's group as rank 0 and send each tensor in order."""
    try:
        store = _pair_store(store_addr[0], int(store_addr[1]), serve=False)
        pg = _pair_group(store, 0, tag)
        try:
            for t in tensors:
                pg.send([t.contiguous()], 1, 0).wait()
            import torch

            torch.cuda.current_stream().synchronize()
        finally:
            pg.shutdown()
        _count("collective_out", len(tensors))
    except Exception:
        _count("errors_total")
        logger.warning("device plane: NCCL send to %s failed", store_addr,
                       exc_info=True)


async def handle_pull(cw, payload: dict) -> dict:
    """Serve a batch of pinned tensors to one consumer, by the route it
    chose: IPC handles, an NCCL send started in a thread (the reply names
    the tags the consumer then receives in order), or the bytes inline.
    Host gathers and IPC exports run in an executor: a large pull must
    not stall this worker's RPC loop."""
    import asyncio

    keys = payload.get("keys")
    if not keys:
        require_fields(payload, "key", method="handle_pull")
        keys = [payload["key"]]
    reg = registry()
    entries, missing = [], []
    for key in keys:
        entry = reg.get_entry(key)
        if entry is None:
            missing.append(key)
        else:
            entries.append((key, entry[0]))
    if missing:
        return {"status": "gone", "missing": missing}
    loop = asyncio.get_running_loop()
    route = payload.get("route")
    cuda = all(t.device.type == "cuda" for _k, t in entries)
    if route == "ipc" and cuda:
        items = [{"key": key, "ipc": await loop.run_in_executor(
            None, _ipc_blob, t)} for key, t in entries]
        _count("ipc_out", len(items))
        return {"status": "ipc", "items": items}
    if route == "collective" and cuda:
        require_fields(payload, "store", "tag", method="handle_pull")
        threading.Thread(
            target=_send_pair, daemon=True,
            args=(payload["store"], payload["tag"],
                  [t for _k, t in entries])).start()
        return {"status": "collective", "tags": [k for k, _t in entries]}
    gathered = [(key, await loop.run_in_executor(None, _to_wire, t))
                for key, t in entries]
    _count("host_out", len(gathered))
    return {"status": "host",
            "items": [{"key": key, "dtype": dtype, "shape": shape,
                       "data": data}
                      for key, (dtype, shape, data) in gathered]}


async def handle_release(cw, payload: dict) -> dict:
    require_fields(payload, "prefix", method="handle_release")
    n = registry().release_prefix(payload["prefix"])
    return {"released": n}


async def handle_stats(cw, payload: dict) -> dict:
    out = registry().stats()
    out["worker_id"] = cw.worker_id
    if payload.get("entries"):
        out["entries"] = registry().entries()
    return out


# ---------- drain-path evacuation ----------

# Callbacks that materialize last-moment pins (e.g. a serving engine
# snapshotting in-flight stream KV): run to completion INSIDE evacuate()
# before the registry is snapshotted.
_evac_preparers: list = []


def add_evacuation_preparer(fn) -> None:
    """Register fn() to run (in an executor thread, awaited) before a
    drain evacuation gathers this process's pins."""
    if fn not in _evac_preparers:
        _evac_preparers.append(fn)


def remove_evacuation_preparer(fn) -> None:
    try:
        _evac_preparers.remove(fn)
    except ValueError:
        pass


async def evacuate(cw) -> dict:
    """Re-home every pinned tensor whose ObjectRef owner lives off this
    node: called by the raylet's drain pipeline before the node dies.
    Leaves are grouped per device object (prefix) and shipped to the
    ref-owner process, which re-pins them under the SAME keys and
    refreshes its descriptor (DeviceObjectRepin); the prefix is released
    here once all landed. Card tensors go by the ipc route where the
    owner is on this machine and sees their card (it opens the handles
    and copies while this process waits), the rest, and those the owner
    refuses, by the host route in calls of at most HOST_CHUNK_BYTES (the
    reference's is the host route unless its peer plane is opted into).
    The NCCL route is not used: it needs the receiver to post its
    receives, and a push from a dying node has nobody posting them. Pins
    whose ref owner dies with this node are skipped."""
    import asyncio

    from ray_tpu_torch._private.common import Address

    loop = asyncio.get_running_loop()
    for fn in list(_evac_preparers):
        try:
            await loop.run_in_executor(None, fn)
        except Exception:
            logger.warning("evacuation preparer failed; continuing with "
                           "existing pins", exc_info=True)
    reg = registry()
    with reg._lock:
        snap = list(reg._entries.items())
        owners = dict(reg._ref_owners)
    by_prefix: dict[str, list] = {}
    for key, entry in snap:
        by_prefix.setdefault(key.split("#", 1)[0], []).append((key, entry))
    stats = {"evacuated_objects": 0, "evacuated_bytes": 0, "skipped": 0,
             "routes": {}}
    here = cw.address.host if cw.address else None

    def gather(batch):
        return [{"key": key, "dtype": dtype, "shape": shape, "data": data,
                 "on_card": meta.platform == "cuda"}
                for key, (tensor, meta, _ts) in batch
                for dtype, shape, data in [_to_wire(tensor)]]

    def handles(batch):
        return [{"key": key, "meta": meta.to_dict(),
                 "ipc": _ipc_blob(tensor)}
                for key, (tensor, meta, _ts) in batch]

    for prefix, leaves in by_prefix.items():
        owner_wire = owners.get(prefix)
        if not owner_wire:
            stats["skipped"] += len(leaves)
            continue
        addr = Address.from_wire(owner_wire)
        if addr.worker_id == cw.worker_id or addr.node_id == cw.node_id:
            # The owner dies with this node: nothing to preserve.
            stats["skipped"] += len(leaves)
            continue
        routes = {}
        host = leaves
        try:
            conn = await cw._owner_conn(addr)
            cards = [leaf for leaf in leaves
                     if leaf[1][1].platform == "cuda"]
            if cards and addr.host == here:
                resp = await conn.call("DeviceObjectRepin", {
                    "prefix": prefix, "route": "ipc",
                    "items": await loop.run_in_executor(None, handles,
                                                        cards)},
                    timeout=60)
                if resp.get("ok"):
                    routes["ipc"] = len(cards)
                    host = [leaf for leaf in leaves
                            if leaf[1][1].platform != "cuda"]
            for batch in _chunked(host, HOST_CHUNK_BYTES,
                                  lambda leaf: leaf[1][1].nbytes):
                items = await loop.run_in_executor(None, gather, batch)
                resp = await conn.call("DeviceObjectRepin", {
                    "prefix": prefix, "route": "host", "items": items},
                    timeout=60)
                if not resp.get("ok"):
                    raise RuntimeError(f"repin refused: {resp}")
            if host:
                routes["host"] = len(host)
        except Exception:
            _count("errors_total")
            stats["skipped"] += len(leaves)
            continue
        reg.release_prefix(prefix, counted=False)
        stats["evacuated_objects"] += len(leaves)
        stats["evacuated_bytes"] += sum(e[1].nbytes for _k, e in leaves)
        for route, n in routes.items():
            stats["routes"][route] = stats["routes"].get(route, 0) + n
        _count("evacuated_out", len(leaves))
    return stats


async def handle_repin(cw, payload: dict) -> dict:
    """Ref-owner side of a drain evacuation: pin the tensors a dying node
    shipped over in THIS process under their original keys, and repoint
    the owned object's descriptor here, so gets resolve against a live
    pin instead of falling into lineage reconstruction. An "ipc" batch
    (handles to the evacuating process's card tensors) is refused unless
    this process sees every card named; the evacuator then sends the
    bytes."""
    import asyncio

    require_fields(payload, "prefix", "items", method="handle_repin")
    prefix = payload["prefix"]
    items = payload["items"]
    if payload.get("route") == "ipc":
        import torch

        metas = [DeviceObjectMeta(**item["meta"]) for item in items]
        if not torch.cuda.is_available() or any(
                _local_card_index(m.card_uuid) is None for m in metas):
            return {"ok": False, "reason": "the cards are not seen here"}
        tensors = await asyncio.get_running_loop().run_in_executor(
            None, _open_ipc, [(m, item["ipc"]) for m, item in
                              zip(metas, items)])
    else:
        tensors = [_from_wire(item["dtype"], item["shape"], item["data"],
                              bool(item.get("on_card"))) for item in items]
    reg = registry()
    total = 0
    for item, tensor in zip(items, tensors):
        total += reg.pin(item["key"], tensor, cw).nbytes
    own_wire = cw.address.to_wire() if cw.address else None
    reg.note_ref_owner(prefix, own_wire)
    _count("evacuated_in", len(items))
    cw._post(cw._repoint_device_pin, prefix, own_wire)
    return {"ok": True, "repinned": len(items), "bytes": total}


def note_lost() -> None:
    _count("lost")


# ---------- driver/actor-facing helpers ----------

def device_put(value):
    """Pin a (tree of) tensor(s) in THIS process's registry and store only
    the descriptor as the object value: the device-plane counterpart of
    ray_tpu_torch.put. Consumers resolve by the cheapest route; freeing
    the returned ref unpins. Values with no tensor leaves fall back to a
    plain put."""
    import ray_tpu_torch
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.api_internal import (DeviceObjectRef,
                                                     collect_nested_refs,
                                                     get_core_worker)
    from ray_tpu_torch._private.ids import ObjectID

    cw = get_core_worker()
    oid = ObjectID.for_put(cw._current_task_id, next(cw._put_counter))
    prefix = f"put:{oid.hex()[:16]}:{next(_handoff_seq)}"
    stubbed, total, n = extract_arrays(value, prefix, cw)
    if n == 0:
        return ray_tpu_torch.put(value)
    # Self-owned pin: evacuation has nothing to move (the ref dies with
    # this process), but the owner record keeps the table uniform.
    registry().note_ref_owner(prefix, cw.address.to_wire())
    with collect_nested_refs() as sink:
        sobj = serialization.serialize(stubbed,
                                       kind=serialization.KIND_DEVICE)
    if sink:
        cw._post(cw._track_container, oid.hex(), list(sink))
    cw._run(cw._store_owned(oid, sobj))
    dev_info = [cw.address.to_wire(), prefix, total, n]
    cw._post(cw._set_device_info, oid.hex(), dev_info)
    return DeviceObjectRef(oid, cw.address)


def local_handoff(tag: str, value):
    """Same-process producer -> consumer handoff through the plane: pin,
    resolve (a registry hit: the same tensors), unpin. Ticks the
    in_process counter so the handoff is observable."""
    prefix = f"{tag}:{next(_handoff_seq)}"
    stubbed, _total, n = extract_arrays(value, prefix, None)
    if n == 0:
        return value
    try:
        return resolve_value(stubbed, None)
    finally:
        registry().release_prefix(prefix)
