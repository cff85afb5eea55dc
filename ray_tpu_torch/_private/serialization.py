"""Object serialization for the ray_tpu_torch object store.

Re-design of the reference's serialization stack
(reference: python/ray/_private/serialization.py — cloudpickle + Arrow-aware
zero-copy numpy). Here: pickle protocol 5 with out-of-band buffers laid out
64-byte-aligned in the shm payload, so deserialization reconstructs numpy
arrays as read-only views directly into the shared mapping (no copy).
torch has no read-only tensor, so a tensor is restored as a copy of its
view: writing to it never changes the sealed object.

Layout of a stored object:
  meta  = msgpack([kind, pkl_size, [(buf_offset, buf_size), ...]])
  data  = pickle_bytes | pad | buf0 | pad | buf1 | ...

msgpack and cloudpickle are the package's own copies (`_vendor/`), so
the runtime needs neither installed.
"""

from __future__ import annotations

import pickle
import sys
import traceback
import warnings

from ray_tpu_torch._vendor import cloudpickle, msgpack

KIND_PYTHON = 0
KIND_EXCEPTION = 1
KIND_RAW = 2
KIND_ACTOR_HANDLE = 3
# Payload contains DeviceObjectStub placeholders for pinned tensors
# (see _private/device_objects.py); get() resolves them after deserialize.
KIND_DEVICE = 4

_ALIGN = 64

# torch dtypes numpy cannot hold travel as a same-width integer view.
_INT_VIEW = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _as_out_of_band(value):
    """Top-level torch tensors travel out of band (the reference does the
    same for a top-level jax.Array, restoring it with jax.device_put on
    the consumer). Pickling a tensor directly goes through torch's own
    reducer, an in-band copy of its storage; re-rooting it through numpy
    makes its bytes one pickle-5 buffer that lands 64-byte-aligned in the
    shm payload. A CUDA tensor is copied to
    the host once. Plain dense tensors only: a tensor that requires grad,
    a subclass (Parameter, DTensor) or a sparse one keeps torch's
    reducer."""
    torch = sys.modules.get("torch")
    if torch is None or type(value) is not torch.Tensor:
        return value
    if value.requires_grad or value.layout is not torch.strided:
        return value
    t = value.detach()
    was_cuda = t.device.type == "cuda"
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    try:
        arr = t.numpy()
    except TypeError:  # bf16, float8: no numpy dtype
        arr = t.view(getattr(torch, _INT_VIEW[t.element_size()])).numpy()
    return _TensorPayload(arr, dtype, was_cuda)


class _TensorPayload:
    """Pickles as its numpy buffer (out-of-band) and restores as a
    torch.Tensor on the consumer."""

    __slots__ = ("array", "dtype", "was_cuda")

    def __init__(self, array, dtype: str, was_cuda: bool):
        self.array = array
        self.dtype = dtype
        self.was_cuda = was_cuda

    def __reduce__(self):
        return (_restore_tensor, (self.array, self.dtype, self.was_cuda))


def _restore_tensor(array, dtype: str, was_cuda: bool):
    """A fresh tensor in its own dtype, copied once out of the payload.
    The payload is the sealed object that every reader on the node and
    every later get of the ref sees, and torch would write through a view
    of it (the reference's device_put always made a fresh, immutable
    array). A tensor that left a card goes to this process's current
    card where it sees one, and stays on the CPU where it sees none (a
    worker pinned to no card), as the reference's device_put onto a
    CPU-pinned worker."""
    import torch

    with warnings.catch_warnings():
        # The view is read-only; torch warns that it cannot mark the
        # tensor so. It is only read here, by the copy below.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(array)
    want = getattr(torch, dtype)
    if t.dtype != want:
        t = t.view(want)
    if was_cuda and torch.cuda.is_available():
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.clone()


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def dumps_func(fn) -> bytes:
    """Serialize a function/class definition (cloudpickle for closures)."""
    return cloudpickle.dumps(fn)


def loads_func(data: bytes):
    return pickle.loads(data)


class SerializedObject:
    __slots__ = ("meta", "inband", "buffers", "total_size")

    def __init__(self, meta: bytes, inband: bytes, buffers):
        self.meta = meta
        self.inband = inband
        self.buffers = buffers
        off = _align(len(inband))
        for b in buffers:
            off = _align(off + b.raw().nbytes)
        self.total_size = off if buffers else len(inband)

    def write_to(self, out: memoryview) -> None:
        out[: len(self.inband)] = self.inband
        off = _align(len(self.inband))
        for b in self.buffers:
            raw = b.raw()
            out[off: off + raw.nbytes] = raw.cast("B") if raw.format != "B" or raw.ndim != 1 else raw
            off = _align(off + raw.nbytes)

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        self.write_to(memoryview(out))
        return bytes(out)


def serialize(value, kind: int = KIND_PYTHON) -> SerializedObject:
    value = _as_out_of_band(value)
    buffers: list[pickle.PickleBuffer] = []
    try:
        inband = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    except Exception:
        buffers = []
        inband = cloudpickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    offsets = []
    off = _align(len(inband))
    for b in buffers:
        n = b.raw().nbytes
        offsets.append((off, n))
        off = _align(off + n)
    meta = msgpack.packb([kind, len(inband), offsets])
    return SerializedObject(meta, inband, buffers)


def serialize_primitive(value) -> tuple[bytes, bytes]:
    """Fast path for values that cannot contain ObjectRefs or buffers
    (exact builtin scalar/str/bytes types): one pickle, one packb — skips
    the buffer/offset bookkeeping and SerializedObject construction that
    dominate per-arg cost on the task-submission hot path."""
    inband = pickle.dumps(value, protocol=5)
    return msgpack.packb([KIND_PYTHON, len(inband), []]), inband


def serialize_exception(exc: BaseException) -> SerializedObject:
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        return serialize((exc, tb), kind=KIND_EXCEPTION)
    except Exception:
        # Unpicklable exception: degrade to type name + traceback text.
        return serialize((RuntimeError(f"{type(exc).__name__}: {exc}"), tb),
                         kind=KIND_EXCEPTION)


def deserialize(meta: bytes, data):
    """data: bytes or memoryview over the payload. Returns (kind, value).
    Out-of-band buffers are read-only views: a numpy array in the value
    cannot write to the stored object."""
    kind, pkl_size, offsets = msgpack.unpackb(meta)
    view = data if isinstance(data, memoryview) else memoryview(data)
    view = view.toreadonly()
    bufs = [view[o: o + n] for o, n in offsets]
    value = pickle.loads(view[:pkl_size], buffers=bufs)
    return kind, value
