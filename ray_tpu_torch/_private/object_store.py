"""Python client for the native shared-memory object store.

The store itself is C++ (the port's own copy of the reference's
src/object_store.cc, in `_private/csrc/object_store.cc`, built with g++
at first use into `ray_tpu_torch/_build/runtime/libtpustore.so`); this
module loads it via ctypes and adds the zero-copy read path:
`get_buffer` returns a memoryview directly into the shared mapping so
numpy arrays and CPU tensors consume object payloads without a copy (reference parity: plasma client mmap reads,
src/ray/object_manager/plasma/client.cc).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.native_build import ensure_built

# Error codes matching csrc/object_store.cc
OK = 0
ERR_NOT_FOUND = -1
ERR_EXISTS = -2
ERR_OUT_OF_MEMORY = -3
ERR_NOT_SEALED = -4
ERR_TABLE_FULL = -5
ERR_IN_USE = -6


class ObjectStoreError(Exception):
    pass


class ObjectStoreFullError(ObjectStoreError):
    pass


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built("object_store.cc", "libtpustore.so",
                                       extra_flags=("-lpthread",)))
        lib.store_create_arena.restype = ctypes.c_void_p
        lib.store_create_arena.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.store_attach.restype = ctypes.c_void_p
        lib.store_attach.argtypes = [ctypes.c_char_p]
        lib.store_detach.argtypes = [ctypes.c_void_p]
        lib.store_create.restype = ctypes.c_int
        lib.store_create.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        for name in ("store_seal", "store_release", "store_abort"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_get.restype = ctypes.c_int
        lib.store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.store_contains.restype = ctypes.c_int
        lib.store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_delete.restype = ctypes.c_int
        lib.store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.store_list.restype = ctypes.c_int
        lib.store_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.store_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.store_set_auto_evict.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.store_set_auto_evict.restype = None
        lib.store_lru_candidates.restype = ctypes.c_int
        lib.store_lru_candidates.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


class ObjectStoreClient:
    """Per-process handle on the node's shared-memory arena."""

    def __init__(self, path: str, create: bool = False, size: int = 0, table_capacity: int = 65536):
        lib = _get_lib()
        self._lib = lib
        self._path = path
        # RLock: release() can re-enter on the SAME thread when a ctypes
        # call triggers cyclic GC that collects a _ShmPin (whose __del__
        # calls release again) — a plain Lock would self-deadlock.
        self._release_lock = threading.RLock()
        if create:
            self._handle = lib.store_create_arena(path.encode(), size, table_capacity)
        else:
            self._handle = lib.store_attach(path.encode())
        if not self._handle:
            raise ObjectStoreError(f"failed to open object store arena at {path}")
        # Own mmap for zero-copy python-side reads/writes.
        fd = os.open(path, os.O_RDWR)
        try:
            self._map_size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, self._map_size)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)

    @property
    def path(self) -> str:
        return self._path

    def create(self, object_id: ObjectID, data_size: int, meta_size: int = 0) -> memoryview:
        """Allocate an object; returns writable view. Caller must seal()."""
        off = ctypes.c_uint64()
        rc = self._lib.store_create(self._handle, object_id.binary(), data_size, meta_size,
                                    ctypes.byref(off))
        if rc == ERR_EXISTS:
            raise ObjectStoreError(f"object {object_id.hex()} already exists")
        if rc in (ERR_OUT_OF_MEMORY, ERR_TABLE_FULL):
            raise ObjectStoreFullError(
                f"object store full creating {data_size} bytes (rc={rc})")
        if rc != OK:
            raise ObjectStoreError(f"create failed rc={rc}")
        return self._view[off.value: off.value + data_size]

    def seal(self, object_id: ObjectID) -> None:
        rc = self._lib.store_seal(self._handle, object_id.binary())
        if rc != OK:
            raise ObjectStoreError(f"seal failed rc={rc}")

    def put_raw(self, object_id: ObjectID, data: bytes, meta: bytes = b"") -> None:
        buf = self.create(object_id, len(meta) + len(data), len(meta))
        if meta:
            buf[: len(meta)] = meta
        buf[len(meta):] = data
        self.seal(object_id)

    def get_buffer(self, object_id: ObjectID):
        """Returns (meta: bytes, data: memoryview) zero-copy, or None if absent.

        Increments the shm refcount; call release() when the consumer is done
        (dropping references to the memoryview is not enough).
        """
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        meta_size = ctypes.c_uint64()
        rc = self._lib.store_get(self._handle, object_id.binary(), ctypes.byref(off),
                                 ctypes.byref(size), ctypes.byref(meta_size))
        if rc in (ERR_NOT_FOUND, ERR_NOT_SEALED):
            return None
        if rc != OK:
            raise ObjectStoreError(f"get failed rc={rc}")
        start = off.value
        meta = bytes(self._view[start: start + meta_size.value])
        data = self._view[start + meta_size.value: start + size.value]
        return meta, data

    def release(self, object_id: ObjectID) -> None:
        # May be called from GC (_ShmPin.__del__) on any thread, possibly
        # after close() at shutdown: the lock + None check keep a late
        # release from reaching C with a detached handle (segfault).
        with self._release_lock:
            if self._handle is None:
                return
            self._lib.store_release(self._handle, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.store_contains(self._handle, object_id.binary()))

    def delete(self, object_id: ObjectID, force: bool = False) -> bool:
        """force=True frees even while readers hold references — only the
        owner-driven distributed-refcount GC path may use it (a forced free
        under a live zero-copy view recycles memory mid-read)."""
        return self._lib.store_delete(self._handle, object_id.binary(), 1 if force else 0) == OK

    def abort(self, object_id: ObjectID) -> None:
        self._lib.store_abort(self._handle, object_id.binary())

    def list_objects(self, max_n: int = 65536) -> list[ObjectID]:
        buf = ctypes.create_string_buffer(max_n * ObjectID.SIZE)
        n = self._lib.store_list(self._handle, buf, max_n)
        raw = buf.raw
        return [ObjectID(raw[i * 20:(i + 1) * 20]) for i in range(n)]

    def set_auto_evict(self, enabled: bool) -> None:
        """Off = create() reports OOM instead of evicting, so the raylet
        can spill idle objects to disk first (spilled copies are
        restorable; evicted ones are gone until lineage re-executes)."""
        self._lib.store_set_auto_evict(self._handle, 1 if enabled else 0)

    def lru_candidates(self, needed: int, max_n: int = 4096) -> list[ObjectID]:
        """LRU-first sealed refcount==0 objects totalling >= needed bytes."""
        buf = ctypes.create_string_buffer(max_n * ObjectID.SIZE)
        n = self._lib.store_lru_candidates(self._handle, needed, buf, max_n)
        raw = buf.raw
        return [ObjectID(raw[i * 20:(i + 1) * 20]) for i in range(n)]

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 5)()
        self._lib.store_stats(self._handle, out)
        return {
            "num_objects": out[0],
            "bytes_in_use": out[1],
            "heap_size": out[2],
            "num_evictions": out[3],
            "num_creates": out[4],
        }

    def close(self) -> None:
        with self._release_lock:
            handle, self._handle = self._handle, None
        if handle:
            try:
                self._view.release()
                self._mm.close()
            except BufferError:
                # Zero-copy views handed to callers are still alive; leave
                # the mapping open (the OS reclaims it at process exit).
                pass
            self._lib.store_detach(handle)
