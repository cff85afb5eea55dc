"""ctypes binding for the native GCS table storage.

The store is C++ (csrc/gcs_store.cc, built to
ray_tpu_torch/_build/runtime/libtorchgstore.so) — the TPU-native equivalent of
the reference's gcs_table_storage over store_client (reference:
src/ray/gcs/gcs_server/gcs_table_storage.cc, store_client/
redis_store_client.h — redis is what gives the reference per-mutation
durability for GCS fault tolerance).

Rows are opaque bytes keyed (namespace, key): every put/del appends one
WAL record, fflush'd per append, so an acknowledged mutation survives a
GCS PROCESS crash (kill -9) — the GCS writes rows through HERE before
replying to mutating RPCs. OS-crash/power-loss durability additionally
needs `sync()` (fdatasync), which the GCS batches on a short debounce —
the same exposure window as the reference's default redis
appendfsync-everysec. Truncated tails and corrupt length fields stop
restart replay at the last complete record. `compact()` rewrites the
snapshot and truncates the WAL; the GCS calls it when the WAL outgrows
the snapshot.
"""

from __future__ import annotations

import ctypes

from ray_tpu_torch._private.native_build import ensure_built

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built("gcs_store.cc", "libtorchgstore.so"))
        lib.gstore_create.restype = ctypes.c_void_p
        lib.gstore_create.argtypes = [ctypes.c_char_p]
        lib.gstore_destroy.argtypes = [ctypes.c_void_p]
        lib.gstore_put.restype = ctypes.c_int
        lib.gstore_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.gstore_del.restype = ctypes.c_int
        lib.gstore_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
        lib.gstore_get.restype = ctypes.c_int
        lib.gstore_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
        lib.gstore_num_rows.restype = ctypes.c_int
        lib.gstore_num_rows.argtypes = [ctypes.c_void_p]
        lib.gstore_wal_bytes.restype = ctypes.c_uint64
        lib.gstore_wal_bytes.argtypes = [ctypes.c_void_p]
        lib.gstore_scan.restype = ctypes.c_int
        lib.gstore_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.gstore_namespaces.restype = ctypes.c_int
        lib.gstore_namespaces.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.gstore_compact.restype = ctypes.c_int
        lib.gstore_compact.argtypes = [ctypes.c_void_p]
        lib.gstore_sync.restype = ctypes.c_int
        lib.gstore_sync.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class GcsTableStore:
    """Durable (namespace, key) -> bytes tables with WAL persistence."""

    def __init__(self, path_prefix: str):
        self._lib = _get_lib()
        self._h = ctypes.c_void_p(
            self._lib.gstore_create(path_prefix.encode()))

    def close(self):
        if self._h:
            self._lib.gstore_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def put(self, ns: str, key: str, value: bytes) -> bool:
        """False when the WAL append failed (disk full, ...) — the
        caller must NOT mark the row as flushed."""
        return self._lib.gstore_put(self._h, ns.encode(), key.encode(),
                                    value, len(value)) == 0

    def delete(self, ns: str, key: str) -> bool:
        return self._lib.gstore_del(self._h, ns.encode(),
                                    key.encode()) == 0

    def get(self, ns: str, key: str) -> bytes | None:
        n = self._lib.gstore_get(self._h, ns.encode(), key.encode(),
                                 None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(max(n, 1))
        self._lib.gstore_get(self._h, ns.encode(), key.encode(), buf, n)
        return buf.raw[:n]

    def scan(self, ns: str):
        """Yield (key, value) over one namespace."""
        cursor = ctypes.c_int(0)
        ksize, vsize = 4096, 1 << 20
        kbuf = ctypes.create_string_buffer(ksize)
        vbuf = ctypes.create_string_buffer(vsize)
        while True:
            rc = self._lib.gstore_scan(self._h, ns.encode(),
                                       ctypes.byref(cursor), kbuf, ksize,
                                       vbuf, vsize)
            if rc == -2:
                # -2 means EITHER buffer was too small; grow both (a
                # huge internal_kv key can outgrow kbuf, not just vbuf).
                ksize *= 4
                vsize *= 4
                kbuf = ctypes.create_string_buffer(ksize)
                vbuf = ctypes.create_string_buffer(vsize)
                continue
            if rc < 0:
                return
            yield kbuf.value.decode(), vbuf.raw[:rc]

    def namespaces(self) -> list[str]:
        buf = ctypes.create_string_buffer(16384)
        rc = self._lib.gstore_namespaces(self._h, buf, len(buf))
        if rc <= 0:
            return []
        return buf.value.decode().split("\x1e")

    def num_rows(self) -> int:
        return self._lib.gstore_num_rows(self._h)

    def wal_bytes(self) -> int:
        return self._lib.gstore_wal_bytes(self._h)

    def compact(self) -> bool:
        return self._lib.gstore_compact(self._h) == 0

    def sync(self) -> bool:
        """fdatasync the WAL (OS-crash durability; see module doc)."""
        return self._lib.gstore_sync(self._h) == 0
