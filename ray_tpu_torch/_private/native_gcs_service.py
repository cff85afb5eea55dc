"""ctypes binding for the native in-pump GCS service (csrc/gcs_service.cc).

The first slice of daemon PROTOCOL logic in C++: the GCS's namespaced KV
table (KVPut/KVGet/KVDel/KVKeys/KVExists) and pubsub (Subscribe/Publish +
fanout) execute entirely on the fastpath pump's epoll thread — parse,
mutate, WAL write-through, response pack, send — without ever crossing
into Python (reference analog: gcs_kv_manager.cc / pubsub_handler.cc
dispatched on the gcs_server C++ event loop, gcs_server.h:79).

The service is wired by ADDRESS: it receives fpump_send / gstore_put /
gstore_del entry points and the pump/store handles as plain pointers, so
libtorchgsvc.so stays self-contained (no cross-.so linking games).
"""

from __future__ import annotations

import ctypes
import threading

from ray_tpu_torch._private import native_policy
from ray_tpu_torch._private.native_build import ensure_built

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = ensure_built("gcs_service.cc", "libtorchgsvc.so",
                            dep_names=("msgpack_lite.h",))
        lib = ctypes.CDLL(path)
        lib.gsvc_create.restype = ctypes.c_void_p
        lib.gsvc_create.argtypes = [ctypes.c_void_p] * 5
        lib.gsvc_destroy.argtypes = [ctypes.c_void_p]
        lib.gsvc_kv_load.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.gsvc_fanout.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_uint32]
        lib.gsvc_fanout.restype = ctypes.c_int
        lib.gsvc_sub_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.gsvc_sub_count.restype = ctypes.c_int
        lib.gsvc_kv_stats.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.gsvc_counters.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64)]
        lib.gsvc_proto_errors.argtypes = [ctypes.c_void_p]
        lib.gsvc_proto_errors.restype = ctypes.c_uint64
        # gsvc_on_frame / gsvc_on_close are only ever CALLED by the pump
        # loop thread; Python just needs their addresses for
        # fpump_set_service.
        _lib = lib
        return lib


def available() -> bool:
    """False only when RAY_TPU_TORCH_NATIVE_CONTROL is off (the GCS then
    answers KV and pubsub in Python); a service that does not build or
    load raises where it is made."""
    return native_policy.native_control_on()


def _addr(fn) -> int:
    return ctypes.cast(fn, ctypes.c_void_p).value


class GcsNativeService:
    """Owns one native service instance, installed into a FastPump."""

    def __init__(self, pump, store=None):
        """pump: native_fastpath.FastPump (pre-listen).
        store: native_gcs_store.GcsTableStore or None (no persistence).

        Construction does NOT install the pump hook — call install()
        after any restore-time kv_load calls succeed, so a failed
        restore can fall back to the Python handlers without leaving a
        half-loaded native service answering frames."""
        lib = _load()
        self._lib = lib
        self._pump = pump
        from ray_tpu_torch._private import native_fastpath

        fplib = native_fastpath._load()
        if store is not None:
            put_addr = _addr(store._lib.gstore_put)
            del_addr = _addr(store._lib.gstore_del)
            store_h = store._h
        else:
            put_addr = del_addr = store_h = None
        self._h = ctypes.c_void_p(lib.gsvc_create(
            _addr(fplib.fpump_send), pump._h, put_addr, del_addr, store_h))
        if not self._h:
            raise OSError("gsvc_create failed")

    def frame_addr(self) -> int:
        return _addr(self._lib.gsvc_on_frame)

    def close_addr(self) -> int:
        return _addr(self._lib.gsvc_on_close)

    def install(self) -> None:
        """Point the pump's in-loop hook at this service (pre-listen)."""
        self._pump.set_service(self.frame_addr(), self.close_addr(),
                               self._h)

    def close(self) -> None:
        if self._h:
            self._lib.gsvc_destroy(self._h)
            self._h = None

    def kv_load(self, ns: str, key_slice: bytes, val_slice: bytes) -> None:
        if not self._h:
            return
        nsb = ns.encode()
        self._lib.gsvc_kv_load(self._h, nsb, len(nsb), key_slice,
                               len(key_slice), val_slice, len(val_slice))

    def fanout(self, channel: str, frame: bytes) -> int:
        if not self._h:
            return 0
        ch = channel.encode()
        return self._lib.gsvc_fanout(self._h, ch, len(ch), frame,
                                     len(frame))

    def sub_count(self, channel: str) -> int:
        if not self._h:
            return 0
        ch = channel.encode()
        return self._lib.gsvc_sub_count(self._h, ch, len(ch))

    def kv_stats(self) -> tuple[int, int]:
        if not self._h:
            return 0, 0
        n_ns = ctypes.c_int64()
        n_rows = ctypes.c_int64()
        self._lib.gsvc_kv_stats(self._h, ctypes.byref(n_ns),
                                ctypes.byref(n_rows))
        return n_ns.value, n_rows.value

    def proto_errors(self) -> int:
        if not self._h:
            return 0
        return self._lib.gsvc_proto_errors(self._h)

    def counters(self) -> tuple[int, int, int]:
        """(frames handled natively, WAL appends, WAL failures)."""
        if not self._h:
            return 0, 0, 0
        handled = ctypes.c_uint64()
        appends = ctypes.c_uint64()
        failures = ctypes.c_uint64()
        self._lib.gsvc_counters(self._h, ctypes.byref(handled),
                                ctypes.byref(appends),
                                ctypes.byref(failures))
        return handled.value, appends.value, failures.value
