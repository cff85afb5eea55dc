"""ctypes binding for the native raylet lease plane (csrc/raylet_lease.cc).

RequestWorkerLease grants and ReturnWorker releases for the simple hot
shape (no strategy, no placement group, no GPU demand, node not
draining, FIFO gate open, idle worker pooled) execute on the raylet pump's epoll thread,
booking resources through the SAME raylet_core the Python raylet uses
so the two grant paths can never double-book.  Worker identity is
arbitrated by the plane's idle-worker mirror: Python pushes idle
workers in (push) and must claim() before assigning one itself.

Everything else — queueing, spillback, worker spawn, placement groups —
falls through per-method to the Python handlers (counted).  Gated by
RAY_TPU_TORCH_NATIVE_CONTROL=1.

Sim mode turns the plane into a native CreateActor responder with full
(sid, rseq) reply-cache semantics — the mock raylet for
`bench.py --actor-churn` and the Python<->native differential replay
test.
"""

from __future__ import annotations

import ctypes
import threading

from ray_tpu_torch._private import native_policy
from ray_tpu_torch._private.native_build import ensure_built

_lib = None
_lib_lock = threading.Lock()

EV_LEASE_GRANTED = "lease_granted"
EV_WORKER_RETURNED = "worker_returned"


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = ensure_built(
            "raylet_lease.cc", "libtorchrlease.so",
            dep_names=("msgpack_lite.h", "generated/contract_gen.h"))
        lib = ctypes.CDLL(path)
        lib.rlease_create.restype = ctypes.c_void_p
        lib.rlease_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.rlease_destroy.argtypes = [ctypes.c_void_p]
        lib.rlease_chain.argtypes = [ctypes.c_void_p] * 4
        lib.rlease_set_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rlease_set_gate.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rlease_set_draining.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rlease_set_sim.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rlease_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64]
        lib.rlease_claim.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rlease_claim.restype = ctypes.c_int
        lib.rlease_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rlease_idle_count.argtypes = [ctypes.c_void_p]
        lib.rlease_idle_count.restype = ctypes.c_int64
        lib.rlease_session_count.argtypes = [ctypes.c_void_p]
        lib.rlease_session_count.restype = ctypes.c_int64
        lib.rlease_counters.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64),
                                        ctypes.POINTER(ctypes.c_uint64),
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.rlease_proto_errors.argtypes = [ctypes.c_void_p]
        lib.rlease_proto_errors.restype = ctypes.c_uint64
        lib.rlease_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rlease_stale_epoch_total.argtypes = [ctypes.c_void_p]
        lib.rlease_stale_epoch_total.restype = ctypes.c_uint64
        lib.rlease_set_node_state.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
        lib.rlease_set_degraded.argtypes = [ctypes.c_void_p,
                                            ctypes.c_char_p, ctypes.c_int]
        lib.rlease_degraded_total.argtypes = [ctypes.c_void_p]
        lib.rlease_degraded_total.restype = ctypes.c_uint64
        lib.rlease_method_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.rlease_restore_lease.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p,
                                             ctypes.c_char_p]
        lib.rlease_native_lease_count.argtypes = [ctypes.c_void_p]
        lib.rlease_native_lease_count.restype = ctypes.c_int64
        _lib = lib
        return lib


def available() -> bool:
    """False only when RAY_TPU_TORCH_NATIVE_CONTROL is off (the Python
    path); a plane that does not build or load raises where it is made."""
    return native_policy.native_control_on()


def _addr(fn) -> int:
    return ctypes.cast(fn, ctypes.c_void_p).value


class RayletLeasePlane:
    """Owns one native lease-plane instance for a raylet pump."""

    def __init__(self, pump, inject_token: int, rcore=None):
        """pump: native_fastpath.FastPump (pre-listen). inject_token:
        token carried by this plane's EV_INJECT events. rcore: a
        native_raylet_core.RayletCore whose try_acquire/release entry
        points book the resources (None => sim/bench mode, grants are
        resource-unchecked)."""
        lib = _load()
        self._lib = lib
        self._pump = pump
        from ray_tpu_torch._private import native_fastpath

        fplib = native_fastpath._load()
        if rcore is not None:
            acquire_addr = _addr(rcore._lib.rcore_try_acquire)
            release_addr = _addr(rcore._lib.rcore_release)
            rcore_h = rcore._h
        else:
            acquire_addr = release_addr = rcore_h = None
        self._h = ctypes.c_void_p(lib.rlease_create(
            _addr(fplib.fpump_send), _addr(fplib.fpump_inject),
            pump._h, inject_token, acquire_addr, release_addr, rcore_h))
        if not self._h:
            raise OSError("rlease_create failed")

    def frame_addr(self) -> int:
        return _addr(self._lib.rlease_on_frame)

    def close_addr(self) -> int:
        return _addr(self._lib.rlease_on_close)

    def handle(self):
        return self._h

    def chain(self, next_frame_addr, next_close_addr, next_ctx) -> None:
        self._lib.rlease_chain(self._h, next_frame_addr,
                               next_close_addr, next_ctx)

    def install(self) -> None:
        self._pump.set_service(self.frame_addr(), self.close_addr(),
                               self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rlease_destroy(self._h)
            self._h = None

    def set_node(self, node_id: str) -> None:
        if self._h:
            self._lib.rlease_set_node(self._h, node_id.encode())

    def set_gate(self, open_: bool) -> None:
        if self._h:
            self._lib.rlease_set_gate(self._h, 1 if open_ else 0)

    def set_draining(self, draining: bool) -> None:
        if self._h:
            self._lib.rlease_set_draining(self._h, 1 if draining else 0)

    def set_sim(self, sim: bool) -> None:
        if self._h:
            self._lib.rlease_set_sim(self._h, 1 if sim else 0)

    def push(self, worker_id: str, host: str, port: int,
             fp_port: int) -> None:
        if self._h:
            self._lib.rlease_push(self._h, worker_id.encode(),
                                  host.encode(), port, fp_port)

    def claim(self, worker_id: str) -> bool:
        """True = worker was pooled here and is now the caller's."""
        if not self._h:
            return True
        return bool(self._lib.rlease_claim(self._h, worker_id.encode()))

    def remove(self, worker_id: str) -> None:
        if self._h:
            self._lib.rlease_remove(self._h, worker_id.encode())

    def idle_count(self) -> int:
        return self._lib.rlease_idle_count(self._h) if self._h else 0

    def session_count(self) -> int:
        return self._lib.rlease_session_count(self._h) if self._h else 0

    def proto_errors(self) -> int:
        return self._lib.rlease_proto_errors(self._h) if self._h else 0

    def counters(self) -> tuple[int, int, int]:
        """(frames handled natively, fallthroughs to Python, deduped)."""
        if not self._h:
            return 0, 0, 0
        handled = ctypes.c_uint64()
        fallthrough = ctypes.c_uint64()
        deduped = ctypes.c_uint64()
        self._lib.rlease_counters(self._h, ctypes.byref(handled),
                                  ctypes.byref(fallthrough),
                                  ctypes.byref(deduped))
        return handled.value, fallthrough.value, deduped.value

    def set_epoch(self, epoch: int) -> None:
        """Install the server incarnation epoch (restart handshake)."""
        if self._h:
            self._lib.rlease_set_epoch(self._h, epoch)

    def stale_epoch_total(self) -> int:
        if not self._h:
            return 0
        return self._lib.rlease_stale_epoch_total(self._h)

    def set_node_state(self, state: int) -> None:
        """Mirror OUR node's GCS ladder rung (native_policy.NODE_*)."""
        if self._h:
            self._lib.rlease_set_node_state(self._h, state)

    def set_degraded(self, method: str, on: bool) -> None:
        """Trip (or clear) the divergence breaker for one method."""
        if self._h:
            self._lib.rlease_set_degraded(self._h, method.encode(),
                                          1 if on else 0)

    def degraded_total(self) -> int:
        return self._lib.rlease_degraded_total(self._h) if self._h else 0

    def method_stats(self, method: str) -> tuple[int, int, int]:
        """(handled, routed, degraded) for one owned method."""
        if not self._h:
            return 0, 0, 0
        h = ctypes.c_uint64()
        r = ctypes.c_uint64()
        d = ctypes.c_uint64()
        self._lib.rlease_method_stats(self._h, method.encode(),
                                      ctypes.byref(h), ctypes.byref(r),
                                      ctypes.byref(d))
        return h.value, r.value, d.value

    def restore_lease(self, lease_id: str, worker_id: str) -> None:
        """Replay one persisted native-lease row (crash rehydration)."""
        if self._h:
            self._lib.rlease_restore_lease(self._h, lease_id.encode(),
                                           worker_id.encode())

    def native_lease_count(self) -> int:
        if not self._h:
            return 0
        return self._lib.rlease_native_lease_count(self._h)
