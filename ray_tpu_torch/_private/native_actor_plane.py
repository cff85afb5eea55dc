"""ctypes binding for the native GCS actor plane (csrc/gcs_actor.cc).

The CreateActor ladder's GCS half — RegisterActor intake, round-robin
node pick, stamped CreateActor fan-out with (sid, rseq) at-most-once
across session rebinds, restart bookkeeping, ActorReady commit — runs on
the pump's epoll thread using the graftgen-generated frame validators
and SessionManager (csrc/generated/contract_gen.h).  Python stays the
policy/IO shell: it mirrors state off fpump_inject events and keeps
ownership of every shape the plane routes back (placement groups,
non-CPU resources, detached lifetimes).

Gated by RAY_TPU_TORCH_NATIVE_CONTROL=1 with per-method fallthrough to the
Python handlers; the plane chains in FRONT of the KV/pubsub native
service (gact_chain) so both share one fpump_set_service slot.
"""

from __future__ import annotations

import ctypes
import threading

from ray_tpu_torch._private import native_policy
from ray_tpu_torch._private.native_build import ensure_built

_lib = None
_lib_lock = threading.Lock()

EV_REGISTERED = "registered"
EV_SCHEDULED = "scheduled"
EV_READY = "ready"
EV_RESTARTING = "restarting"
EV_DEAD = "dead"
EV_ORPHANED = "orphaned"


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = ensure_built(
            "gcs_actor.cc", "libtorchgact.so",
            dep_names=("msgpack_lite.h", "generated/contract_gen.h"))
        lib = ctypes.CDLL(path)
        lib.gact_create.restype = ctypes.c_void_p
        lib.gact_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int64]
        lib.gact_destroy.argtypes = [ctypes.c_void_p]
        lib.gact_chain.argtypes = [ctypes.c_void_p] * 4
        lib.gact_node_up.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64]
        lib.gact_node_down.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.gact_actor_forget.argtypes = [ctypes.c_void_p,
                                          ctypes.c_char_p]
        lib.gact_counters.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64)]
        lib.gact_proto_errors.argtypes = [ctypes.c_void_p]
        lib.gact_proto_errors.restype = ctypes.c_uint64
        lib.gact_actor_count.argtypes = [ctypes.c_void_p]
        lib.gact_actor_count.restype = ctypes.c_int64
        lib.gact_session_count.argtypes = [ctypes.c_void_p]
        lib.gact_session_count.restype = ctypes.c_int64
        lib.gact_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gact_stale_epoch_total.argtypes = [ctypes.c_void_p]
        lib.gact_stale_epoch_total.restype = ctypes.c_uint64
        lib.gact_node_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.gact_set_degraded.argtypes = [ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int]
        lib.gact_degraded_total.argtypes = [ctypes.c_void_p]
        lib.gact_degraded_total.restype = ctypes.c_uint64
        lib.gact_method_stats.argtypes = [ctypes.c_void_p,
                                          ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_uint64),
                                          ctypes.POINTER(ctypes.c_uint64),
                                          ctypes.POINTER(ctypes.c_uint64)]
        lib.gact_restore_actor.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint32]
        lib.gact_restore_node.argtypes = [ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int]
        lib.gact_actor_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p, ctypes.c_uint32]
        lib.gact_actor_state.restype = ctypes.c_int
        # gact_on_frame / gact_on_close run on the pump loop thread;
        # Python only needs their addresses.
        _lib = lib
        return lib


def available() -> bool:
    """False only when RAY_TPU_TORCH_NATIVE_CONTROL is off (the Python
    path); a plane that does not build or load raises where it is made."""
    return native_policy.native_control_on()


def _addr(fn) -> int:
    return ctypes.cast(fn, ctypes.c_void_p).value


class GcsActorPlane:
    """Owns one native actor-plane instance for a GCS pump."""

    def __init__(self, pump, inject_token: int):
        """pump: native_fastpath.FastPump (pre-listen). inject_token:
        the token EV_INJECT events from this plane carry (the GCS's
        fast_rpc server routes them to its inject_handler)."""
        lib = _load()
        self._lib = lib
        self._pump = pump
        from ray_tpu_torch._private import native_fastpath

        fplib = native_fastpath._load()
        self._h = ctypes.c_void_p(lib.gact_create(
            _addr(fplib.fpump_send), _addr(fplib.fpump_inject),
            pump._h, inject_token))
        if not self._h:
            raise OSError("gact_create failed")

    def frame_addr(self) -> int:
        return _addr(self._lib.gact_on_frame)

    def close_addr(self) -> int:
        return _addr(self._lib.gact_on_close)

    def handle(self):
        return self._h

    def chain(self, next_frame_addr, next_close_addr, next_ctx) -> None:
        """Forward unowned frames/closes to the next in-pump service."""
        self._lib.gact_chain(self._h, next_frame_addr, next_close_addr,
                             next_ctx)

    def install(self) -> None:
        """Point the pump's in-loop hook at this plane (pre-listen)."""
        self._pump.set_service(self.frame_addr(), self.close_addr(),
                               self._h)

    def close(self) -> None:
        if self._h:
            self._lib.gact_destroy(self._h)
            self._h = None

    def node_up(self, node_id: str, conn_id: int) -> None:
        if self._h:
            self._lib.gact_node_up(self._h, node_id.encode(), conn_id)

    def node_down(self, node_id: str) -> None:
        if self._h:
            self._lib.gact_node_down(self._h, node_id.encode())

    def actor_forget(self, actor_id: str) -> None:
        if self._h:
            self._lib.gact_actor_forget(self._h, actor_id.encode())

    def actor_count(self) -> int:
        return self._lib.gact_actor_count(self._h) if self._h else 0

    def session_count(self) -> int:
        return self._lib.gact_session_count(self._h) if self._h else 0

    def proto_errors(self) -> int:
        return self._lib.gact_proto_errors(self._h) if self._h else 0

    def counters(self) -> tuple[int, int, int]:
        """(frames handled natively, fallthroughs to Python, deduped)."""
        if not self._h:
            return 0, 0, 0
        handled = ctypes.c_uint64()
        fallthrough = ctypes.c_uint64()
        deduped = ctypes.c_uint64()
        self._lib.gact_counters(self._h, ctypes.byref(handled),
                                ctypes.byref(fallthrough),
                                ctypes.byref(deduped))
        return handled.value, fallthrough.value, deduped.value

    def set_epoch(self, epoch: int) -> None:
        """Install the server incarnation epoch (restart handshake)."""
        if self._h:
            self._lib.gact_set_epoch(self._h, epoch)

    def stale_epoch_total(self) -> int:
        return self._lib.gact_stale_epoch_total(self._h) if self._h else 0

    def node_state(self, node_id: str, state: int) -> None:
        """Mirror a death/drain-ladder rung (native_policy.NODE_*)."""
        if self._h:
            self._lib.gact_node_state(self._h, node_id.encode(), state)

    def set_degraded(self, method: str, on: bool) -> None:
        """Trip (or clear) the divergence breaker for one method."""
        if self._h:
            self._lib.gact_set_degraded(self._h, method.encode(),
                                        1 if on else 0)

    def degraded_total(self) -> int:
        return self._lib.gact_degraded_total(self._h) if self._h else 0

    def method_stats(self, method: str) -> tuple[int, int, int]:
        """(handled, routed, degraded) for one owned method."""
        if not self._h:
            return 0, 0, 0
        h = ctypes.c_uint64()
        r = ctypes.c_uint64()
        d = ctypes.c_uint64()
        self._lib.gact_method_stats(self._h, method.encode(),
                                    ctypes.byref(h), ctypes.byref(r),
                                    ctypes.byref(d))
        return h.value, r.value, d.value

    def restore_actor(self, actor_id: str, state: str, restarts: int,
                      max_restarts: int, node_id: str, spec: bytes,
                      resources: bytes = b"") -> None:
        """Replay one persisted actor-table row (crash rehydration)."""
        if self._h:
            self._lib.gact_restore_actor(
                self._h, actor_id.encode(), state.encode(), restarts,
                max_restarts, (node_id or "").encode(), spec, len(spec),
                resources, len(resources))

    def restore_node(self, node_id: str, state: int) -> None:
        """Replay one persisted node-table row (crash rehydration)."""
        if self._h:
            self._lib.gact_restore_node(self._h, node_id.encode(), state)

    def actor_state(self, actor_id: str) -> str | None:
        """Native-side state string for the audit, None if unknown."""
        if not self._h:
            return None
        buf = ctypes.create_string_buffer(32)
        if self._lib.gact_actor_state(self._h, actor_id.encode(), buf,
                                      32) != 1:
            return None
        return buf.value.decode()
