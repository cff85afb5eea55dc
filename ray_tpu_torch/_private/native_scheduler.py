"""ctypes binding for the native cluster-resource scheduler.

The scheduler itself is C++ (csrc/scheduler.cc, built to
ray_tpu_torch/_build/runtime/libtorchsched.so) — the TPU-native equivalent of the
reference's C++ scheduling stack (reference:
src/ray/raylet/scheduling/cluster_resource_scheduler.h:44,
policy/hybrid_scheduling_policy.h, policy/bundle_scheduling_policy.h).
The GCS (actor/PG placement) and raylet (spillback) call into it while
RAY_TPU_TORCH_NATIVE_CONTROL is on (native_policy); with the switch off
they keep their pure-Python paths. A library that does not build or load
raises.
"""

from __future__ import annotations

import ctypes

from ray_tpu_torch._private import native_policy
from ray_tpu_torch._private.native_build import ensure_built

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built("scheduler.cc", "libtorchsched.so"))
        lib.sched_create.restype = ctypes.c_void_p
        lib.sched_destroy.argtypes = [ctypes.c_void_p]
        lib.sched_update_node.restype = ctypes.c_int
        lib.sched_update_node.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.sched_remove_node.restype = ctypes.c_int
        lib.sched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sched_num_nodes.restype = ctypes.c_int
        lib.sched_num_nodes.argtypes = [ctypes.c_void_p]
        lib.sched_debit_node.restype = ctypes.c_int
        lib.sched_debit_node.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.sched_pick_node.restype = ctypes.c_int
        lib.sched_pick_node.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint,
            ctypes.c_char_p, ctypes.c_int]
        lib.sched_schedule_bundles.restype = ctypes.c_int
        lib.sched_schedule_bundles.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def available() -> bool:
    """False only when RAY_TPU_TORCH_NATIVE_CONTROL is off."""
    return native_policy.native_control_on()


# Entries separated by ASCII RS (0x1e), key split on the FIRST '=' — values
# with commas or '=' survive the round-trip (resource/label names must not
# contain RS or '=', which normalize_resources never produces).
_SEP = "\x1e"


def _enc_resources(res: dict | None) -> bytes:
    return _SEP.join(f"{k}={float(v):.10g}"
                     for k, v in (res or {}).items()).encode()


def _enc_labels(labels: dict | None) -> bytes:
    return _SEP.join(f"{k}={v}" for k, v in (labels or {}).items()).encode()


class ClusterScheduler:
    """Cluster node table + placement policies, backed by the C++ core.

    Thread-safe (the C++ side holds its own mutex); callers feed it node
    state (register/heartbeat/death) and ask for placements.
    """

    FALLBACK_TOTAL = 1  # pick_node flag: fall back to total-capacity fit

    def __init__(self):
        lib = _get_lib()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.sched_create())
        self._seed = 0

    def close(self):
        if self._h:
            self._lib.sched_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def update_node(self, node_id: str, total: dict | None = None,
                    available: dict | None = None, labels: dict | None = None,
                    alive: bool = True):
        self._lib.sched_update_node(
            self._h, node_id.encode(),
            None if total is None else _enc_resources(total),
            None if available is None else _enc_resources(available),
            None if labels is None else _enc_labels(labels),
            1 if alive else 0)

    def remove_node(self, node_id: str):
        self._lib.sched_remove_node(self._h, node_id.encode())

    def debit_node(self, node_id: str, demand: dict):
        self._lib.sched_debit_node(self._h, node_id.encode(),
                                   _enc_resources(demand))

    def num_nodes(self) -> int:
        return self._lib.sched_num_nodes(self._h)

    def pick_node(self, demand: dict, strategy: str = "hybrid", *,
                  exclude: str = "", fallback_total: bool = False,
                  seed: int | None = None) -> str | None:
        """strategy: 'hybrid' | 'pack' | 'spread' | 'affinity:<id>:<0|1>'."""
        out = ctypes.create_string_buffer(256)
        if seed is None:
            self._seed = (self._seed + 1) & 0xFFFFFFFF
            seed = self._seed
        rc = self._lib.sched_pick_node(
            self._h, _enc_resources(demand), strategy.encode(),
            exclude.encode(), self.FALLBACK_TOTAL if fallback_total else 0,
            seed, out, len(out))
        return out.value.decode() if rc == 0 else None

    def schedule_bundles(self, bundles: list[dict], strategy: str = "PACK",
                         ici_label_key: str = "tpu-slice"
                         ) -> list[str] | None:
        """Gang placement. Returns node ids in bundle order, or None."""
        enc = b"|".join(_enc_resources(b) for b in bundles)
        out = ctypes.create_string_buffer(64 + 256 * max(1, len(bundles)))
        rc = self._lib.sched_schedule_bundles(
            self._h, enc, strategy.encode(), ici_label_key.encode(),
            out, len(out))
        if rc != 0:
            return None
        return out.value.decode().split(",")
