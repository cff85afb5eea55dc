"""ctypes binding for the native raylet local-resource core.

The core is C++ (csrc/raylet_core.cc, built to
ray_tpu_torch/_build/runtime/libtorchrcore.so) — the TPU-native equivalent of the
reference raylet's resource accounting stack (reference:
src/ray/raylet/local_task_manager.cc lease acquisition,
scheduling/local_resource_manager.h,
placement_group_resource_manager.h, and the blocked-worker release in
node_manager.cc). The Python raylet is the IO shell; every node-local
accounting decision (lease acquire/release, blocked-worker credit,
bundle 2PC pools) lands in this library.

Unlike the cluster scheduler (which keeps a Python path behind
RAY_TPU_TORCH_NATIVE_CONTROL=0), this core is REQUIRED: the raylet has
no duplicate Python accounting path, so the two can never drift. The
library auto-compiles on first use (native_build), same as the object
store.

The port's core also keeps the node's GPU card free list: a lease with a
GPU demand draws distinct cards (whole cards for a demand of 1 or more,
a best-fit share of one card below 1), `gpu_ids(lease_id)` names them
so the worker can pin CUDA_VISIBLE_DEVICES, and a blocked worker keeps
its cards.
"""

from __future__ import annotations

import ctypes

from ray_tpu_torch._private.native_build import ensure_built

_lib = None

_SEP = "\x1e"


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built("raylet_core.cc", "libtorchrcore.so"))
        lib.rcore_create.restype = ctypes.c_void_p
        lib.rcore_create.argtypes = [ctypes.c_char_p]
        lib.rcore_create_with_cards.restype = ctypes.c_void_p
        lib.rcore_create_with_cards.argtypes = [ctypes.c_char_p,
                                                ctypes.c_char_p]
        lib.rcore_destroy.argtypes = [ctypes.c_void_p]
        for name, args in (
                ("rcore_try_acquire", [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int]),
                ("rcore_release", [ctypes.c_void_p, ctypes.c_char_p]),
                ("rcore_block", [ctypes.c_void_p, ctypes.c_char_p]),
                ("rcore_unblock", [ctypes.c_void_p, ctypes.c_char_p]),
                ("rcore_pg_prepare", [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_char_p]),
                ("rcore_pg_commit", [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]),
                ("rcore_pg_return", [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]),
                ("rcore_available", [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]),
                ("rcore_gpu_ids", [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]),
                ("rcore_num_leases", [ctypes.c_void_p]),
                ("rcore_num_bundles", [ctypes.c_void_p]),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _enc(res: dict | None) -> bytes:
    return _SEP.join(f"{k}={float(v):.10g}"
                     for k, v in (res or {}).items()).encode()


class RayletResourceCore:
    """Node-local resource pool + PG bundle pools + lease records + GPU
    card free list.

    Thread-safe (C++ mutex). Lease ids are caller-chosen strings; the
    core records which pool each lease drew from, so release/block/
    unblock need only the id.
    """

    def __init__(self, total_resources: dict,
                 gpu_ids: list[str] | None = None):
        """gpu_ids names the node's cards in order (as many cards as
        whole GPUs in the total; the rest are named by index)."""
        self._lib = _get_lib()
        self._h = ctypes.c_void_p(self._lib.rcore_create_with_cards(
            _enc(total_resources), _SEP.join(gpu_ids or []).encode()))

    def close(self):
        if self._h:
            self._lib.rcore_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def try_acquire(self, lease_id: str, resources: dict,
                    pg_id: str = "", bundle_index: int = -1) -> bool:
        """True if acquired (recorded under lease_id). False on no-fit
        AND on missing/uncommitted bundle (callers queue either way)."""
        if not self._h:  # closed: refuse rather than deref a freed pool
            return False
        return self._lib.rcore_try_acquire(
            self._h, lease_id.encode(), _enc(resources), pg_id.encode(),
            bundle_index) == 1

    def release(self, lease_id: str) -> None:
        if not self._h:
            return
        self._lib.rcore_release(self._h, lease_id.encode())

    def block(self, lease_id: str) -> bool:
        if not self._h:
            return False
        return self._lib.rcore_block(self._h, lease_id.encode()) == 1

    def unblock(self, lease_id: str) -> bool:
        if not self._h:
            return False
        return self._lib.rcore_unblock(self._h, lease_id.encode()) == 1

    def pg_prepare(self, pg_id: str, bundle_index: int,
                   resources: dict) -> bool:
        return self._lib.rcore_pg_prepare(
            self._h, pg_id.encode(), bundle_index, _enc(resources)) == 1

    def pg_commit(self, pg_id: str, bundle_index: int) -> bool:
        return self._lib.rcore_pg_commit(
            self._h, pg_id.encode(), bundle_index) == 0

    def pg_return(self, pg_id: str, bundle_index: int) -> list[str] | None:
        """Drop the bundle; returns lease_ids still held against it (the
        caller kills those workers), or None if the bundle was unknown.

        -2 from the C side means the output buffer was too small (the
        bundle is left UNTOUCHED in that case) — retry bigger rather
        than conflating it with 'unknown bundle' and leaking the
        reservation."""
        size = 16384
        while True:
            out = ctypes.create_string_buffer(size)
            rc = self._lib.rcore_pg_return(
                self._h, pg_id.encode(), bundle_index, out, len(out))
            if rc == -2:
                size *= 4
                continue
            if rc < 0:
                return None
            s = out.value.decode()
            return [x for x in s.split(_SEP) if x] if s else []

    def available(self) -> dict:
        """Node-pool availability snapshot (floats, may be negative)."""
        out = ctypes.create_string_buffer(8192)
        rc = self._lib.rcore_available(self._h, out, len(out))
        if rc < 0:
            return {}
        res = {}
        for part in out.value.decode().split(_SEP):
            if "=" in part:
                k, v = part.split("=", 1)
                res[k] = float(v)
        return res

    def gpu_ids(self, lease_id: str) -> list[str]:
        """The card ids a lease holds, in card order."""
        if not self._h:
            return []
        size = 256
        while True:
            out = ctypes.create_string_buffer(size)
            rc = self._lib.rcore_gpu_ids(self._h, lease_id.encode(), out,
                                         len(out))
            if rc == -2:
                size *= 4
                continue
            s = out.value.decode()
            return s.split(_SEP) if s else []

    def num_leases(self) -> int:
        return self._lib.rcore_num_leases(self._h)

    def num_bundles(self) -> int:
        return self._lib.rcore_num_bundles(self._h)
