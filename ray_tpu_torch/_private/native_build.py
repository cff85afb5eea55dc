"""Build-on-first-use helper for the runtime's native C++ pieces
(`_private/csrc/*.cc` -> `ray_tpu_torch/_build/runtime/*.so`, loaded
through ctypes).

The reference builds its sources from the repo's `src/` into its own
package; the port keeps its own copies beside it and builds them with
g++ into the gitignored `_build/`. A failed build raises: nothing falls
back to a Python copy of a native piece.
"""

from __future__ import annotations

import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

LIB_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "_build", "runtime"))
SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")

# One lock a library: two threads of a process never compile the same
# one twice, and different libraries build side by side (build_all).
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock_for(lib_name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(lib_name, threading.Lock())


def ensure_built(src_name: "str | tuple[str, ...]", lib_name: str,
                 extra_flags: tuple[str, ...] = (),
                 dep_names: tuple[str, ...] = ()) -> str:
    """Compile csrc/<src_name(s)> to _build/runtime/<lib_name> if stale;
    returns the lib path. `dep_names` are non-compiled dependencies
    (headers) that take part in the staleness check only. Compiles to a
    private temp file then os.replace()s: concurrent processes (GCS and
    raylet on a fresh checkout) must never dlopen a half-written .so."""
    names = (src_name,) if isinstance(src_name, str) else tuple(src_name)
    srcs = [os.path.join(SRC_DIR, n) for n in names]
    deps = srcs + [os.path.join(SRC_DIR, n) for n in dep_names]
    lib_path = os.path.join(LIB_DIR, lib_name)
    with _lock_for(lib_name):
        if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= max(
                os.path.getmtime(s) for s in deps):
            return lib_path
        os.makedirs(LIB_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"),
               "-O2", "-Wall", "-fPIC", "-std=c++17", "-shared",
               "-o", tmp, *srcs, *extra_flags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {lib_name} failed ({' '.join(cmd)}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
    return lib_path


def build_all() -> None:
    """Build (and load) every runtime library at once, one g++ each in
    parallel: the GCS and the raylet otherwise build theirs one after
    another at their first start."""
    from ray_tpu_torch._private import (native_actor_plane, native_fastpath,
                                        native_gcs_service, native_gcs_store,
                                        native_lease_plane,
                                        native_raylet_core, native_scheduler,
                                        native_transfer, object_store)

    loaders = (object_store._get_lib, native_scheduler._get_lib,
               native_raylet_core._get_lib, native_gcs_store._get_lib,
               native_gcs_service._load, native_fastpath._load,
               native_actor_plane._load, native_lease_plane._load,
               native_transfer._load)
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
