"""ctypes bindings for the native object-transfer plane (csrc/transfer.cc).

The server half runs inside the raylet process (one thread per peer
connection, payload bytes served straight out of the shm arena); the
fetch half pulls a peer's object directly into the local arena. Python
only initiates transfers — no object byte ever crosses the interpreter
(reference: src/ray/object_manager/ push/pull managers are likewise
native, with gRPC streaming instead of this fixed framing).
"""

from __future__ import annotations

import ctypes

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ray_tpu_torch._private.native_build import ensure_built

    path = ensure_built(("transfer.cc", "object_store.cc"),
                        "libtorchtransfer.so", ("-lpthread",))
    lib = ctypes.CDLL(path)
    lib.transfer_server_start.restype = ctypes.c_void_p
    lib.transfer_server_start.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.transfer_server_stop.restype = None
    lib.transfer_server_stop.argtypes = [ctypes.c_void_p]
    lib.transfer_fetch.restype = ctypes.c_int
    lib.transfer_fetch.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_char_p]
    lib.transfer_fetch_multi.restype = ctypes.c_int
    lib.transfer_fetch_multi.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
    _lib = lib
    return lib


class TransferServer:
    """Serves this node's store to peers. A server that does not build or
    start raises: pulls would otherwise fall back to RPC unnoticed."""

    def __init__(self, store_path: str):
        lib = _load()
        out_port = ctypes.c_int(0)
        handle = lib.transfer_server_start(store_path.encode(),
                                           ctypes.byref(out_port))
        if not handle:
            raise OSError(f"transfer server failed to start on {store_path}")
        self._handle = handle
        self.port = out_port.value

    def stop(self):
        if self._handle is not None:
            try:
                _load().transfer_server_stop(self._handle)
            except Exception:
                pass
            self._handle = None
            self.port = 0


def fetch(store_path: str, host: str, port: int, oid_bytes: bytes) -> int:
    """Blocking native pull (run it in an executor). Returns 0 on success,
    <0 on failure (see transfer.cc)."""
    lib = _load()
    return lib.transfer_fetch(store_path.encode(), host.encode(), port,
                              oid_bytes)


def fetch_multi(store_path: str, peers: list, oid_bytes: bytes) -> int:
    """Blocking native pull striping chunks across several peers
    ([(host, port), ...]); large objects fan out over parallel
    connections (transfer.cc stripe workers + pull admission)."""
    lib = _load()
    csv = ",".join(f"{h}:{p}" for h, p in peers)
    return lib.transfer_fetch_multi(store_path.encode(), csv.encode(),
                                    oid_bytes)
