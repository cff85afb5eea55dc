"""Pluggable external storage for object spilling.

Parity: reference python/ray/_private/external_storage.py:72 — spilled
objects can go to local disk OR an external URI store (the reference
ships filesystem + smart_open/S3 backends). Here: a scheme registry with
a filesystem backend built in; cloud schemes plug in via
register_scheme() (the zero-egress image carries no cloud SDKs, so S3 et
al. are deployment-provided plugins rather than bundled code).

Backend contract (all blocking; callers run them in executors):
  put(key: str, data: bytes) -> uri str
  get(uri: str) -> bytes            (FileNotFoundError if gone)
  delete(uri: str) -> None
"""

from __future__ import annotations

import os
from typing import Callable

_SCHEMES: dict[str, Callable[[str], "ExternalStorage"]] = {}


def register_scheme(scheme: str,
                    factory: Callable[[str], "ExternalStorage"]) -> None:
    """Register a URI scheme (e.g. "s3") -> backend factory taking the
    full base URI (reference: external storage configured by URI in
    object_spilling_config)."""
    _SCHEMES[scheme] = factory


class ExternalStorage:
    """Base class: see module docstring for the contract."""

    def put(self, key: str, data: bytes) -> str:
        raise NotImplementedError

    def get(self, uri: str) -> bytes:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """file:// backend — any mounted filesystem (NFS/FUSE-mounted buckets
    included, the common TPU-pod pattern for shared storage)."""

    def __init__(self, base_uri: str):
        self.root = base_uri[len("file://"):] if base_uri.startswith(
            "file://") else base_uri
        os.makedirs(self.root, exist_ok=True)

    def put(self, key: str, data: bytes) -> str:
        path = os.path.join(self.root, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return "file://" + path

    def get(self, uri: str) -> bytes:
        with open(uri[len("file://"):], "rb") as f:
            return f.read()

    def delete(self, uri: str) -> None:
        try:
            os.unlink(uri[len("file://"):])
        except OSError:
            pass


register_scheme("file", FileSystemStorage)


def storage_for(base_uri: str) -> ExternalStorage:
    """Backend for a base URI like "file:///mnt/spill" or "s3://bucket/p"
    (the latter requires a registered plugin scheme)."""
    scheme = base_uri.split("://", 1)[0] if "://" in base_uri else "file"
    factory = _SCHEMES.get(scheme)
    if factory is None:
        raise ValueError(
            f"no external-storage backend registered for scheme "
            f"{scheme!r} (register_scheme); available: {sorted(_SCHEMES)}")
    return factory(base_uri)
