"""Typed runtime config flags with environment override.

Re-design of the reference's RAY_CONFIG X-macro flag system (reference:
src/ray/common/ray_config_def.h — 209 typed flags, env override RAY_<name>,
serialized to every process). Here: a declarative table, `RAY_TPU_TORCH_<NAME>`
env override, and dict (de)serialization so the head node can push one
consistent config to every daemon it spawns.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any

from ray_tpu_torch._private import native_policy

_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclass
class Config:
    # --- object store ---
    # Default arena size; reference sizes plasma from system memory
    # (reference: src/ray/common/ray_config_def.h object_store_memory).
    object_store_memory: int = 256 * 1024 * 1024
    object_store_table_capacity: int = 65536
    # Same-host zero-copy arena reads between co-hosted nodes (one host =
    # one shm domain). Disabling forces every cross-node fetch through
    # the chunked transfer plane (src/transfer.cc) — how real cross-HOST
    # traffic always moves; the object_broadcast_chunked release gate
    # holds a floor on that path.
    same_host_zero_copy: bool = True
    # Objects <= this many bytes are inlined in task replies instead of
    # going through shm (reference: ray_config_def.h
    # max_direct_call_object_size = 100KB).
    max_inline_object_size: int = 100 * 1024
    # Chunk size for node-to-node object transfer (reference:
    # ray_config_def.h:355 object_manager_default_chunk_size = 5 MiB).
    object_transfer_chunk_size: int = 5 * 1024 * 1024

    # --- scheduling ---
    # Worker pool (reference: raylet/worker_pool.cc prestart logic).
    num_workers_soft_limit: int = -1  # -1: default to node CPU count
    # Workers spawned at raylet boot so first leases find a warm pool
    # (interpreter + torch imports cost seconds per worker). 0 disables;
    # -1 = node CPU count.
    prestart_workers: int = 0
    # Fork-server worker factory: one warm template process per node pays
    # the interpreter/site-hook import once; each worker is an os.fork()
    # of it (~10ms) instead of a cold interpreter that imports torch
    # (~seconds). See _private/worker_zygote.py.
    use_worker_zygote: bool = True
    worker_startup_timeout_s: float = 60.0
    worker_lease_timeout_s: float = 30.0
    # Leased-worker reuse window, amortizes scheduling like the reference's
    # worker lease reuse (reference: direct_task_transport.cc OnWorkerIdle).
    idle_worker_keep_s: float = 2.0

    # --- health / failure detection ---
    # (reference: ray_config_def.h:813-819 health check knobs)
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 5.0
    num_heartbeats_timeout: int = 5

    # --- tasks ---
    # Lineage: max bytes of task specs pinned for object reconstruction
    # (reference: task_manager.cc lineage pinning).
    max_lineage_bytes: int = 64 * 1024 * 1024

    # Where object-store arena files live. Empty = auto: /dev/shm when
    # available (tmpfs — mmap writes at memory speed, like plasma), else
    # the session dir (disk-backed, ~10x slower puts).
    object_store_dir: str = ""
    # External spill target ("" = node-local spill dir). URI with a
    # registered external-storage scheme, e.g. "file:///mnt/shared/spill"
    # (reference: object_spilling_config / external_storage.py:72).
    object_spilling_uri: str = ""


    # --- memory monitor (reference: memory_monitor.h:52,
    # worker_killing_policy.h:34) ---
    # Kill workers when system memory usage exceeds this fraction;
    # <= 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_period_s: float = 1.0

    # How long raylets/workers keep retrying to reach a restarting GCS
    # before giving up (reference: raylets survive GCS restarts and resync,
    # node_manager.cc:1168 NotifyGCSRestart).
    gcs_reconnect_timeout_s: float = 60.0

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    rpc_call_timeout_s: float = 120.0
    # Resilient sessions (rpc.connect_session): how long one outage may
    # last before the session — and the caller's on_close — gives up.
    # Daemon->GCS sessions use gcs_reconnect_timeout_s instead; this is
    # the default for everything else (monitor, clients).
    rpc_session_grace_s: float = 30.0

    # --- gcs ---
    task_events_max_buffer: int = 100000

    # --- misc ---
    # Under the process's temp dir (TMPDIR), apart from the reference's
    # sessions so both runtimes can run in one process. NOT a directory
    # named like the package next to a user script (sys.path[0]) would
    # shadow `import ray_tpu_torch`.
    temp_dir: str = os.path.join(tempfile.gettempdir(),
                                 "ray_tpu_torch_sessions")  # RAY_TPU_TORCH_TEMP_DIR
    log_to_driver: bool = True

    @property
    def fastpath(self) -> bool:
        """The native fastpath IO plane (csrc/fastpath.cc): the worker
        task loop and the submitter push/done cycle ride a C++ epoll
        frame pump instead of asyncio (reference analog: the daemons'
        gRPC/asio event loops are C++ end-to-end). On with the native
        control path's one switch, RAY_TPU_TORCH_NATIVE_CONTROL."""
        return native_policy.native_control_on()

    def __post_init__(self):
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                setattr(self, f.name, _parse(env, f.type))

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, payload: str) -> "Config":
        cfg = cls()
        for k, v in json.loads(payload).items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


def _parse(value: str, typ: Any):
    name = typ if isinstance(typ, str) else getattr(typ, "__name__", str(typ))
    if name == "bool":
        return value.lower() in ("1", "true", "yes")
    if name == "int":
        return int(value)
    if name == "float":
        return float(value)
    return value


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
