"""Cluster process bring-up: spawn GCS + raylet daemons, connect drivers.

Parity: reference python/ray/_private/node.py:40 (Node),
node.py:1395 (start_head_processes), services.py:1314 (start_gcs_server),
services.py:1378 (start_raylet).
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
import uuid

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID


def _spawn_with_ready(cmd: list[str], log_path: str, timeout: float = 30.0,
                      env: dict | None = None):
    """Spawn a daemon with a ready-fd pipe; returns (proc, ready_line).
    `env` adds to (or overrides) this process's environment."""
    read_fd, write_fd = os.pipe()
    os.set_inheritable(write_fd, True)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    log_file = open(log_path, "ab")
    proc = subprocess.Popen(
        cmd + [f"--ready-fd={write_fd}"],
        pass_fds=(write_fd,),
        stdout=log_file, stderr=subprocess.STDOUT,
        start_new_session=True,
        env={**os.environ, **env} if env else None)
    log_file.close()
    os.close(write_fd)
    deadline = time.monotonic() + timeout
    buf = b""
    with os.fdopen(read_fd, "rb") as r:
        while time.monotonic() < deadline:
            chunk = r.readline()
            if chunk:
                buf = chunk
                break
            if proc.poll() is not None:
                break
            time.sleep(0.01)
    if not buf:
        proc.kill()
        raise RuntimeError(
            f"daemon failed to start: {' '.join(cmd)}; see {log_path}")
    return proc, buf.decode().strip()


class NodeHandle:
    """A raylet process started by this driver/test (one per simulated node)."""

    def __init__(self, proc, node_id: str, host: str, port: int, store_path: str):
        self.proc = proc
        self.node_id = node_id
        self.host = host
        self.port = port
        self.store_path = store_path

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=5)
        except Exception:
            pass
        # A SIGKILLed raylet never unlinks its arena; do it here so dead
        # clusters don't pin /dev/shm memory.
        import os

        try:
            os.unlink(self.store_path)
        except OSError:
            pass

    def preempt(self):
        """Deliver a platform preemption notice (SIGTERM) to the raylet.
        Its preemption watcher (raylet.main) self-initiates a graceful
        drain with the RAY_TPU_TORCH_PREEMPTION_DEADLINE_S deadline (30s
        default) and exits 0 once DRAINED — the spot/maintenance
        reclaim path, exercised by test_utils.NodePreempter."""
        import signal as _signal

        try:
            self.proc.send_signal(_signal.SIGTERM)
        except Exception:
            pass


class RuntimeNode:
    """Drives head bring-up and node management for one session."""

    def __init__(self, config: Config | None = None):
        self.config = config or Config()
        session_id = uuid.uuid4().hex[:8]
        self.session_dir = os.path.join(self.config.temp_dir, f"session-{session_id}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.gcs_persist_path = os.path.join(self.session_dir,
                                             "gcs_state.msgpack")
        self.gcs_proc = None
        self.gcs_host: str | None = None
        self.gcs_port: int | None = None
        self.nodes: list[NodeHandle] = []
        self._atexit_registered = False

    def start_gcs(self, port: int = 0):
        proc, line = _spawn_with_ready(
            [sys.executable, "-m", "ray_tpu_torch._private.gcs",
             f"--config={self.config.to_json()}",
             f"--port={port}",
             f"--persist={self.gcs_persist_path}"],
            os.path.join(self.session_dir, "logs", "gcs.log"))
        self.gcs_proc = proc
        host, port_s = line.rsplit(":", 1)
        self.gcs_host, self.gcs_port = host, int(port_s)
        self._register_atexit()
        return host, int(port_s)

    def kill_gcs(self):
        """SIGKILL the GCS (fault-injection; reference: GCS FT tests)."""
        if self.gcs_proc is not None:
            try:
                self.gcs_proc.kill()
                self.gcs_proc.wait(timeout=5)
            except Exception:
                pass
            self.gcs_proc = None

    def restart_gcs(self):
        """Restart the GCS on the SAME port with its persisted state
        (reference: GCS restarts with Redis persistence; raylets resync
        via NotifyGCSRestart, node_manager.cc:1168)."""
        assert self.gcs_port, "GCS never started"
        return self.start_gcs(port=self.gcs_port)

    def attach_gcs(self, host: str, port: int):
        self.gcs_host, self.gcs_port = host, port

    def start_raylet(self, resources: dict | None = None, labels: dict | None = None,
                     is_head: bool = False,
                     gcs_addr: tuple[str, int] | None = None,
                     env: dict | None = None) -> NodeHandle:
        """gcs_addr overrides the GCS endpoint this raylet dials — the
        hook chaos tests use to route one node's control-plane traffic
        through a NetChaos proxy. env adds to the raylet's environment
        (CUDA_VISIBLE_DEVICES gives a fake node of one machine its own
        cards)."""
        assert self.gcs_host is not None, "start or attach GCS first"
        gcs_host, gcs_port = gcs_addr or (self.gcs_host, self.gcs_port)
        node_id = NodeID.from_random().hex()
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.raylet",
               f"--gcs-host={gcs_host}", f"--gcs-port={gcs_port}",
               f"--session-dir={self.session_dir}",
               f"--resources={json.dumps(resources or {})}",
               f"--labels={json.dumps(labels or {})}",
               f"--node-id={node_id}"]
        if is_head:
            cmd.append("--head")
        proc, line = _spawn_with_ready(
            cmd, os.path.join(self.session_dir, "logs", f"raylet-{node_id[:8]}.log"),
            env=env)
        host, port, nid, store_path = line.split(":", 3)
        handle = NodeHandle(proc, nid, host, int(port), store_path)
        self.nodes.append(handle)
        return handle

    def _register_atexit(self):
        if not self._atexit_registered:
            atexit.register(self.shutdown)
            self._atexit_registered = True

    def shutdown(self):
        for n in self.nodes:
            n.kill()
        self.nodes.clear()
        if self.gcs_proc is not None:
            try:
                self.gcs_proc.kill()
                self.gcs_proc.wait(timeout=5)
            except Exception:
                pass
            self.gcs_proc = None
