"""A fake multi-node cluster on one machine. Port of
ray_tpu/cluster_utils.py (reference: python/ray/cluster_utils.py,
Cluster: add_node spawns extra raylets, each with its own object store
and resources, against one GCS; remove_node kills a raylet).

Drains are per node, so this is what makes the drain paths testable on
one host: a decode replica's node preempted mid-stream, an elastic gang
member's node drained mid-run. By default every raylet sees every card
of the machine (on one card, every node's GPU lease pins that card);
add_node(cuda_visible_devices=...) gives a node cards of its own.
"""

from __future__ import annotations

import time

import ray_tpu_torch
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.node import NodeHandle, RuntimeNode


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: dict | None = None,
                 connect: bool = False, config: Config | None = None):
        self._node = RuntimeNode(config)
        self.gcs_address: str | None = None
        self.head_node: NodeHandle | None = None
        self.connected = False
        if initialize_head:
            host, port = self._node.start_gcs()
            self.gcs_address = f"{host}:{port}"
            self.head_node = self.add_node(**(head_node_args or {}),
                                           _head=True)
            if connect:
                self.connect()

    @property
    def address(self) -> str | None:
        """The GCS address (reference: cluster_utils.Cluster.address)."""
        return self.gcs_address

    @property
    def nodes(self) -> list[NodeHandle]:
        return list(self._node.nodes)

    def add_node(self, resources: dict | None = None,
                 num_cpus: float | None = None, labels: dict | None = None,
                 cuda_visible_devices: str | None = None,
                 _head: bool = False) -> NodeHandle:
        """Start one more raylet. `cuda_visible_devices` gives the node
        its own cards (by default every node sees every card of the
        machine): nodes with disjoint cards keep two nodes' GPU leases
        off one card."""
        if self.gcs_address is None:
            host, port = self._node.start_gcs()
            self.gcs_address = f"{host}:{port}"
            _head = True
        res = dict(resources or {})
        if num_cpus is not None:
            res.setdefault("CPU", num_cpus)
        env = None
        if cuda_visible_devices is not None:
            env = {"CUDA_VISIBLE_DEVICES": cuda_visible_devices}
        handle = self._node.start_raylet(resources=res or None, labels=labels,
                                         is_head=_head, env=env)
        if _head and self.head_node is None:
            self.head_node = handle
        return handle

    def remove_node(self, node: NodeHandle, allow_graceful: bool = False) -> None:
        node.kill()
        if node in self._node.nodes:
            self._node.nodes.remove(node)

    def drain_node(self, node: NodeHandle, *, deadline_s: float = 10.0,
                   reason: str = "manual", wait: bool = True) -> dict:
        """Drain one raylet through the GCS (DrainNode with a reason and a
        deadline) and, by default, wait until the node table reports
        DRAINED; remove_node() is then a non-event. Needs a connected
        driver."""
        from ray_tpu_torch._private.api_internal import get_core_worker
        from ray_tpu_torch._private.common import wait_for_drained

        cw = get_core_worker()
        resp = cw._run(cw.gcs.call(
            "DrainNode", {"node_id": node.node_id, "reason": reason,
                          "deadline_s": deadline_s}, timeout=30))
        if wait and resp.get("ok"):
            outcome, me = wait_for_drained(
                ray_tpu_torch.nodes, node.node_id, deadline_s,
                poll_s=0.05, slack_s=15.0)
            resp = dict(resp)
            resp["state"] = (me.get("state") if me else "GONE") \
                if outcome != "DRAINED" else "DRAINED"
        return resp

    def connect(self):
        """Attach this process as the cluster's driver, on the head node's
        raylet."""
        assert self.head_node is not None
        ray_tpu_torch.init(address=self.gcs_address,
                           config=self._node.config)
        self.connected = True
        return self

    def wait_for_nodes(self, num_nodes: int | None = None,
                       timeout: float = 30.0):
        """Block until every started raylet is registered and alive."""
        want = num_nodes if num_nodes is not None else len(self._node.nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
                if len(alive) >= want:
                    return
            except Exception:
                pass
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {want} alive nodes")

    def shutdown(self):
        if self.connected:
            ray_tpu_torch.shutdown()
            self.connected = False
        self._node.shutdown()
