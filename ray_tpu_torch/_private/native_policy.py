"""Declared fallthrough policy for every natively-handled method, and
the switches of the native control path.

This is the breaker table the divergence audit drives: when
the native↔Python mirror audit detects divergence (or a proto-error
burst), the affected methods are degraded — new (sid, rseq) instances
route to the Python handler (counted `native_degraded_total`) instead of
being served potentially-wrong native answers.

Keys are wire-contract method names. Every method a native plane owns
carries a `// graftgen: native-handler <Method>` marker at its dispatch
branch in csrc/gcs_actor.cc / csrc/raylet_lease.cc; a test checks the
markers against this table in BOTH directions, so the breaker can never
drift from the sources: an owned method without a declared policy (or a
stale entry here) fails tier-1.

Values document HOW the method falls back; the audit uses the key set.

One switch, default on as the reference's native path is:
RAY_TPU_TORCH_NATIVE_CONTROL=0 gives the Python control path, with the
daemons on the asyncio RPC server, the workers on the asyncio task loop,
and no actor or lease plane, in-pump GCS service or native scheduler.
The switch on never falls back: a native piece that does not build or
load raises.
"""

import os


def _switch(name: str) -> bool:
    return os.environ.get(name, "1").lower() not in ("0", "false", "no")


def native_control_on() -> bool:
    """RAY_TPU_TORCH_NATIVE_CONTROL (default on)."""
    return _switch("RAY_TPU_TORCH_NATIVE_CONTROL")


# method -> fallthrough/breaker policy (human-audited, G2-enforced)
NATIVE_FALLTHROUGH_POLICY = {
    "RegisterActor": (
        "gcs actor plane: complex shapes (name/pg/strategy/get_if_exists/"
        "non-simple resources) route per-request; breaker degrades ALL "
        "new registrations to handle_register_actor"),
    "ActorReady": (
        "gcs actor plane: unknown-actor frames route per-request; "
        "breaker degrades to handle_actor_ready (mirror stays "
        "authoritative)"),
    "RequestWorkerLease": (
        "raylet lease plane: complex resources, a GPU demand, "
        "draining/suspect node, closed gate or empty pool route "
        "per-request; breaker degrades to handle_request_worker_lease. "
        "A GPU lease always routes: the worker must learn its cards "
        "(SetLeaseDevices) before the grant, and the Python handler takes "
        "them from the native core's card free list"),
    "ReturnWorker": (
        "raylet lease plane: non-native leases route per-request; "
        "breaker degrades to handle_return_worker"),
    "CreateActor": (
        "raylet lease plane SIM MODE ONLY (bench/differential tests); "
        "production raylets route CreateActor to handle_create_actor, "
        "and the breaker forces that for sim too"),
}

# Node states mirrored into the native planes' cluster view (fault-aware
# scheduling). Values are the wire encoding shared by the
# Python daemons and the C structs (gcs_actor.cc Node.state).
NODE_ALIVE = 0
NODE_SUSPECT = 1
NODE_DRAINING = 2
NODE_DEAD = 3
