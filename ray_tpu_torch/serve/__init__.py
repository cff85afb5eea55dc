"""ray_tpu_torch.serve: model serving with autoscaling replicas.

The port's copy of ray_tpu.serve (parity: reference python/ray/serve —
serve.run api.py:465, @serve.deployment :258, controller, handles,
batching, HTTP proxy). `serve.run` deploys onto the cluster's detached
ServeController; handles route with power-of-two-choices;
`start_http_proxy` exposes deployments over HTTP. A replica asks for
its card through `ray_actor_options={"num_gpus": 1}`, and its lease pins
the worker to that card.

Also the continuous-batching LLM engine (`serve/llm.py`): `LLMEngine`,
and `LLMServer`, which runs unchanged behind `@serve.deployment`;
disaggregated serving (`deploy_disagg`, serve/llm_disagg.py: a prefill
pool and a decode pool under one router); the binary msgpack-RPC
ingress beside HTTP (`start_rpc_proxy`, serve/rpc_ingress.py); and
declarative multi-application deploys (`deploy_config`,
serve/config_deploy.py).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import (
    AutoscalingConfig,
    Deployment,
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
    deployment,
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, RequestHandle

_proxy_server = None


def _get_controller():
    return ServeController.options(
        name=CONTROLLER_NAME, get_if_exists=True, lifetime="detached",
        namespace="serve").remote()


def run(target: Deployment, *, name: str | None = None,
        route_prefix: str | None = None) -> DeploymentHandle:
    """Deploy and return a handle (parity: serve.run api.py:465).

    Deployment-graph composition (parity: python/ray/dag +
    deployment_graph_build.py): bound Deployments appearing in another
    deployment's init args deploy first and arrive as DeploymentHandles —
    `serve.run(Ensemble.bind(ModelA.bind(), ModelB.bind()))` gives the
    Ensemble replicas live handles to A and B.
    """
    controller = _get_controller()
    return _deploy_tree(target, controller, route_prefix)


def _deploy_tree(target: Deployment, controller,
                 route_prefix: str | None = None) -> DeploymentHandle:
    def resolve(a):
        if isinstance(a, Deployment):
            return _deploy_tree(a, controller)  # children get no route
        return a

    init_args = tuple(resolve(a) for a in target._init_args)
    init_kwargs = {k: resolve(v) for k, v in target._init_kwargs.items()}
    cfg = target._config
    asc = None
    if cfg.autoscaling_config is not None:
        asc = dict(cfg.autoscaling_config.__dict__)
    ray_tpu_torch.get(controller.deploy.remote(
        cfg.name,
        serialization.dumps_func(target._target),
        serialization.dumps_func((init_args, init_kwargs)),
        cfg.num_replicas,
        cfg.ray_actor_options,
        asc,
        serialization.dumps_func(cfg.user_config)
        if cfg.user_config is not None else None,
        route_prefix,
    ))
    return DeploymentHandle(cfg.name, controller)


def get_deployment_handle(name: str, *_a, **_k) -> DeploymentHandle:
    return DeploymentHandle(name, _get_controller())


def status() -> dict:
    # Read-only: must not spawn a detached controller as a side effect on
    # clusters where serve was never started.
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace="serve")
    except ValueError:
        return {}
    return ray_tpu_torch.get(controller.list_deployments.remote())


def delete(name: str) -> None:
    ray_tpu_torch.get(_get_controller().delete_deployment.remote(name))


def shutdown() -> None:
    global _proxy_server, _rpc_ingress
    _ProxyHandler._route_poll_stop.set()
    _ProxyHandler._route_poll_started = False
    _ProxyHandler._routes = {}
    _ProxyHandler._routes_ts = 0.0
    if _proxy_server is not None:
        _proxy_server.shutdown()
        _proxy_server = None
    if _rpc_ingress is not None:
        _rpc_ingress.stop()
        _rpc_ingress = None
    for actor, _host, _port in _node_proxies.values():
        try:
            ray_tpu_torch.kill(actor)
        except Exception:
            pass
    _node_proxies.clear()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace="serve")
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """@serve.batch marker (parity: serve/batching.py). Attach batching
    metadata; the handle batches calls into list-of-inputs invocations."""

    def wrap(fn):
        fn._serve_batch = (max_batch_size, batch_wait_timeout_s)
        return fn

    if _fn is not None:
        return wrap(_fn)
    return wrap


class _ProxyHandler(BaseHTTPRequestHandler):
    # Chunked transfer (streaming) is an HTTP/1.1 construct; the stdlib
    # default of HTTP/1.0 would make strict clients read the chunk framing
    # as body bytes.
    protocol_version = "HTTP/1.1"
    handles: dict[str, DeploymentHandle] = {}
    # Route table {prefix: deployment}: pushed by the controller over a
    # held long-poll connection (reference: proxies subscribe to route
    # updates via LongPollClient, long_poll.py:172); a slow TTL pull
    # remains as the bootstrap/fallback path.
    _routes: dict[str, str] = {}
    _routes_ts: float = 0.0
    _ROUTE_TTL = 10.0
    _route_poll_started = False
    _route_poll_stop = threading.Event()
    _route_poll_version = 0

    def log_message(self, *args):  # silence
        pass

    @classmethod
    def _start_route_poll(cls):
        if cls._route_poll_started:
            return
        cls._route_poll_started = True
        # Fresh Event per poll thread: clearing the shared one would
        # resurrect a previous thread still parked in its (up to 30s)
        # blocking get from before shutdown(), leaving two route-poll
        # threads racing against the new serve session.
        stop = threading.Event()
        cls._route_poll_stop = stop

        def loop():
            import time as _time

            while not stop.is_set():
                t0 = _time.monotonic()
                try:
                    # Look up the EXISTING controller only — get_if_exists
                    # creation here would resurrect a detached controller
                    # after serve.shutdown().
                    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME,
                                                   namespace="serve")
                    upd = ray_tpu_torch.get(
                        controller.long_poll.remote(
                            {"routes": cls._route_poll_version}, 10.0),
                        timeout=30)
                except Exception:
                    if stop.wait(1.0):
                        return
                    continue
                if "routes" not in upd and _time.monotonic() - t0 < 1.0:
                    # Instant empty reply: controller's parked-poll slots
                    # exhausted — back off instead of spinning.
                    if stop.wait(0.5):
                        return
                if "routes" in upd:
                    cls._route_poll_version, cls._routes = upd["routes"]
                    cls._routes_ts = _time.monotonic()

        threading.Thread(target=loop, daemon=True,
                         name="proxy-route-poll").start()

    @classmethod
    def _route_table(cls) -> dict[str, str]:
        import time as _time

        cls._start_route_poll()
        now = _time.monotonic()
        if now - cls._routes_ts > cls._ROUTE_TTL:
            try:
                cls._routes = ray_tpu_torch.get(
                    _get_controller().route_table.remote(), timeout=10)
                cls._routes_ts = now
            except Exception:
                pass
        return cls._routes

    def do_POST(self):
        # Route by longest matching route_prefix (reference: proxy_router);
        # falls back to /<deployment-name>.
        path, _, query = self.path.partition("?")
        name = None
        best_len = -1
        for prefix, dep in self._route_table().items():
            if (path == prefix or path.startswith(prefix.rstrip("/") + "/")
                    or prefix == "/") and len(prefix) > best_len:
                name, best_len = dep, len(prefix)
        if name is None:
            name = path.strip("/").split("/")[0]
        handle = self.handles.get(name)
        if handle is None:
            handle = self.handles[name] = get_deployment_handle(name)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b"{}"
        if "stream=1" in query:
            return self._respond_stream(handle, body)
        try:
            payload = json.loads(body) if body else {}
            result = handle.remote(payload).result(timeout=60)
            data = json.dumps({"result": result}).encode()
            self.send_response(200)
        except Exception as e:  # noqa: BLE001
            data = json.dumps({"error": str(e)}).encode()
            self.send_response(500)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_stream(self, handle, body: bytes):
        """Chunked transfer for generator deployments (?stream=1): one JSON
        line per yielded chunk (reference: serve StreamingResponse over the
        uvicorn proxy)."""
        gen = None
        started = False
        try:
            payload = json.loads(body) if body else {}
            gen = handle.options(stream=True).remote(payload)
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonl")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            started = True
            for chunk in gen:
                line = (json.dumps({"chunk": chunk}) + "\n").encode()
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except Exception as e:  # noqa: BLE001
            if started:
                # Headers + chunks already on the wire: a 500 here would
                # inject a status line mid-body. Drop the connection so the
                # client sees a truncated (unterminated) chunked stream.
                self.close_connection = True
            else:
                try:
                    data = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except Exception:
                    pass
        finally:
            # Client disconnect / handler error mid-stream: release the
            # replica-side generator and the router's outstanding count.
            if gen is not None:
                gen.cancel()

    do_GET = do_POST


@ray_tpu_torch.remote(num_cpus=0)
class _ProxyActor:
    """Runs both ingress protocols inside a worker on a specific node:
    HTTP and the binary msgpack-RPC ingress (reference: serve proxies
    serve HTTP and gRPC on every node, serve/_private/proxy.py:13-38;
    handles inside the actor route to replicas cluster-wide)."""

    def __init__(self, port: int):
        from ray_tpu_torch import serve as _serve

        self.port = _serve.start_http_proxy(host="0.0.0.0", port=port)
        self.rpc_port = _serve.start_rpc_proxy(host="0.0.0.0", port=0)

    def address(self) -> int:
        return self.port

    def rpc_address(self) -> int:
        return self.rpc_port

    def healthy(self) -> bool:
        return True


_node_proxies: dict = {}  # node_id -> (actor, host, port)


def start_proxies(port: int = 0) -> dict:
    """One HTTP proxy per alive node (reference: proxies on every node,
    serve/_private/proxy.py + proxy_state). Idempotent reconcile: calling
    again keeps healthy proxies, replaces dead ones, and covers nodes
    added since. Returns {node_id: (host, port)}. port=0 picks an
    ephemeral port per node — required when several raylets share a host
    (fake multi-node)."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    out = {}
    pending = {}
    for n in ray_tpu_torch.nodes():
        if not n.get("alive"):
            continue
        nid = n["node_id"]
        existing = _node_proxies.get(nid)
        if existing is not None:
            actor, host, known_port = existing
            try:
                if ray_tpu_torch.get(actor.healthy.remote(), timeout=15):
                    if known_port is None:
                        # A previous address fetch failed; re-fetch
                        # rather than cache a useless None port forever.
                        known_port = ray_tpu_torch.get(actor.address.remote(),
                                                 timeout=30)
                        _node_proxies[nid] = (actor, host, known_port)
                    out[nid] = (host, known_port)
                    continue
            except Exception:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
                _node_proxies.pop(nid, None)
        actor = _ProxyActor.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=nid)).remote(port)
        # Tracked BEFORE any blocking wait: even if the address fetch
        # below fails, shutdown() can still kill this actor.
        _node_proxies[nid] = (actor, n["host"], None)
        pending[nid] = (actor, n["host"])
    # Addresses collected after ALL spawns: N nodes cost one worker
    # startup of wall clock, not N.
    failed = []
    for nid, (actor, host) in pending.items():
        try:
            p = ray_tpu_torch.get(actor.address.remote(), timeout=120)
        except Exception as e:
            # Don't leave a (actor, host, None) entry that a later call
            # would trust as healthy: kill and forget so the next
            # reconcile replaces the proxy.
            failed.append((nid, e))
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
            _node_proxies.pop(nid, None)
            continue
        _node_proxies[nid] = (actor, host, p)
        out[nid] = (host, p)
    if failed:
        raise RuntimeError(
            f"proxy address fetch failed on nodes {failed}; "
            f"{len(out)} proxies started")
    return out


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000) -> int:
    """HTTP ingress (parity: serve/_private/proxy.py uvicorn proxies;
    stdlib threading server this round). POST /<deployment> with a JSON
    body calls the deployment with that payload."""
    global _proxy_server
    _proxy_server = ThreadingHTTPServer((host, port), _ProxyHandler)
    t = threading.Thread(target=_proxy_server.serve_forever, daemon=True)
    t.start()
    return _proxy_server.server_address[1]


_rpc_ingress = None


def start_rpc_proxy(host: str = "127.0.0.1", port: int = 0) -> int:
    """Binary (msgpack-RPC) ingress beside HTTP, the second protocol
    (reference: the proxy's gRPC listener, serve/_private/proxy.py:13-38).
    See serve/rpc_ingress.py for the wire protocol; RpcIngressClient is
    its caller. Returns the port."""
    global _rpc_ingress
    from ray_tpu_torch.serve.rpc_ingress import RpcIngress

    _rpc_ingress = RpcIngress()
    return _rpc_ingress.start(host, port)


def deploy_config(config):
    """Declarative multi-application deploy (reference: serve's REST
    config, `serve deploy`); see serve/config_deploy.py for the schema."""
    from ray_tpu_torch.serve.config_deploy import deploy_config as _impl

    return _impl(config)


def deploy_disagg(cfg, params, **kwargs):
    """Disaggregated LLM serving: prefill and decode replica pools under
    one router, the KV handed over through the device plane, a prefix
    cache and per-pool autoscaling. See serve/llm_disagg.py."""
    from ray_tpu_torch.serve.llm_disagg import deploy_disagg as _impl

    return _impl(cfg, params, **kwargs)


__all__ = [
    "deployment", "run", "get_deployment_handle", "status", "delete",
    "shutdown", "batch", "start_http_proxy", "start_rpc_proxy",
    "start_proxies", "deploy_config", "deploy_disagg", "Deployment",
    "DeploymentHandle", "DeploymentResponse", "DeploymentResponseGenerator",
    "AutoscalingConfig", "multiplexed", "get_multiplexed_model_id",
    "LLMEngine", "LLMServer", "RequestHandle",
]
