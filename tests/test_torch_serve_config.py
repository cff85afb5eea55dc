"""The port's declarative Serve deploys (ray_tpu_torch/serve/
config_deploy.py) and its binary msgpack-RPC ingress (serve/
rpc_ingress.py): the ports of tests/test_serve_config.py and
tests/test_serve.py's test_rpc_binary_ingress, on one port cluster for
the file. The deployed graph is tests/torch_serve_test_app.py, the
port's copy of tests/serve_test_app.py.
"""

import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch._private.config import Config  # noqa: E402


@pytest.fixture(scope="module")
def cluster():
    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    ray_tpu_torch.init(num_cpus=4, config=cfg)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture()
def serve_cleanup(cluster):
    yield
    for name in list(serve.status()):
        serve.delete(name)


def test_deploy_config_with_overrides(serve_cleanup):
    handles = serve.deploy_config({
        "applications": [{
            "name": "calc",
            "import_path": "tests.torch_serve_test_app:app",
            "route_prefix": "/calc",
            "deployments": [{"name": "Doubler", "num_replicas": 2}],
        }],
    })
    assert set(handles) == {"calc"}
    assert handles["calc"].remote({"v": 20}).result(timeout=60) == 41
    status = serve.status()
    assert status["Doubler"]["target"] == 2
    assert "Pipeline" in status


def test_deploy_config_bad_import(serve_cleanup):
    with pytest.raises((ImportError, AttributeError, ModuleNotFoundError)):
        serve.deploy_config({"applications": [
            {"import_path": "tests.torch_serve_test_app:nope"}]})
    # Validation comes before any deploy: nothing ran.
    assert serve.status() == {}


def test_deploy_config_validation_and_prune(serve_cleanup):
    from ray_tpu_torch.serve import config_deploy

    from tests import torch_serve_test_app

    base = {"applications": [{
        "name": "calc", "import_path": "tests.torch_serve_test_app:app"}]}
    # A typo'd deployment name errors instead of deploying defaults, as
    # the reference's check does on its own graph.
    bad = {"applications": [{
        "import_path": "tests.torch_serve_test_app:app",
        "deployments": [{"name": "doubler", "num_replicas": 8}]}]}
    with pytest.raises(ValueError, match="unknown deployment"):
        serve.deploy_config(bad)
    # An unknown key errors too.
    bad2 = {"applications": [{
        "import_path": "tests.torch_serve_test_app:app",
        "deployments": [{"name": "Doubler", "replicas": 8}]}]}
    with pytest.raises(ValueError, match="unknown config keys"):
        serve.deploy_config(bad2)
    # An override reaches the child deployment through the bound graph.
    graph = config_deploy._apply_overrides(
        torch_serve_test_app.app, [{"name": "Doubler", "num_replicas": 3}])
    child = graph._init_args[0]
    assert (child.name, child._config.num_replicas) == ("Doubler", 3)
    # Goal-state semantics: a stray deployment vanishes on re-deploy.
    serve.deploy_config(base)

    @serve.deployment
    def stray(p):
        return p

    serve.run(stray.bind())
    assert "stray" in serve.status()
    serve.deploy_config(base)
    assert "stray" not in serve.status()
    assert "Doubler" in serve.status()


def test_rpc_binary_ingress(cluster):
    """The second ingress protocol (reference: the proxy's gRPC listener
    beside HTTP): unary by name and by route prefix, an unknown
    deployment's error on a connection that stays usable, a streaming
    response delivered as per-chunk notifies, and a stream closed
    early."""
    from ray_tpu_torch.serve.rpc_ingress import RpcIngressClient

    @serve.deployment
    def echo(payload):
        return {"echo": payload.get("msg"), "n": payload.get("n", 0) + 1}

    @serve.deployment
    def tokens(payload):
        for i in range(payload.get("count", 3)):
            yield {"tok": i}

    serve.run(echo.bind(), route_prefix="/api/echo")
    serve.run(tokens.bind())
    port = serve.start_rpc_proxy(port=0)
    client = RpcIngressClient("127.0.0.1", port)
    try:
        out = client.call({"msg": "hi", "n": 41}, deployment="echo")
        assert out == {"echo": "hi", "n": 42}
        out = client.call({"msg": "routed"}, route="/api/echo/sub")
        assert out["echo"] == "routed"
        with pytest.raises(RuntimeError):
            client.call({}, deployment="nope-not-here")
        assert client.call({"msg": "still-alive"},
                           deployment="echo")["echo"] == "still-alive"
        chunks = list(client.stream({"count": 4}, deployment="tokens"))
        assert chunks == [{"tok": 0}, {"tok": 1}, {"tok": 2}, {"tok": 3}]
        gen = client.stream({"count": 1000}, deployment="tokens")
        assert next(gen) == {"tok": 0}
        client.close_stream(client.last_stream_id)
        gen.close()
        assert client.call({"msg": "after"}, deployment="echo")["n"] == 1
    finally:
        client.close()
        serve.delete("echo")
        serve.delete("tokens")
