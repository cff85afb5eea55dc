"""The port's Serve (ray_tpu_torch.serve) on the port's runtime.

A TINY paged `LLMServer` (device="cpu") behind `@serve.deployment`, on
f32 weights converted from the flax tree, streams greedy tokens through
a handle and through the HTTP proxy (`POST /<name>?stream=1`), requests
sent together; every stream equals the JAX `LLMEngine`'s greedy tokens
on the same weights, computed in process as tests/test_serve_llm.py
expects them. A plain deployment checks `status` and `delete`. One
cluster for the file. Disaggregated serving, the RPC ingress and config
deploys have their own files (tests/test_torch_disagg_serve.py,
tests/test_torch_serve_config.py).
"""

import concurrent.futures
import http.client
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models.generate import SamplingParams as JSamplingParams  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JEngine  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch._private.config import Config  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.serve.llm import LLMServer  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13, 14, 15, 16]]
N_NEW = 10


@pytest.fixture(scope="module")
def cluster():
    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.object_store_memory = 64 * 1024 * 1024
    ray_tpu_torch.init(num_cpus=4, config=cfg)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def weights():
    """(port config, port params, JAX engine greedy tokens per prompt)."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jparams = jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    eng = JEngine(jcfg, jparams, max_batch=4, max_len=64)
    try:
        handles = [eng.submit(p, JSamplingParams(max_new_tokens=N_NEW))
                   for p in PROMPTS]
        expected = [h.tokens() for h in handles]
    finally:
        eng.shutdown()
    return tcfg, tparams, expected


def _http_stream(port, name, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", f"/{name}?stream=1", body=json.dumps(payload))
        resp = conn.getresponse()
        assert resp.status == 200
        return [json.loads(line)["chunk"]
                for line in resp.read().decode().splitlines() if line]
    finally:
        conn.close()


def test_llm_server_streams_through_handle_and_http(cluster, weights):
    cfg, params, expected = weights

    @serve.deployment
    class TinyLLM(LLMServer):
        def __init__(self):
            super().__init__(cfg, params, max_batch=4, max_len=64,
                             page_size=16, decode_chunk=4, device="cpu")

    handle = serve.run(TinyLLM.bind())
    port = serve.start_http_proxy(port=0)
    payloads = [{"prompt_tokens": p, "max_new_tokens": N_NEW}
                for p in PROMPTS]

    def through_handle(payload):
        return list(handle.options(stream=True).remote(payload))

    with concurrent.futures.ThreadPoolExecutor(len(PROMPTS)) as pool:
        futs = [pool.submit(through_handle, payloads[0]),
                pool.submit(_http_stream, port, "TinyLLM", payloads[1]),
                pool.submit(through_handle, payloads[2]),
                pool.submit(_http_stream, port, "TinyLLM", payloads[3])]
        got = [f.result(timeout=180) for f in futs]
    assert got == expected
    metrics = handle.options(method_name="report_metrics").remote().result(
        timeout=60)
    assert metrics["active_streams"] == 0 and metrics["ttft_p50_ms"] > 0
    serve.delete("TinyLLM")


def test_plain_deployment_status_and_delete(cluster):
    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    handle = serve.run(Echo.bind())
    assert handle.remote(7).result(timeout=60) == {"echo": 7}
    assert serve.status()["Echo"]["num_replicas"] == 1
    serve.delete("Echo")
    assert "Echo" not in serve.status()
