"""The port's disaggregated serving on its runtime (ray_tpu_torch/serve/
llm_disagg.py: PrefillServer, DecodeServer, DisaggHandle,
deploy_disagg), the port of tests/test_serve_disagg.py's two-pool,
autoscaling and drain tests.

One fake multi-node cluster for the file (ray_tpu_torch.cluster_utils):
a head node and two decode nodes with a `decode` resource. The replicas
run the TINY f32 model of tests/test_serve_disagg.py with weights
converted from the flax tree (params_from_flax), on the CPU
(device="cpu"), where every tensor rides the device plane's host route.
Every greedy stream must equal the JAX LLMEngine's tokens on the same
weights, computed in this process.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models.generate import SamplingParams as JSamplingParams  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JEngine  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch._private import device_objects  # noqa: E402
from ray_tpu_torch._private.config import Config  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.serve import llm_disagg  # noqa: E402
from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
PROMPTS = [[1, 5, 9, 2, 7], [4, 4, 6], [1, 5, 9, 2, 7],
           [1, 5, 9, 2, 7, 3, 8]]  # a repeat and an extension: cache hits
N_NEW = 10
DRAIN_NEW = 24
ASC_NEW = 32
ROUTES = ("in_process", "ipc", "collective", "host_fallback")


def _config() -> Config:
    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.num_heartbeats_timeout = 5
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def model():
    """(port config, port params, {(prompt, n_new): the JAX engine's
    greedy tokens})."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jparams = jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    asks = [(tuple(p), N_NEW) for p in PROMPTS] + [
        ((1, 5, 9, 2, 7), DRAIN_NEW), ((4, 4, 6), DRAIN_NEW),
        ((1, 5, 9, 2, 7), ASC_NEW)]
    eng = JEngine(jcfg, jparams, max_batch=4, max_len=96)
    try:
        handles = {a: eng.submit(list(a[0]), JSamplingParams(
            max_new_tokens=a[1])) for a in dict.fromkeys(asks)}
        want = {a: h.tokens() for a, h in handles.items()}
    finally:
        eng.shutdown()
    return tcfg, tparams, want


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # CPU nodes, whatever the host
    c = Cluster(initialize_head=True, connect=True,
                head_node_args={"num_cpus": 4}, config=_config())
    try:
        decode_nodes = [c.add_node(num_cpus=2, resources={"decode": 1})
                        for _ in range(2)]
        c.wait_for_nodes()
        yield c, decode_nodes
    finally:
        try:
            serve.shutdown()
        finally:
            c.shutdown()
            if old is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old


@pytest.fixture(scope="module")
def pools(cluster, model):
    """One prefill replica on the head and a decode replica on each decode
    node, 4-token stream buffers (the drain test parks streams on them)."""
    cfg, params, _ = model
    return llm_disagg.deploy_disagg(
        cfg, params, prefill_replicas=1, decode_replicas=2, max_batch=2,
        max_len=96, stream_buffer=4, device="cpu",
        prefill_actor_options={"num_cpus": 0},
        decode_actor_options={"num_cpus": 0, "resources": {"decode": 1}})


def _routes(counters: dict) -> dict:
    return {k: counters.get(k, 0) for k in ROUTES}


def test_two_pools_match_the_jax_engine(pools, model):
    """Requests sent together: every stream equals the JAX engine's; the
    prefix cache hits; the KV reached each decode replica as a device
    ref that the replica resolved itself (by the host route on the CPU),
    served by the prefill replica, never resolved by the router."""
    _, _, want = model
    router0 = _routes(device_objects.counters())
    results = [None] * len(PROMPTS)

    def consume(i):
        results[i] = pools.generate({"prompt_tokens": PROMPTS[i],
                                     "max_new_tokens": N_NEW})

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert results == [want[(tuple(p), N_NEW)] for p in PROMPTS]
    pm = pools.pool_metrics()
    assert sum(m.get("prefix_cache_hits", 0) for m in pm["prefill"]) > 0
    # One packed KV tensor a hand-off, by the host route on the CPU.
    decode = [_routes(m["plane_counters"]) for m in pm["decode"]]
    assert sum(r["host_fallback"] for r in decode) >= len(PROMPTS)
    assert sum(r["ipc"] + r["collective"] for r in decode) == 0
    served = sum(m["plane_counters"]["host_out"] for m in pm["prefill"])
    assert served >= len(PROMPTS)
    assert _routes(device_objects.counters()) == router0
    assert pools.stats["completed"] == len(PROMPTS)
    assert pools.stats["resumes"] == 0


def test_each_pool_scales_on_its_own_signal(cluster, model):
    """Prefill scales on its replicas' TTFT and keeps its second replica
    (a long downscale delay); decode scales on tokens in flight while
    slow consumers hold its streams (2-token buffers park the slots),
    and returns to one replica once they finish."""
    cfg, params, want = model
    h = llm_disagg.deploy_disagg(
        cfg, params, name="asc", prefill_replicas=1, decode_replicas=1,
        max_batch=4, max_len=96, stream_buffer=2, device="cpu",
        prefill_autoscaling={"min_replicas": 1, "max_replicas": 2,
                             "metric": "ttft_p99_ms", "target_value": 1e-3,
                             "look_back_period_s": 30.0,
                             "upscale_delay_s": 0.0,
                             "downscale_delay_s": 600.0},
        decode_autoscaling={"min_replicas": 1, "max_replicas": 2,
                            "metric": "tokens_in_flight",
                            "target_value": 16.0,
                            "look_back_period_s": 2.0,
                            "upscale_delay_s": 0.0,
                            "downscale_delay_s": 3.0},
        prefill_actor_options={"num_cpus": 0},
        decode_actor_options={"num_cpus": 0})
    try:
        prompt = [1, 5, 9, 2, 7]
        outs = [None] * 6
        release = threading.Event()

        def consume(i):
            acc = []
            for tok in h.stream({"prompt_tokens": prompt,
                                 "max_new_tokens": ASC_NEW}):
                acc.append(tok)
                # Slow until the decode pool has grown: the parked slots
                # keep tokens_in_flight over its target meanwhile.
                time.sleep(0.01 if release.is_set() else 0.1)
            outs[i] = acc

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(len(outs))]
        for t in threads:
            t.start()
        try:
            wait_for_condition(
                lambda: len(h._prefill._get_replicas()) == 2, timeout=120)
            wait_for_condition(
                lambda: len(h._decode._get_replicas()) == 2, timeout=120)
        finally:
            release.set()
        for t in threads:
            t.join(timeout=180)
        assert outs == [want[(tuple(prompt), ASC_NEW)]] * len(outs)
        wait_for_condition(
            lambda: len(h._decode._get_replicas()) == 1, timeout=120)
        assert len(h._prefill._get_replicas()) == 2
    finally:
        serve.delete("asc-prefill")
        serve.delete("asc-decode")


def test_decode_drain_midstream_loses_no_token(cluster, pools, model):
    """Preempting the decode node that holds a stream loses nothing: its
    evacuation preparer snapshots the streams, the drain re-homes them to
    the router (evacuated_in), which replays the tokens the consumer never
    saw and resumes on the other replica: both streams equal the JAX
    engine's, no token dropped or repeated."""
    c, decode_nodes = cluster
    _, _, want = model
    before = device_objects.counters()
    prompts = [[1, 5, 9, 2, 7], [4, 4, 6]]
    gens = [pools.stream({"prompt_tokens": p, "max_new_tokens": DRAIN_NEW})
            for p in prompts]
    got = [[next(g) for _ in range(3)] for g in gens]
    target = {}

    def holder():
        for m in pools.pool_metrics()["decode"]:
            if m.get("active_streams", 0) > 0:
                target["node"] = next(n for n in decode_nodes
                                      if n.node_id == m["node_id"])
                return True
        return False

    wait_for_condition(holder, timeout=60)
    res = NodePreempter(c, deadline_s=10).preempt(target["node"])
    assert res.get("state") == "DRAINED"
    for i, g in enumerate(gens):
        got[i].extend(g)
    assert got == [want[(tuple(p), DRAIN_NEW)] for p in prompts]
    assert pools.stats["evac_resumes"] >= 1
    assert pools.stats["fallback_reprefills"] == 0
    after = device_objects.counters()
    assert after["evacuated_in"] - before.get("evacuated_in", 0) > 0
    # The resume's hand-off left the router as a device ref too: pinned
    # here, resolved by the surviving replica.
    assert after["host_out"] - before.get("host_out", 0) > 0
    assert not [e for e in device_objects.registry().entries()
                if e["key"].startswith("disagg:")]
