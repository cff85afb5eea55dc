"""Disaggregated serving on the card (ray_tpu_torch/serve/llm_disagg.py):
tests/test_torch_disagg_serve.py's two-pool and drain scenarios at tiny
depth, held against an LLMEngine in this process on the same weights.
Every test here needs a CUDA device and skips without one. The file
imports neither jax nor ray_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_disagg.py

One fake multi-node cluster for the file (ray_tpu_torch.cluster_utils):
the head holds the driver (the router) and the prefill replica, two
nodes with a `decode` resource a decode replica each; every node sees
the card and each replica takes a quarter of it. The KV goes from the
prefill replica's card to a decode replica's by the device plane's ipc
route, never through the router or the host.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

PROMPTS = [[1, 5, 9, 2, 7], [4, 4, 6], [1, 5, 9, 2, 7],
           [1, 5, 9, 2, 7, 3, 8]]
N_NEW, DRAIN_NEW = 10, 24


def _tiny_cfg():
    from ray_tpu_torch.models import llama as tl

    return tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype=torch.float32, attention="reference",
                          remat=False)


@pytest.fixture(scope="module")
def pools():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.serve import llm_disagg
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _tiny_cfg()
    params = init_params(cfg, seed=0, device="cpu")
    eng = LLMEngine(cfg, {k: v.clone() for k, v in params.items()},
                    max_batch=4, max_len=96, page_size=16)
    try:
        from ray_tpu_torch.models import SamplingParams

        want = {}
        for p, n in [(tuple(p), N_NEW) for p in PROMPTS] + [
                ((1, 5, 9, 2, 7), DRAIN_NEW), ((4, 4, 6), DRAIN_NEW)]:
            want[(p, n)] = eng.submit(list(p), SamplingParams(
                max_new_tokens=n)).tokens()
    finally:
        eng.shutdown()
    cluster = Cluster(initialize_head=True, connect=True)
    try:
        nodes = [cluster.add_node(num_cpus=4, resources={"decode": 1})
                 for _ in range(2)]
        cluster.wait_for_nodes()
        h = llm_disagg.deploy_disagg(
            cfg, params, prefill_replicas=1, decode_replicas=2,
            max_batch=2, max_len=96, page_size=16,
            prefill_actor_options={"num_gpus": 0.25},
            decode_actor_options={"num_gpus": 0.25,
                                  "resources": {"decode": 1}})
        yield cluster, nodes, h, want
    finally:
        try:
            serve.shutdown()
        finally:
            cluster.shutdown()


def test_two_pools_on_the_card_hand_over_by_ipc(pools):
    _, _, h, want = pools
    results = [None] * len(PROMPTS)

    def consume(i):
        results[i] = h.generate({"prompt_tokens": PROMPTS[i],
                                 "max_new_tokens": N_NEW})

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results == [want[(tuple(p), N_NEW)] for p in PROMPTS]
    pm = h.pool_metrics()
    assert sum(m["prefix_cache_hits"] for m in pm["prefill"]) > 0
    routes = {k: sum(m["plane_counters"][k] for m in pm["decode"])
              for k in ("ipc", "collective", "host_fallback")}
    assert routes["ipc"] >= len(PROMPTS)  # one packed KV a hand-off
    assert routes["collective"] == routes["host_fallback"] == 0
    assert all(m["kv_handoff_gb_s"] > 0 for m in pm["decode"]
               if m["decode_requests"])
    assert h.stats["resumes"] == 0


def test_decode_drain_on_the_card_loses_no_token(pools):
    from ray_tpu_torch._private import device_objects
    from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition

    cluster, nodes, h, want = pools
    before = device_objects.counters()
    prompts = [[1, 5, 9, 2, 7], [4, 4, 6]]
    gens = [h.stream({"prompt_tokens": p, "max_new_tokens": DRAIN_NEW,
                      "stream_buffer": 4}) for p in prompts]
    got = [[next(g) for _ in range(3)] for g in gens]
    target = {}

    def holder():
        for m in h.pool_metrics()["decode"]:
            if m.get("active_streams", 0) > 0:
                target["node"] = next(n for n in nodes
                                      if n.node_id == m["node_id"])
                return True
        return False

    wait_for_condition(holder, timeout=60)
    res = NodePreempter(cluster, deadline_s=10).preempt(target["node"])
    assert res.get("state") == "DRAINED"
    for i, g in enumerate(gens):
        got[i].extend(g)
    assert got == [want[(tuple(p), DRAIN_NEW)] for p in prompts]
    assert h.stats["evac_resumes"] >= 1
    after = device_objects.counters()
    assert after["evacuated_in"] - before.get("evacuated_in", 0) > 0
