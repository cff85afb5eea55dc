"""The port's runtime on the card: GPU resources and pinning, the CUDA
tensor round trip, and a TINY LLMServer replica on a GPU lease. Every test
here needs a CUDA device and skips without one. The file imports neither
jax nor ray_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_runtime.py

One cluster for the file (ray_tpu_torch.init with 4 CPUs and the cards
the node reports). A task without a GPU lease sees CUDA_VISIBLE_DEVICES
"" and no device; a num_gpus=1 task sees one card, the driver's; no
process of the cluster loads jax, ray_tpu, msgpack or cloudpickle. A bf16
CUDA tensor returned by a GPU task comes back bitwise on the driver's
card; a CUDA tensor sent to a CPU task arrives there as a CPU tensor. A
TINY paged LLMServer (f32) in a num_gpus=1 replica streams, through a
handle and through the HTTP proxy, the tokens of an engine in this
process on the same seeded weights, one request at a time.
"""

import http.client
import json
import os

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu", "msgpack",
          "cloudpickle"}
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(11, 41))]


def _tiny_cfg():
    from ray_tpu_torch.models import llama as tl

    return tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype=torch.float32, attention="reference",
                          remat=False)


@pytest.fixture(scope="module")
def rt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    from ray_tpu_torch import serve

    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_gpu_resource_and_pinning(rt):
    from ray_tpu_torch._private.api_internal import get_core_worker

    assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()

    @rt.remote
    def cpu_task():
        import sys

        return (os.environ["CUDA_VISIBLE_DEVICES"], torch.cuda.device_count(),
                torch.cuda.is_available(),
                sorted({m.split(".")[0] for m in sys.modules} & BANNED))

    @rt.remote(num_gpus=1)
    def gpu_task():
        import sys

        return (os.environ["CUDA_VISIBLE_DEVICES"], torch.cuda.device_count(),
                torch.cuda.get_device_name(0),
                rt.get_runtime_context().get_accelerator_ids()["GPU"],
                sorted({m.split(".")[0] for m in sys.modules} & BANNED))

    cpu, gpu = rt.get([cpu_task.remote(), gpu_task.remote()], timeout=300)
    assert cpu == ("", 0, False, [])
    assert gpu[1] == 1 and gpu[2] == torch.cuda.get_device_name(0)
    assert gpu[3] == [gpu[0]] and gpu[4] == []
    cw = get_core_worker()
    for pkgs in (cw._run(cw.raylet.call("GetState", {}))["loaded_packages"],
                 cw._run(cw.gcs.call("GetClusterStatus", {}))[
                     "loaded_packages"]):
        assert not set(pkgs) & BANNED


def test_cuda_tensor_round_trip(rt):
    def make(device):
        gen = torch.Generator(device=device).manual_seed(3)
        return torch.randn(1 << 21, generator=gen, device=device).to(
            torch.bfloat16)

    @rt.remote(num_gpus=1)
    def on_card():
        return make("cuda")

    @rt.remote
    def on_cpu_worker(t):
        return t.device.type, t.view(torch.int16).sum().item()

    want = make("cuda")
    got = rt.get(on_card.remote(), timeout=300)
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    device, total = rt.get(on_cpu_worker.remote(want), timeout=300)
    assert device == "cpu"
    assert total == want.view(torch.int16).sum().item()


def test_tiny_llm_server_replica_on_a_gpu_lease(rt):
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.generate import SamplingParams
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    cfg = _tiny_cfg()
    opts = dict(max_batch=4, max_len=96, page_size=16, decode_chunk=4)
    eng = LLMEngine(cfg, init_params(cfg, seed=0), **opts)
    try:
        want = [eng.generate(p, SamplingParams(max_new_tokens=12))
                for p in PROMPTS]
    finally:
        eng.shutdown()

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class TinyReplica(LLMServer):
        def __init__(self):
            super().__init__(cfg, init_params(cfg, seed=0), **opts)

        def where(self):
            return (str(self.engine.model.embed.weight.device),
                    os.environ["CUDA_VISIBLE_DEVICES"])

    handle = serve.run(TinyReplica.bind())
    device, visible = handle.options(method_name="where").remote().result(
        timeout=300)
    assert device.startswith("cuda") and visible
    port = serve.start_http_proxy(port=0)
    got = []
    for i, p in enumerate(PROMPTS):
        payload = {"prompt_tokens": p, "max_new_tokens": 12}
        if i % 2:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/TinyReplica?stream=1",
                         body=json.dumps(payload))
            resp = conn.getresponse()
            assert resp.status == 200
            got.append([json.loads(line)["chunk"]
                        for line in resp.read().decode().splitlines()
                        if line])
            conn.close()
        else:
            got.append(list(handle.options(stream=True).remote(payload)))
    assert got == want
    serve.delete("TinyReplica")
