"""The port's paged LLM engine against the JAX package's, token for token.

Both engines serve the same converted f32 weights on the CPU (the JAX
paged kernel in interpret mode, the port's plain version); greedy output
must be identical, and every page must return to the pool."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models.generate import SamplingParams as JSamplingParams  # noqa: E402
from ray_tpu.serve.llm import LLMEngine as JEngine  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.generate import SamplingParams  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)


@pytest.fixture(scope="module")
def shared():
    """(port config, port params, greedy(prompts, n) from one JAX engine)."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jparams = jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    eng = JEngine(jcfg, jparams, max_batch=4, max_len=96, page_size=16)

    def jax_greedy(prompts, n):
        handles = [eng.submit(p, JSamplingParams(max_new_tokens=n))
                   for p in prompts]
        return [h.tokens() for h in handles]

    yield tcfg, tparams, jax_greedy
    eng.shutdown()


def _serve(eng, prompts, n, **sampling):
    try:
        handles = [eng.submit(p, SamplingParams(max_new_tokens=n, **sampling))
                   for p in prompts]
        outs = [h.tokens() for h in handles]
        assert all(h.error is None for h in handles)
        assert eng._alloc.free_pages == eng._alloc.num_pages - 1  # - dummy
        return outs
    finally:
        eng.shutdown()


def test_concurrent_prompts_of_different_buckets(shared):
    cfg, params, jax_greedy = shared
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(11, 31))]
    eng = LLMEngine(cfg, params, max_batch=3, max_len=96, page_size=16,
                    device="cpu")
    assert _serve(eng, prompts, 10) == jax_greedy(prompts, 10)


def test_burst_goes_through_batched_prefill(shared):
    cfg, params, jax_greedy = shared
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11, 12], [13, 14, 15]]
    eng = LLMEngine(cfg, params, max_batch=4, max_len=96, page_size=16,
                    device="cpu")
    calls = {"many": 0}
    real_many = eng._prefill_many

    def spy_many(*a, **k):
        calls["many"] += 1
        return real_many(*a, **k)

    eng._prefill_many = spy_many
    assert _serve(eng, prompts, 8) == jax_greedy(prompts, 8)
    assert calls["many"] >= 1, "the burst never reached _prefill_many"


def test_admission_bounded_by_pool(shared):
    """Pool of 2 pages, each request needs 1 (prompt 4 + max_new 8 +
    chunk 4 = 16 tokens): requests queue on pool pages, not slots."""
    cfg, params, jax_greedy = shared
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    eng = LLMEngine(cfg, params, max_batch=3, max_len=96, page_size=16,
                    decode_chunk=4, kv_pool_tokens=32, device="cpu")
    assert eng._alloc.num_pages == 3
    assert _serve(eng, prompts, 8) == jax_greedy(prompts, 8)


def test_top_k_1_equals_greedy(shared):
    cfg, params, _ = shared
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    greedy = _serve(LLMEngine(cfg, params, max_batch=2, max_len=96,
                              page_size=16, device="cpu"), prompts, 8)
    sampled = _serve(LLMEngine(cfg, params, max_batch=2, max_len=96,
                               page_size=16, device="cpu", rng_seed=7),
                     prompts, 8, temperature=0.8, top_k=1, top_p=0.9)
    assert sampled == greedy
