"""The port's `generate` and the engine side of disaggregated serving
(ray_tpu_torch/serve/llm_disagg.py: PrefixCache, PrefillEngine) against
the JAX package's, on the CPU.

Both sides hold the same TINY f32 weights (tests/test_serve_disagg.py's
model, converted with params_from_flax). Tolerances: logits and KV
within 2e-5 (the reference's f32 forward tolerance), greedy tokens
identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models.generate import Generator as JGenerator  # noqa: E402
from ray_tpu.models.generate import SamplingParams as JSamplingParams  # noqa: E402
from ray_tpu.models.generate import generate as jgenerate  # noqa: E402
from ray_tpu.serve.llm_disagg import PrefillEngine as JPrefillEngine  # noqa: E402
from ray_tpu.serve.llm_disagg import PrefixCache as JPrefixCache  # noqa: E402
from ray_tpu_torch.models import Generator, SamplingParams, convert, generate  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.serve import llm_disagg  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine, _Prefilled  # noqa: E402
from ray_tpu_torch.serve.llm_disagg import PrefillEngine, PrefixCache  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
FWD = dict(rtol=2e-5, atol=2e-5)
PROMPT = [1, 5, 9, 2, 7]
EXT = PROMPT + [3, 8, 11, 4]
N_NEW = 10


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jparams = jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    jgen = JGenerator(jcfg, jparams, batch=1, max_len=64)
    wants = {}

    def want(prompt):
        """The JAX Generator's greedy tokens after `prompt`."""
        key = tuple(prompt)
        if key not in wants:
            wants[key] = jgen.generate(
                np.asarray([prompt], np.int32),
                JSamplingParams(max_new_tokens=N_NEW))[0].tolist()
        return wants[key]

    return dict(jcfg=jcfg, jparams=jparams, cfg=tcfg, params=tparams,
                want=want)


def _pack(out):
    return _Prefilled(out["kv"], out["first_token"], out["prompt_len"],
                      out["kv_len"], 0, [], emit_first=True)


def test_generate_gives_the_generators_tokens(tiny):
    """C4: the one-shot wrapper, its bucket the prompt plus max_new_tokens,
    gives the port's Generator's tokens and JAX generate's."""
    prompts = [PROMPT + [2, 2], [4, 4, 6, 2, 9, 1, 3]]
    sp = SamplingParams(max_new_tokens=N_NEW)
    got = generate(tiny["cfg"], tiny["params"], prompts, sp, device="cpu")
    gen = Generator(tiny["cfg"], tiny["params"], batch=2,
                    max_len=7 + N_NEW, device="cpu")
    want = jgenerate(tiny["jcfg"], tiny["jparams"], prompts,
                     JSamplingParams(max_new_tokens=N_NEW))
    assert got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got, gen.generate(prompts, sp))
    np.testing.assert_array_equal(got, want)
    one = generate(tiny["cfg"], tiny["params"], PROMPT, sp, max_len=40,
                   device="cpu")
    assert one[0].tolist() == tiny["want"](PROMPT)


def test_prefix_cache_hit_miss_eviction():
    """tests/test_serve_disagg.py's cases, on host tensors, against the
    reference's cache driven the same way."""
    kv = [(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))]
    logits = torch.zeros(8)
    ours, ref = PrefixCache(max_entries=2), JPrefixCache(max_entries=2)
    steps = [("lookup", [1, 2, 3]), ("insert", [1, 2, 3]),
             ("lookup", [1, 2, 3]), ("lookup", [1, 2, 3, 9, 9]),
             ("insert", [1, 2, 3, 9]), ("lookup", [1, 2, 3, 9, 9]),
             ("lookup", [1, 2, 4]), ("insert", [7, 7, 7])]
    for op, prompt in steps:
        if op == "insert":
            ours.insert(prompt, kv, logits)
            ref.insert(prompt, [(k.numpy(), v.numpy()) for k, v in kv],
                       logits.numpy())
            continue
        (hit, entry), (want_hit, want) = ours.lookup(prompt), \
            ref.lookup(prompt)
        assert hit == want_hit, prompt
        assert (entry and entry["prefix_len"]) == (want and
                                                   want["prefix_len"])
    assert ours.lookup([1, 2, 3])[0] == ref.lookup([1, 2, 3])[0] == "miss"
    assert ours.stats() == ref.stats()
    stats = ours.stats()
    assert stats["entries"] == 2 and stats["evictions"] == 1
    assert stats["hits"] == 3 and stats["misses"] == 3
    assert 0 < stats["hit_rate"] < 1


def _engines(tiny, max_len=96, reference=True):
    """The port's and (unless not `reference`) the reference's
    PrefillEngine, each with its own PrefixCache; the port's prefill
    programs counted."""
    pe = PrefillEngine(tiny["cfg"], tiny["params"], max_len=max_len,
                       device="cpu")
    calls = {"one": 0, "suffix": 0}
    real_one, real_suffix = pe._prefill_one, pe._prefill_suffix

    def count_one(*a):
        calls["one"] += 1
        return real_one(*a)

    def count_suffix(*a):
        calls["suffix"] += 1
        return real_suffix(*a)

    pe._prefill_one, pe._prefill_suffix = count_one, count_suffix
    jpe = JPrefillEngine(tiny["jcfg"], tiny["jparams"], max_len=max_len) \
        if reference else None
    return pe, PrefixCache(8), jpe, JPrefixCache(8), calls


def _hold(out, jout, cache, jcache, prompt):
    """The port's prefill result against the reference's: the same hit,
    first token and KV, and the cached last-position logits within
    2e-5."""
    assert out["prefix_hit"] == jout["prefix_hit"]
    assert out["first_token"] == jout["first_token"]
    assert out["prompt_len"] == out["kv_len"] == len(prompt)
    for (k, v), (jk, jv) in zip(out["kv"], jout["kv"]):
        assert k.shape == (SHAPE["n_kv_heads"], len(prompt), 16)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **FWD)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **FWD)
    entry, jentry = cache.lookup(prompt)[1], jcache.lookup(prompt)[1]
    np.testing.assert_allclose(entry["logits"].numpy(), jentry["logits"],
                               **FWD)


def test_prefills_match_jax_prefill_engine(tiny):
    """A miss, a full hit (no prefill program runs) and a partial hit
    (only the suffix program runs) against the reference engine."""
    pe, cache, jpe, jcache, calls = _engines(tiny)
    sp, jsp = SamplingParams(max_new_tokens=N_NEW), \
        JSamplingParams(max_new_tokens=N_NEW)
    before = dict(llm_disagg.disagg_counts)
    for prompt, hit, want_calls in ((PROMPT, "miss", {"one": 1, "suffix": 0}),
                                    (PROMPT, "full", {"one": 1, "suffix": 0}),
                                    (EXT, "partial", {"one": 1, "suffix": 1})):
        out = pe.prefill(np.asarray(prompt), sp, cache)
        jout = jpe.prefill(np.asarray(prompt), jsp, jcache)
        assert out["prefix_hit"] == hit
        assert calls == want_calls
        _hold(out, jout, cache, jcache, prompt)
    assert cache.stats() == jcache.stats()
    counts = llm_disagg.disagg_counts
    assert counts["prefix_full_hits"] - before["prefix_full_hits"] == 1
    assert counts["prefix_partial_hits"] - before["prefix_partial_hits"] == 1
    # The whole-prompt program's logits, every position of the bucket.
    tokens = np.zeros((1, 16), np.int64)
    tokens[0, :len(EXT)] = EXT
    logits = pe._prefill_one(torch.from_numpy(tokens))
    jlogits, _ = jpe._prefill_one(tiny["jparams"],
                                  jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **FWD)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_handoff_into_the_engines_matches_jax(tiny, mode):
    """The prefill pool's results for a miss, a full hit and a partial hit
    land in the port's dense or paged engine through submit_prefilled and
    decode to the JAX Generator's greedy tokens."""
    pe, cache, _jpe, _jcache, calls = _engines(tiny, reference=False)
    opts = {"page_size": 16, "kv_pool_tokens": 96 * 4} if mode == "paged" \
        else {}
    eng = LLMEngine(tiny["cfg"], tiny["params"], max_batch=2, max_len=96,
                    device="cpu", **opts)
    sp = SamplingParams(max_new_tokens=N_NEW)
    try:
        for prompt, hit in ((PROMPT, "miss"), (PROMPT, "full"),
                            (EXT, "partial")):
            out = pe.prefill(np.asarray(prompt), sp, cache)
            assert out["prefix_hit"] == hit
            assert eng.submit_prefilled(_pack(out), sp).tokens() == \
                tiny["want"](prompt)
    finally:
        eng.shutdown()
    assert calls == {"one": 1, "suffix": 1}


def test_suffix_falls_back_at_the_max_len_guard(tiny):
    """A partial hit whose suffix window [start, start + bucket) would run
    past max_len runs the whole-prompt program instead, as the
    reference's does."""
    pe, cache, jpe, jcache, calls = _engines(tiny, max_len=32)
    sp, jsp = SamplingParams(max_new_tokens=4), JSamplingParams(
        max_new_tokens=4)
    head = [(i * 5 + 1) % 120 for i in range(20)]
    longer = head + [3, 1, 4, 1, 5, 9]   # start 20 + bucket 16 > 32
    for prompt in (head, longer):
        out = pe.prefill(np.asarray(prompt), sp, cache)
        jout = jpe.prefill(np.asarray(prompt), jsp, jcache)
        assert out["prefix_hit"] == "miss"
        _hold(out, jout, cache, jcache, prompt)
    assert calls == {"one": 2, "suffix": 0}


def test_reused_cache_needs_no_zeroing(tiny):
    """The engine's cache keeps an earlier call's rows past each window:
    every query masks them by position, so a cache full of other values
    gives bitwise the results of a fresh engine, for the whole-prompt
    and the suffix program."""
    sp = SamplingParams(max_new_tokens=N_NEW)
    fresh, cache = PrefillEngine(tiny["cfg"], tiny["params"], max_len=96,
                                 device="cpu"), PrefixCache(4)
    want = [fresh.prefill(np.asarray(p), sp, cache) for p in (PROMPT, EXT)]
    used, cache = PrefillEngine(tiny["cfg"], tiny["params"], max_len=96,
                                device="cpu"), PrefixCache(4)
    got = []
    for p in (PROMPT, EXT):
        for k, v in used._kv:   # what a longer earlier prompt would leave
            k.fill_(1e4)
            v.fill_(-3e3)
        got.append(used.prefill(np.asarray(p), sp, cache))
    assert [o["prefix_hit"] for o in got] == ["miss", "partial"]
    for o, w in zip(got, want):
        assert o["first_token"] == w["first_token"]
        for (k, v), (wk, wv) in zip(o["kv"], w["kv"]):
            assert torch.equal(k, wk) and torch.equal(v, wv)
