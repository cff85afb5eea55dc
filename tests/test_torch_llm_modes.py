"""The port's dense engine, chunked prefill and drain/resume against the
JAX package's engine, token for token.

Both sides serve the same converted f32 weights on the CPU. Tolerance:
greedy tokens identical (f32 weights); the per-row cache offsets of the
model's dense branch give logits within 2e-5 of the JAX model vmapped
over rows (the reference's f32 forward tolerance). A drain quiesces
streams parked on a 4-token buffer, snapshots them and resumes them in
a second engine through submit_prefilled: the consumer's tokens (those
it read, then the history it never received, then the resumed stream)
must equal the uninterrupted stream, and every page of a paged engine
must return to its pool."""

import time
from types import SimpleNamespace

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
from ray_tpu_torch.serve.llm import LLMEngine, _Prefilled  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
MODES = {"dense": {}, "paged": {"page_size": 16}}
LONG_PROMPT = [(i * 7 + 3) % 120 for i in range(27)]  # 4 chunks of 8
OVERRUN_PROMPT = [(i * 11 + 2) % 120 for i in range(60)]


@pytest.fixture(scope="module")
def shared():
    """Port config and params, and one set of JAX engines on the same
    weights: `greedy(prompts, n, engine)` serves prompts concurrently."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="reference",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="reference")
    jparams = jax.jit(jl.LlamaModel(jcfg).init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32))
    tparams = convert.params_from_flax(jax.device_get(jparams), tcfg)
    engines = {
        "dense": JEngine(jcfg, jparams, max_batch=3, max_len=96),
        "chunked": JEngine(jcfg, jparams, max_batch=2, max_len=96,
                           decode_chunk=4, prefill_chunk=8),
        "overrun": JEngine(jcfg, jparams, max_batch=1, max_len=96,
                           decode_chunk=4, prefill_chunk=50),
        "drain": JEngine(jcfg, jparams, max_batch=2, max_len=96,
                         stream_buffer=4),
    }

    def greedy(prompts, n, engine="dense"):
        handles = [engines[engine].submit(p, JSamplingParams(max_new_tokens=n))
                   for p in prompts]
        return [h.tokens() for h in handles]

    yield SimpleNamespace(jcfg=jcfg, jparams=jparams, cfg=tcfg,
                          params=tparams, greedy=greedy, engines=engines)
    for eng in engines.values():
        eng.shutdown()


def _engine(shared, mode="dense", **kw):
    return LLMEngine(shared.cfg, shared.params, max_len=96, device="cpu",
                     **MODES[mode], **kw)


def _wait(cond, what: str, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _pages_returned(eng):
    if eng.page_size:
        _wait(lambda: eng._alloc.free_pages == eng._alloc.num_pages - 1,
              "KV pages to return")  # - the dummy page


def _count_calls(eng, name: str) -> dict:
    calls = {"n": 0}
    real = getattr(eng, name)

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    setattr(eng, name, spy)
    return calls


def test_per_row_cache_offsets_match_jax_vmap(shared):
    """One decode step, each row writing at its own offset (the last one
    past the cache, clamped to its final row): logits and caches as the
    JAX model vmapped over rows gives them."""
    rng = np.random.default_rng(0)
    B, L = 3, 32
    Hkv, D = SHAPE["n_kv_heads"], SHAPE["d_model"] // SHAPE["n_heads"]
    caches = [(rng.standard_normal((B, Hkv, L, D), np.float32),
               rng.standard_normal((B, Hkv, L, D), np.float32))
              for _ in range(SHAPE["n_layers"])]
    lens = np.array([0, 7, 40], np.int32)
    tokens = rng.integers(0, SHAPE["vocab_size"], B).astype(np.int32)
    model = jl.LlamaModel(shared.jcfg)

    def one(tok, pos, kv, length):
        c = [(k[None], v[None], length) for k, v in kv]
        logits, new = model.apply(shared.jparams, tok[None, None],
                                  pos[None, None], kv_caches=c)
        return logits[0, 0], [(k[0], v[0]) for k, v, _l in new]

    want, want_kv = jax.vmap(one)(jnp.asarray(tokens), jnp.asarray(lens),
                                  [(jnp.asarray(k), jnp.asarray(v))
                                   for k, v in caches], jnp.asarray(lens))
    tmodel = tl.LlamaModel.from_params(shared.cfg, shared.params,
                                       torch.device("cpu"))
    tcaches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                torch.from_numpy(lens)) for k, v in caches]
    pos = torch.from_numpy(lens).long()[:, None]
    with torch.no_grad():
        got, got_kv = tmodel(torch.from_numpy(tokens).long()[:, None], pos,
                             kv_caches=tcaches)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for (k, v, length), (wk, wv) in zip(got_kv, want_kv):
        np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=2e-5,
                                   atol=2e-5)
        assert length.tolist() == (lens + 1).tolist()


def test_dense_concurrent_prompts_of_different_buckets(shared):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(11, 31))]
    eng = _engine(shared, max_batch=3)
    try:
        got = [h.tokens() for h in
               [eng.submit(p, SamplingParams(max_new_tokens=10))
                for p in prompts]]
    finally:
        eng.shutdown()
    assert got == shared.greedy(prompts, 10)


def test_dense_admission_mid_flight(shared):
    """A request admitted while another stream decodes."""
    first, second = [3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9, 7]
    eng = _engine(shared, max_batch=2, decode_chunk=4)
    try:
        h1 = eng.submit(first, SamplingParams(max_new_tokens=24))
        it = iter(h1)
        head = [next(it) for _ in range(5)]
        h2 = eng.submit(second, SamplingParams(max_new_tokens=12))
        got = [head + list(it), h2.tokens()]
    finally:
        eng.shutdown()
    assert got == [shared.greedy([first], 24)[0],
                   shared.greedy([second], 12)[0]]


def test_chunked_prefill_beside_short_stream(shared):
    """A 27-token prompt prefills in 4 chunks of 8 while a short stream
    decodes."""
    prompts = [[5, 6], LONG_PROMPT]
    eng = _engine(shared, max_batch=2, decode_chunk=4, prefill_chunk=8)
    chunks = _count_calls(eng, "_advance_prefill")
    try:
        h_short = eng.submit(prompts[0], SamplingParams(max_new_tokens=20))
        h_long = eng.submit(prompts[1], SamplingParams(max_new_tokens=10))
        got = [h_short.tokens(), h_long.tokens()]
    finally:
        eng.shutdown()
    assert chunks["n"] == 4
    want = [shared.greedy([prompts[0]], 20, "chunked")[0],
            shared.greedy([prompts[1]], 10, "chunked")[0]]
    assert got == want


def test_chunked_prefill_grid_overrun_falls_back(shared):
    """ceil(60 / 50) * 50 = 100 > max_len 96: a chunk would write past the
    cache, so the whole prompt prefills at once."""
    eng = _engine(shared, max_batch=1, decode_chunk=4, prefill_chunk=50)
    chunks = _count_calls(eng, "_advance_prefill")
    try:
        got = eng.generate(OVERRUN_PROMPT, SamplingParams(max_new_tokens=8))
    finally:
        eng.shutdown()
    assert chunks["n"] == 0
    assert got == shared.greedy([OVERRUN_PROMPT], 8, "overrun")[0]


def test_paged_mode_rejects_prefill_chunk(shared):
    match = "chunked prefill is not supported in paged mode"
    with pytest.raises(ValueError, match=match):
        JEngine(shared.jcfg, shared.jparams, max_len=96, page_size=16,
                prefill_chunk=8)
    with pytest.raises(ValueError, match=match):
        _engine(shared, "paged", prefill_chunk=8)


def _drain(eng, prompts, n):
    """Streams on `eng` (stream_buffer 4), each read 3 tokens and left to
    park, then quiesced and snapshotted: (tokens read, snapshots)."""
    handles = [eng.submit(p, SamplingParams(max_new_tokens=n), tag=f"s{i}")
               for i, p in enumerate(prompts)]
    its = [iter(h) for h in handles]
    seen = [[next(it) for _ in range(3)] for it in its]
    _wait(lambda: all(h.backlog_full() for h in handles), "streams to park")
    assert eng.quiesce_for_drain()
    snaps = eng.snapshot_active_streams()
    return seen, [snaps[f"s{i}"] for i in range(len(prompts))]


def _resume(eng, seen, snap):
    """The consumer's whole stream: what it read, the history it never
    received, then the stream resumed on `eng`."""
    pack = _Prefilled(snap["kv"], snap["token"], snap["prompt_len"],
                      snap["lens"], snap["generated"], snap["history"],
                      emit_first=False)
    handle = eng.submit_prefilled(pack, SamplingParams(**snap["sampling"]))
    assert snap["history"][:len(seen)] == seen
    return seen + snap["history"][len(seen):] + handle.tokens()


@pytest.mark.parametrize("src,dst", [("dense", "dense"), ("paged", "paged"),
                                     ("paged", "dense"), ("dense", "paged")])
def test_drain_round_trip(shared, src, dst):
    prompts, n = [[1, 5, 9, 2, 7], [4, 4, 6]], 24
    a = _engine(shared, src, max_batch=2, stream_buffer=4)
    b = _engine(shared, dst, max_batch=2)
    try:
        seen, snaps = _drain(a, prompts, n)
        for snap in snaps:
            assert snap["lens"] == len(snap["history"]) - 1 + \
                snap["prompt_len"]
            assert all(k.dtype == torch.float32 and k.shape[1] == snap["lens"]
                       for layer in snap["kv"] for k in layer)
        got = [_resume(b, s, snap) for s, snap in zip(seen, snaps)]
        _pages_returned(b)
    finally:
        a.shutdown()
        b.shutdown()
    _pages_returned(a)
    assert got == shared.greedy(prompts, n)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_resume_from_jax_snapshot(shared, mode):
    """A stream drained from the JAX engine continues in the port exactly
    as it does uninterrupted in the JAX engine."""
    jeng, prompt, n = shared.engines["drain"], [1, 5, 9, 2, 7], 24
    handle = jeng.submit(prompt, JSamplingParams(max_new_tokens=n), tag="x")
    it = iter(handle)
    seen = [next(it) for _ in range(3)]
    _wait(handle.backlog_full, "the JAX stream to park")
    assert jeng.quiesce_for_drain()
    try:
        snap = jeng.snapshot_active_streams()["x"]
    finally:
        jeng.resume()
    want = seen + list(it)
    eng = _engine(shared, mode, max_batch=2)
    try:
        got = _resume(eng, seen, snap)
        _pages_returned(eng)
    finally:
        eng.shutdown()
    assert len(want) == n
    assert got == want
