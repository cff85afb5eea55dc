"""The LLM engine's decode chunk as a captured CUDA graph, on the card.
Every test here needs a CUDA device and skips without one. The file
imports neither jax nor ray_tpu, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_engine.py

At tiny f32 widths (matmuls without TF32): greedy tokens of the
graph-replayed engine, dense (whole and chunked prefill) and paged, equal
the dense-cache Generator's, a divergence passing only at a near-tie
(top-2 logit gap < 1e-3); two engines with one rng_seed sample the same
tokens; two replays of one graph on the same inputs draw different
noise. The prefill pool (serve/llm_disagg.py) in bf16: its misses, full
hits and partial hits, handed over into the paged engine, decode to the
engine's own streams, a divergence passing only at a near-tie (top-2 gap
< 2^-6 of the top logit).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.generate import Generator, SamplingParams  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine, _Prefilled  # noqa: E402
from ray_tpu_torch.serve.llm_disagg import PrefillEngine, PrefixCache  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq_len=256,
                     dtype=torch.float32, attention="reference", remat=False)
MODES = {"dense": {}, "chunked": {"prefill_chunk": 8},
         "paged": {"page_size": 16}}
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(11, 41))]
K3 = "paged_decode_attention_batch"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def params(cuda):
    return convert.init_params(CFG, seed=0, device=cuda)


def _top2(model, tokens, cfg=CFG) -> tuple[float, float]:
    t = torch.tensor([tokens], device="cuda")
    pos = torch.arange(len(tokens), device="cuda")[None]
    with torch.no_grad():
        logits, _ = model(t, pos, kv_caches=tl.init_kv_caches(
            cfg, 1, len(tokens), "cuda"))
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item(), top[0].item()


def _top2_gap(model, tokens) -> float:
    return _top2(model, tokens)[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_graph_replayed_greedy_equals_generator(cuda, params, mode):
    n_new, K = 16, 4
    eng = LLMEngine(CFG, params, max_batch=3, max_len=128, decode_chunk=K,
                    **MODES[mode])
    try:
        handles = [eng.submit(p, SamplingParams(max_new_tokens=n_new))
                   for p in PROMPTS]
        got = [h.tokens() for h in handles]
    finally:
        eng.shutdown()
    assert eng.graph_replays > 0
    assert eng.graph_launches[K3] == (CFG.n_layers * K if mode == "paged"
                                      else 0)
    for p, toks in zip(PROMPTS, got):
        gen = Generator(CFG, params, batch=1, max_len=len(p) + n_new)
        want = [int(x) for x in
                gen.generate([p], SamplingParams(max_new_tokens=n_new))[0]]
        if toks != want:
            j = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
            assert _top2_gap(gen.model, p + want[:j]) < 1e-3, (toks, want)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_same_seed_samples_same_tokens(cuda, params, mode):
    sp = SamplingParams(max_new_tokens=20, temperature=0.8, top_k=50,
                        top_p=0.9)
    outs = []
    for _ in range(2):
        eng = LLMEngine(CFG, params, max_batch=3, max_len=128,
                        decode_chunk=4, rng_seed=3, **MODES[mode])
        try:
            outs.append([h.tokens() for h in
                         [eng.submit(p, sp) for p in PROMPTS]])
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_consecutive_replays_draw_new_noise(cuda, params, mode):
    eng = LLMEngine(CFG, params, max_batch=2, max_len=128, decode_chunk=8,
                    **MODES[mode])
    try:
        eng.generate([1, 2, 3], SamplingParams(max_new_tokens=12))
        assert eng.quiesce_for_drain()
        assert eng.graph_replays > 0
        eng._temps[:] = 1.0   # both slots sample from the full softmax
        eng._topks[:] = 0
        eng._topps[:] = 1.0
        first, second = eng._run_decode_chunk(), eng._run_decode_chunk()
    finally:
        eng.shutdown()
    assert (first != second).any()


def test_prefill_pool_handoff_into_paged_engine_bf16(cuda):
    """A PrefillEngine on the engine's weights dict (no second copy): a
    miss, a full hit (no prefill program) and a partial hit (only the
    suffix program), each handed over through submit_prefilled, decode
    to the engine's own stream of the prompt."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    params = convert.init_params(cfg, seed=0, device=cuda)
    sp = SamplingParams(max_new_tokens=12)
    pe, cache = PrefillEngine(cfg, params, max_len=128), PrefixCache(4)
    eng = LLMEngine(cfg, params, max_batch=2, max_len=128, page_size=16,
                    decode_chunk=4)
    assert pe.model.embed.weight.data_ptr() == \
        eng.model.embed.weight.data_ptr()
    prompt, ext = PROMPTS[1], PROMPTS[1] + [21, 22, 23]
    try:
        for p, hit in ((prompt, "miss"), (prompt, "full"), (ext, "partial")):
            out = pe.prefill(p, sp, cache)
            assert out["prefix_hit"] == hit
            assert out["kv"][0][0].dtype == torch.bfloat16
            got = eng.submit_prefilled(_Prefilled(
                out["kv"], out["first_token"], out["prompt_len"],
                out["kv_len"], 0, [], emit_first=True), sp).tokens()
            want = eng.submit(p, sp).tokens()
            if got != want:
                j = next(i for i, (a, b) in enumerate(zip(got, want))
                         if a != b)
                gap, top = _top2(eng.model, p + want[:j], cfg)
                assert gap < 2 ** -6 * max(abs(top), 1.0), (got, want)
    finally:
        eng.shutdown()
    assert cache.stats()["hits"] == 2
