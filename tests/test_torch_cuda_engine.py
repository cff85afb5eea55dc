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
noise.
"""

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.generate import Generator, SamplingParams  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

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


def _top2_gap(model, tokens) -> float:
    t = torch.tensor([tokens], device="cuda")
    pos = torch.arange(len(tokens), device="cuda")[None]
    with torch.no_grad():
        logits, _ = model(t, pos, kv_caches=tl.init_kv_caches(
            CFG, 1, len(tokens), "cuda"))
    top = torch.topk(logits[0, -1], 2).values
    return (top[0] - top[1]).item()


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
