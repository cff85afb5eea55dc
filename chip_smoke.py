"""Drives the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU and holds
its hand-written kernels against their plain PyTorch versions.

Run from the repository root on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, in order; a failure in any of them ends the run with an error:

1. build   - nvcc compiles ray_tpu_torch/ops/csrc/*.cu for sm_90a.
2. kernels - the paged decode kernels (single sequence, batched, fused
             heads) at the serving engine's LLAMA3_8B shapes (H=32,
             Hkv=8, D=128, page 64, a 9-page table), B in {8, 32}, f32
             and bf16, against their plain versions (tolerance 2e-4 f32,
             2e-2 bf16). Times are medians of CUDA-event timings with
             the L2 cache flushed before each launch, as a decode step
             finds it; the bound is the bytes the call must move over
             the card's memory rate; the library yardstick is a page
             gather plus F.scaled_dot_product_attention (not used by the
             port).
3. parity  - LLAMA3_8B widths at 2 layers in f32: the dense-cache
             Generator (no kernel) and the paged LLMEngine (kernel)
             decode 16 greedy tokens for 4 prompts and must agree; a
             divergence passes only at a near-tie (top-2 gap < 1e-3).
4. serving - LLAMA3_8B at full width and depth in bf16, random weights
             from seed 0, behind LLMServer(max_batch=8, max_len=512,
             page_size=64, decode_chunk=8): after a warm-up burst, 8
             greedy prompts of 17-200 tokens and one sampled request
             (temperature 0.8, top-k 50, top-p 0.9), 32 new tokens each,
             sent together. Launch counts are set to 0 just before the
             requests and read just after them.

Prints the kernels as one JSON line, the card's name and power limit, and
last {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import _build
from ray_tpu_torch.models import (LLAMA3_8B, Generator, SamplingParams,
                                  init_kv_caches, init_params)
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

H, HKV, D, PAGE = 32, 8, 128, 64                 # LLAMA3_8B, engine page
MAX_LEN, CHUNK, MAX_BATCH = 512, 8, 8
NP = -(-(MAX_LEN + CHUNK) // PAGE)              # the engine's table width
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SOURCE = "ray_tpu_torch/ops/csrc/paged_decode.cu"
KERNELS = {  # launch-count key -> the TPU kernel it replaces
    "paged_decode_attention": "ray_tpu/ops/paged_attention.py:99",
    "paged_decode_attention_batch": "ray_tpu/ops/paged_attention.py:172",
    "paged_decode_attention_batch_fused": "ray_tpu/ops/paged_attention.py:193",
}
ON_PATH = "paged_decode_attention_batch"
# NVIDIA data sheets, dense: (memory B/s, f32 FLOP/s, bf16 FLOP/s).
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12),
         "SXM": (3.35e12, 67e12, 989e12)}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


class Timer:
    """Median CUDA-event time of fn, the L2 cache flushed before each run."""

    def __init__(self):
        self._flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 25) -> float:
        fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def kernel_inputs(B: int, dtype, seed: int):
    """Pools holding noise everywhere, sequences on shuffled pages, tables
    padded with each sequence's last page; lengths mixed and seeded."""
    rng = np.random.default_rng(seed)
    lengths = [1, 64, 65, 511, NP * PAGE]
    lengths += [int(x) for x in rng.integers(1, NP * PAGE + 1,
                                             B - len(lengths))]
    P = B * NP + 1
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    k_pool, v_pool, q = randn(P, HKV, PAGE, D), randn(P, HKV, PAGE, D), \
        randn(B, H, D)
    free = [int(x) for x in rng.permutation(P)]
    rows = []
    for length in lengths:
        own = [free.pop() for _ in range(-(-length // PAGE))]
        rows.append((own + [own[-1]] * NP)[:NP])
    tables = torch.tensor(rows, dtype=torch.int32, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, k_pool, v_pool, tables, lens), lengths


def library_attention(q, k_pool, v_pool, tables, lengths):
    """One PyTorch call for the same function: page gather + SDPA."""
    B = q.shape[0]
    idx = tables.long()
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, HKV, NP * PAGE, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, HKV, NP * PAGE, D)
    mask = torch.arange(NP * PAGE, device=q.device)[None] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None], enable_gqa=True)


def bound_ms(lengths, B, dtype, card: str):
    """Least time for the call: each live K/V byte, q, out, tables and
    lengths moved once, or its flops at the card's peak, the larger."""
    mem_rate, f32_rate, bf16_rate = peaks(card)
    item = torch.tensor([], dtype=dtype).element_size()
    tokens = sum(min(x, NP * PAGE) for x in lengths)
    nbytes = tokens * HKV * D * 2 * item + 2 * B * H * D * item \
        + B * (NP + 1) * 4
    flops = 4 * H * D * tokens            # q.k and p.v, a multiply-add each
    t_bytes = nbytes / mem_rate
    t_ops = flops / (f32_rate if dtype == torch.float32 else bf16_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, want, tol) -> float:
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    return (out.float() - want.float()).abs().max().item()


def kernel_phase(card: str) -> dict:
    """Checks and times every kernel; returns the main-path (B=8, bf16)
    row of each for the kernels line."""
    timer = Timer()
    rows = {}
    for B in (MAX_BATCH, 32):
        for dtype in (torch.float32, torch.bfloat16):
            args, lengths = kernel_inputs(B, dtype, seed=B)
            tol = TOL[dtype]
            cases = {}
            for fused in (False, True):
                name = ("paged_decode_attention_batch_fused" if fused
                        else "paged_decode_attention_batch")
                out = pa.paged_decode_attention_batch(*args,
                                                      fused_heads=fused)
                want = pa.paged_decode_attention_batch_reference(*args)
                cases[name] = (
                    max_err(out, want, tol),
                    lambda f=fused: pa.paged_decode_attention_batch(
                        *args, fused_heads=f),
                    lambda: pa.paged_decode_attention_batch_reference(*args),
                    lambda: library_attention(*args),
                    bound_ms(lengths, B, dtype, card))
            q, k_pool, v_pool, tables, lens = args
            err = 0.0
            for b in range(B):
                one = (q[b], k_pool, v_pool, tables[b], lens[b])
                err = max(err, max_err(pa.paged_decode_attention(*one),
                                       pa.paged_decode_attention_reference(
                                           *one), tol))
            full = lengths.index(NP * PAGE)   # time the full-table sequence
            one = (q[full], k_pool, v_pool, tables[full], lens[full])
            one_b = (q[full:full + 1], k_pool, v_pool,
                     tables[full:full + 1], lens[full:full + 1])
            cases["paged_decode_attention"] = (
                err, lambda: pa.paged_decode_attention(*one),
                lambda: pa.paged_decode_attention_reference(*one),
                lambda: library_attention(*one_b),
                bound_ms([NP * PAGE], 1, dtype, card))
            torch.cuda.synchronize()
            for name, (err, kernel, plain, library, (bound, by)) in \
                    cases.items():
                row = {"name": name, "route": "cuda", "source": SOURCE,
                       "replaces": KERNELS[name], "max_abs_err": err,
                       "ms": timer(kernel), "plain_ms": timer(plain),
                       "bound_ms": bound, "bound_by": by,
                       "library_ms": timer(library)}
                log(f"kernel {name} B={B} {str(dtype)[6:]}: " + json.dumps(
                    {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "library_ms")}))
                if B == MAX_BATCH and dtype == torch.bfloat16:
                    rows[name] = row
    return rows


@torch.no_grad()
def top2_gap(model, cfg, tokens) -> float:
    """Dense-oracle top-2 logit gap after `tokens`."""
    t = torch.tensor([tokens], device="cuda")
    pos = torch.arange(len(tokens), device="cuda")[None]
    logits, _ = model(t, pos, kv_caches=init_kv_caches(cfg, 1, len(tokens),
                                                       "cuda"))
    top = torch.topk(logits[0, -1], 2).values
    return (top[0] - top[1]).item()


def parity_phase():
    # f32 matmuls in full f32 on both sides of the comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 17, 64, 100)]
    n_new = 16
    eng = LLMEngine(cfg, params, max_batch=4, max_len=256, page_size=PAGE,
                    decode_chunk=CHUNK)
    try:
        handles = [eng.submit(p, SamplingParams(max_new_tokens=n_new))
                   for p in prompts]
        got = [h.tokens() for h in handles]
    finally:
        eng.shutdown()
    for p, toks in zip(prompts, got):
        gen = Generator(cfg, params, batch=1, max_len=len(p) + n_new)
        want = gen.generate([p], SamplingParams(max_new_tokens=n_new))[0]
        want = [int(x) for x in want]
        if toks == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b) \
            if len(toks) == len(want) else min(len(toks), len(want))
        gap = top2_gap(gen.model, cfg, p + want[:j])
        log(f"parity: prompt of {len(p)} diverges at token {j}, "
            f"top-2 gap {gap:.3g}")
        if not gap < 1e-3:
            raise AssertionError(f"engine {toks} != generator {want}")
    log(f"parity: {len(prompts)} prompts x {n_new} greedy tokens, "
        "paged engine == dense Generator")


def serving_phase(card: str, window=None) -> dict:
    """Serves the 9 requests through LLMServer; `window` (a context
    manager, such as a torch.profiler.profile) wraps just the timed part."""
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    server = LLMServer(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       page_size=PAGE, decode_chunk=CHUNK)
    del params  # the engine's model holds the same tensors
    eng = server.engine
    log(f"serving: LLAMA3_8B bf16 weights ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)

    def prompt(n):
        return [int(x) for x in rng.integers(1, cfg.vocab_size, n)]

    n_new = 32
    payloads = [{"prompt_tokens": prompt(int(n)), "max_new_tokens": n_new}
                for n in rng.integers(17, 201, MAX_BATCH)]
    payloads.append({"prompt_tokens": prompt(int(rng.integers(17, 201))),
                     "max_new_tokens": n_new, "temperature": 0.8,
                     "top_k": 50, "top_p": 0.9})
    results = [{} for _ in payloads]

    def consume(payload, rec):
        toks = []
        try:
            for tok in server(payload):
                if not toks:
                    rec["first"] = time.perf_counter()
                toks.append(tok)
        except Exception as e:  # recorded; the phase fails below
            rec["error"] = e
        rec["tokens"], rec["end"] = toks, time.perf_counter()

    try:
        warm = [{"prompt_tokens": prompt(64), "max_new_tokens": 8}
                for _ in range(MAX_BATCH)]
        handles = [eng.submit(w["prompt_tokens"],
                              SamplingParams(max_new_tokens=8)) for w in warm]
        for h in handles:
            h.tokens()

        torch.cuda.synchronize()
        pa.reset_launch_counts()
        steps0 = eng.decode_steps
        with window or contextlib.nullcontext():
            start = time.perf_counter()
            threads = []
            for payload, rec in zip(payloads, results):
                rec["submit"] = time.perf_counter()
                th = threading.Thread(target=consume, args=(payload, rec))
                th.start()
                threads.append(th)
            for th in threads:
                th.join(600)
            torch.cuda.synchronize()
        counts = dict(pa.launch_counts)
        steps = eng.decode_steps - steps0
        deadline = time.time() + 10   # pages free just after the last token
        while eng._alloc.free_pages != eng._alloc.num_pages - 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        free, total = eng._alloc.free_pages, eng._alloc.num_pages - 1
    finally:
        eng.shutdown()

    for rec, payload in zip(results, payloads):
        if "error" in rec or len(rec.get("tokens", [])) != n_new:
            raise AssertionError(f"request of {len(payload['prompt_tokens'])}"
                                 f" tokens: {rec}")
        if not all(0 <= t < cfg.vocab_size for t in rec["tokens"]):
            raise AssertionError(f"token out of the vocabulary: {rec}")
    if free != total:
        raise AssertionError(f"{total - free} KV pages not returned")
    if counts[ON_PATH] < cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"{ON_PATH} launched {counts[ON_PATH]} times "
                             f"for {steps} decode steps of {cfg.n_layers} "
                             "layers")
    wall = max(r["end"] for r in results) - start
    ttft = sorted((r["first"] - r["submit"]) * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    log("serving: " + json.dumps({
        "card": card, "requests": len(results), "failed": 0,
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": statistics.median(ttft), "ttft_max_ms": ttft[-1],
        "decode_steps": steps, "launches": counts}))
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(_build.build_log)

    t0 = time.perf_counter()
    rows = kernel_phase(card)
    log(f"kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity_phase()
    torch.cuda.empty_cache()
    log(f"parity: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = serving_phase(card)
    log(f"serving: {time.perf_counter() - t0:.1f} s")

    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": [rows[n] for n in KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
