"""Serving benchmark of the port on one NVIDIA GPU: paged continuous-batching
decode throughput. Port of scripts/tpu_serve_bench.py.

The paged LLMEngine (its decode chunk a CUDA graph) with bench.py's
1.2B-parameter decoder (vocab 32000, d_model 2048, 16 layers, 16 heads,
d_ff 8192, bf16), random weights from seed 0: a batch of concurrent
greedy streams, 64-token prompts from default_rng(0), 128 new tokens
each, page_size 64, max_len 512, decode_chunk 64, at batch 16 and 32.
Before each timed batch a burst of 8 short requests builds the kernels
and captures the decode graph. Throughput is aggregate generated
tokens/s. Prints one JSON line per configuration, with the card's name
and power limit. Exits without a CUDA device.

Run from the repository root on the card:

    python3 scripts/torch_serve_bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ray_tpu_torch.models import LlamaConfig, SamplingParams, init_params  # noqa: E402
from ray_tpu_torch.serve.llm import LLMEngine  # noqa: E402

CFG = LlamaConfig(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
                  n_kv_heads=16, d_ff=8192, max_seq_len=2048,
                  dtype=torch.bfloat16, attention="flash", remat=False)
CONFIGS = ((16, 128, 64), (32, 128, 64))  # (batch, new tokens, decode chunk)
PROMPT_LEN, MAX_LEN, PAGE = 64, 512, 64


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_serve_bench: no CUDA device available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    params = init_params(CFG, seed=0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    for batch, new_tokens, chunk in CONFIGS:
        engine = LLMEngine(CFG, params, max_batch=batch, max_len=MAX_LEN,
                           decode_chunk=chunk, page_size=PAGE,
                           kv_pool_tokens=batch * MAX_LEN + MAX_LEN)
        try:
            prompts = [[int(x) for x in rng.integers(1, CFG.vocab_size,
                                                     PROMPT_LEN)]
                       for _ in range(batch)]
            warm = [engine.submit(p, SamplingParams(max_new_tokens=8))
                    for p in prompts[:8]]
            for h in warm:
                h.tokens()
            replays0 = engine.graph_replays
            sp = SamplingParams(max_new_tokens=new_tokens)
            t0 = time.perf_counter()
            handles = [engine.submit(p, sp) for p in prompts]
            outs = [h.tokens() for h in handles]
            dt = time.perf_counter() - t0
            replays = engine.graph_replays - replays0
        finally:
            engine.shutdown()
        total = sum(len(o) for o in outs)
        if total != batch * new_tokens:
            raise AssertionError(f"{total} tokens for {batch} streams of "
                                 f"{new_tokens}")
        print(json.dumps({
            "metric": "llm_paged_decode_tokens_per_s",
            "value": total / dt,
            "unit": "tokens/s",
            "extra": {
                "card": card, "batch": batch, "prompt_len": PROMPT_LEN,
                "new_tokens_per_stream": new_tokens,
                "total_generated": total, "wall_s": dt,
                "decode_chunk": chunk, "graph_replays": replays,
                "params_millions": n_params / 1e6,
                "paged": True, "page_size": PAGE,
            },
        }), flush=True)


if __name__ == "__main__":
    main()
