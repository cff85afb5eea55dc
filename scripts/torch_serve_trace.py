"""Where the time of the port's paged serving goes, on one NVIDIA GPU.

Runs the serving phase of chip_smoke.py (LLAMA3_8B bf16 behind the paged
LLMEngine, its decode chunk a replayed CUDA graph; 8 greedy prompts of
17-200 tokens and one sampled request, 32 new tokens each) with
torch.profiler over its timed window (which prints the phase's own line,
its times lengthened by the tracing), and prints one JSON line (the
kernels of a graph replay are device events like any other; an
`llm.decode_chunk` span's host time is the staging copies, the replay's
launch and the wait for its tokens):

- window_ms: the traced window (first to last event);
- device_busy_ms / idle_share: the union of kernel intervals, and the
  share of the window with no kernel running;
- spans: host time and count of the engine's spans (llm.prefill_many,
  llm.prefill_one, llm.decode_chunk), each with the device's busy share
  inside it;
- kernels: device time by kernel name, largest first;
- paged_decode: the K3 kernel's device time and launches, and per decode
  step (K3 runs once per layer per step) its time and the device's busy
  time.

Run from the repository root on the card:

    python3 scripts/torch_serve_trace.py
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SPANS = ("llm.prefill_many", "llm.prefill_one", "llm.decode_chunk")


def union_us(intervals, lo=None, hi=None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_serve_trace: no CUDA device available")
    card = chip_smoke.card_line()
    chip_smoke._build.build_all()
    # The engine runs in its own thread: record every thread's host ops.
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    chip_smoke.serving_phase(card, window=prof)

    events = list(prof.events())
    # Device events other than the engine spans' own GPU-side copies.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in SPANS]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    ranges = [(e.time_range.start, e.time_range.end) for e in kernels]
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy = union_us(ranges)

    spans = {}
    for name in SPANS:
        hits = [e for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        host = sum(e.time_range.elapsed_us() for e in hits)
        inside = sum(union_us(ranges, e.time_range.start, e.time_range.end)
                     for e in hits)
        spans[name] = {"count": len(hits), "host_ms": host / 1e3,
                       "device_busy_share": inside / host if host else None}

    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    k3 = [e for e in kernels if "paged_decode_cluster" in e.name]
    k3_ms = sum(e.time_range.elapsed_us() for e in k3) / 1e3
    steps = len(k3) / chip_smoke.LLAMA3_8B.n_layers
    print(json.dumps({
        "card": card,
        "window_ms": (end - start) / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1 - busy / (end - start),
        "kernel_launches": len(kernels),
        "spans": spans,
        "paged_decode": {
            "ms": k3_ms, "launches": len(k3), "decode_steps": steps,
            "ms_per_decode_step": k3_ms / steps if steps else None,
            "device_busy_ms_per_decode_step":
                busy / 1e3 / steps if steps else None},
        "kernels": [{"name": n[:90], "ms": t / 1e3, "launches": c}
                    for n, (t, c) in top],
    }), flush=True)


if __name__ == "__main__":
    main()
