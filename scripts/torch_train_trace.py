"""Where the time of the port's training step goes, on one NVIDIA GPU.

Runs the training phase of chip_smoke.py (bench.py's 1.2B Llama config in
bf16 with flash attention, B 2, S 2048, AdamW; or the MoE's, or DiT-XL/2's
from phase 11) with torch.profiler over its timed steps (which prints the
phase's own line, its times lengthened by the tracing), and prints one
JSON line:

- window_ms: the traced window (first to last event);
- device_busy_ms / idle_share: the union of kernel intervals, and the
  share of the window with no kernel running;
- per_step: device ms per training step in five groups, bf16 GEMMs
  (cuBLAS), f32 GEMMs (the MoE's dispatch and combine products, by
  their kernels' names: `sgemm`, `f32f32` or `nvjet_sss`), flash forward
  (K1), flash backward (its delta, dK/dV and dQ kernels), and
  elementwise and other work (norms, RoPE, SiLU, casts, the loss, the
  optimizer, the routing, copies), and kernel launches per step;
- kernels: device time by kernel name, largest first.

Run from the repository root on the card:

    python3 scripts/torch_train_trace.py          # the 1.2B Llama
    python3 scripts/torch_train_trace.py --moe    # chip_smoke's MoE phase
    python3 scripts/torch_train_trace.py --dit    # DiT-XL/2, B 32, bf16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
import chip_smoke  # noqa: E402
from torch_serve_trace import union_us  # noqa: E402

from ray_tpu_torch.models import moe  # noqa: E402

STEPS = 5
MOE_STEPS = 3


def group(name: str) -> str:
    if "flash_fwd_" in name:
        return "flash_forward"
    if "flash_bwd_" in name:
        return "flash_backward"
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "xmma" in low or "cutlass" in low:
        f32 = "sgemm" in low or "f32f32" in low or "nvjet_sss" in low
        return "gemm_f32" if f32 else "gemm"
    return "elementwise_and_other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--moe", action="store_true",
                       help="trace chip_smoke.py's MoE training phase")
    which.add_argument("--dit", action="store_true",
                       help="trace chip_smoke.py's DiT-XL/2 training")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_trace: no CUDA device available")
    card = chip_smoke.card_line()
    chip_smoke._build.build_all()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    steps = MOE_STEPS if args.moe else STEPS
    if args.dit:
        chip_smoke.dit_training(card, prof, steps)
    elif args.moe:
        chip_smoke.training_phase(
            card, prof, steps, chip_smoke.MOE_TRAIN_CFG,
            chip_smoke.moe_loss_fn(), "moe training",
            moe.count_flops_per_token)
    else:
        chip_smoke.training_phase(card, window=prof, steps=steps)

    events = list(prof.events())
    # Device events, less the device-side copies of record_function
    # ranges (such as Optimizer.step#AdamW.step), which span kernels.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])

    groups = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        groups[group(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "card": card,
        "model": "moe" if args.moe else "dit" if args.dit else "llama",
        "steps": steps,
        "window_ms": (end - start) / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1 - busy / (end - start),
        "per_step": {
            **{f"{g}_ms": groups[g] / 1e3 / steps for g in (
                "gemm", "gemm_f32", "flash_forward", "flash_backward",
                "elementwise_and_other")},
            "kernel_launches": len(kernels) / steps},
        "kernels": [{"name": n[:90], "ms": t / 1e3, "launches": c}
                    for n, (t, c) in top],
    }), flush=True)


if __name__ == "__main__":
    main()
