"""Where the time of the port's last RL learners goes, on one NVIDIA GPU.

Builds DT (on 30 CartPole episodes, as chip_smoke.py's phase 21 writes
them), QMIX on CoopSwitch and DreamerV3 on CartPole at their configs'
defaults on the card, TF32 off, takes one batch of each (DreamerV3 after
two iterations, the second its first with updates), warms up, then runs
UPDATES updates of each on that batch and, for QMIX and DreamerV3, ACTS
steps of their acting forward, each window under torch.profiler. Prints
one JSON line a window:

- host_ms: wall-clock ms a call, the card synchronised after the last;
- device_busy_ms: the union of kernel intervals a call;
- idle_share: the share of the traced window with no kernel running;
- launches: kernels a call;
- kernels: device time by kernel name, largest first.

Run from the repository root on the card:

    python3 scripts/torch_rl_trace.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
import chip_smoke  # noqa: E402
from torch_serve_trace import union_us  # noqa: E402

from ray_tpu_torch.rllib import (DreamerV3Config, DTConfig,  # noqa: E402
                                 QMIXConfig)

UPDATES, ACTS, WARM = 10, 50, 3


def traced(card: str, what: str, fn, n: int) -> dict:
    """fn() WARM times untraced, then n times under the profiler."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = {"card": card, "window": what, "calls": n,
           "host_ms": 1e3 * host_s / n, "device_busy_ms": busy / 1e3 / n,
           "idle_share": 1 - busy / (end - start),
           "launches": len(kernels) / n,
           "kernels": [{"name": k[:80], "ms": t / 1e3 / n, "launches": c / n}
                       for k, (t, c) in top]}
    print(json.dumps(row), flush=True)
    return row


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_rl_trace: no CUDA device available")
    card = chip_smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="torch_rl_trace_")
    try:
        path = os.path.join(root, "cartpole.jsonl")
        chip_smoke.expert_data(path)
        dt = DTConfig(input_path=path).build()
        batch = dt._sample_batch(np.random.default_rng(0))
        traced(card, "dt update", lambda: dt.update(*batch), UPDATES)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    qmix = QMIXConfig().build()
    qmix.train()
    qb = qmix._sample_batch()
    traced(card, "qmix update", lambda: qmix.update(qb), UPDATES)
    aug = qmix._aug_obs(qmix.env.reset(seed=0))
    traced(card, "qmix act", lambda: qmix.agent_q_values(aug), ACTS)

    dv3 = DreamerV3Config().build()
    dv3.train()
    dv3.train()
    cfg = dv3.config
    db = dv3.replay.sample(dv3.rng, cfg.batch_size, cfg.batch_length)
    noise = dv3.update_noise()
    traced(card, "dreamerv3 update", lambda: dv3.update(db, noise), UPDATES)
    post, act = dv3._act_noise(1)
    traced(card, "dreamerv3 act",
           lambda: int(dv3.act(dv3._h, dv3._z, 0, dv3._obs, 0.0, post[0],
                               act[0])[2]), ACTS)


if __name__ == "__main__":
    main()
