"""What the mesh-sharded training step costs over the single-device step,
on one NVIDIA GPU.

An NCCL world of one, make_mesh(MeshConfig()) (every axis of size 1):
chip_smoke.py's training cell (the 1.2B config in bf16, flash attention,
B 2, S 2048, AdamW) as a single-device state and as a sharded one
(init_sharded_state with TRANSFORMER_RULES), from the same params. Both
run the same instrumented step, which synchronizes the card after the
forward, the backward and the optimizer update; the sharded one through
shard_train_step. After 2 warm-up steps each, the two run 10 steps each
in turns (single, sharded, sharded, single). Then torch.profiler traces 3
steps of each (without the synchronizations inside the step).

Prints one JSON line: per path, the median wall ms per step and of its
forward, backward and update, and what shard_train_step adds around the
step (checks, batch layout, the replicated loss); from the traces, device
busy ms and kernel launches per step, the share of the window the device
is idle, and whether AdamW ran its foreach (multi-tensor) kernels.

Run from the repository root on the card:

    python3 scripts/torch_sharded_step.py
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import sys
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
import chip_smoke  # noqa: E402
from torch_serve_trace import union_us  # noqa: E402

from ray_tpu_torch.models import init_params  # noqa: E402
from ray_tpu_torch.parallel import (TRANSFORMER_RULES, MeshConfig, P,  # noqa: E402
                                    initialize_multihost, make_mesh)
from ray_tpu_torch.train import (adamw, init_sharded_state,  # noqa: E402
                                 init_train_state, shard_train_step)

WARMUP, STEPS, TRACED = 2, 10, 3


class Phases:
    """A train step (as make_train_step's) that times its forward,
    backward and update, synchronizing the card after each."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times = []

    def _now(self):
        if self.sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def __call__(self, state, batch):
        t0 = self._now()
        state.optimizer.zero_grad(set_to_none=True)
        loss = chip_smoke.llama_loss(state.model, batch)
        t1 = self._now()
        loss.backward()
        t2 = self._now()
        state.optimizer.step()
        t3 = self._now()
        state.step += 1
        self.times.append((t1 - t0, t2 - t1, t3 - t2))
        return state, {"loss": loss.detach(), "step": state.step}


def run(step, phases, state, batch, n):
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, phases.times[-n:]


def trace(step, state, batch, n: int = TRACED) -> dict:
    """Device busy ms a step (and of it in NCCL kernels), the idle share of
    the traced window, launches and AdamW multi-tensor launches a step,
    over n steps under torch.profiler."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    nccl = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels if "nccl" in e.name.lower()])
    return {"device_busy_ms_per_step": busy / 1e3 / n,
            "nccl_ms_per_step": nccl / 1e3 / n,
            "launches_per_step": len(kernels) / n,
            "idle_share": 1 - busy / (end - start),
            "adamw_multi_tensor_kernels": sum(
                "multi_tensor_apply" in e.name for e in kernels) // n}


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_sharded_step: no CUDA device available")
    card = chip_smoke.card_line()
    chip_smoke._build.build_all()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        os.environ["MASTER_PORT"] = str(s.getsockname()[1])
    os.environ["MASTER_ADDR"] = "localhost"
    initialize_multihost(num_processes=1, process_id=0)
    try:
        mesh = make_mesh(MeshConfig())
        cfg = chip_smoke.TRAIN_CFG
        batch = chip_smoke.train_batch(cfg)
        opt = adamw(3e-4, weight_decay=0.01)
        plain_phases, sharded_phases = Phases(), Phases()
        plain = init_train_state(cfg, opt, seed=0)
        sharded, specs = init_sharded_state(mesh, cfg, init_params,
                                            TRANSFORMER_RULES, opt, cfg, 0)
        axes = P(("dp", "fsdp"), None)
        sharded_step = shard_train_step(sharded_phases, mesh, specs,
                                        (axes, axes))
        paths = {"single_device": (plain_phases, plain_phases, plain),
                 "sharded": (sharded_step, sharded_phases, sharded)}
        for step, phases, state in paths.values():
            run(step, phases, state, batch, WARMUP)
        walls = {name: [] for name in paths}
        parts = {name: [] for name in paths}
        for name in ("single_device", "sharded", "sharded", "single_device"):
            w, p = run(*paths[name], batch, STEPS)
            walls[name] += w
            parts[name] += p
        out = {"card": card, "steps_timed": 2 * STEPS, "paths": {}}
        for name, (step, phases, state) in paths.items():
            fwd, bwd, upd = (statistics.median(x) * 1e3
                             for x in zip(*parts[name]))
            wall = statistics.median(walls[name]) * 1e3
            phases.sync = False
            out["paths"][name] = {
                "ms_per_step": wall, "forward_ms": fwd, "backward_ms": bwd,
                "update_ms": upd,
                "around_the_step_ms": wall - fwd - bwd - upd,
                **trace(step, state, batch)}
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
