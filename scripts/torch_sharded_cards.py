"""The sharded training step, ring and Ulysses attention across the cards
of one host: one process per card, joined over NCCL.

Every rank runs, in order:

1. parity - chip_smoke.py's training widths at 2 layers in f32 (exact
   FMAs in the flash kernels, no TF32), from init_params(seed=0) on the
   training batch: 3 steps of shard_train_step on each mesh of MESHES
   against 3 of the single-device step on the rank's own card. Losses
   within 2e-5 (relative), as the CPU test holds the dryrun to JAX; the
   collectives and the split matmuls reorder f32 sums.
2. timing - the full 1.2B config in bf16 on (fsdp 2, tp 2) (the batch
   of 2 sequences over fsdp, heads and the MLP hidden over tp): one
   warm-up step, then 5 steps; ms per step, the flash launches per step,
   peak memory; then 2 steps under torch.profiler: device busy ms a step,
   of it in NCCL kernels, the idle share of the window, launches a step;
   and rank 0's single-device step on its card, the other ranks
   waiting.
3. sequence parallelism - ring (f32) and Ulysses (bf16, the flash
   kernels) on an sp mesh over every rank at the flash phase's training
   shape (B 2, H 16, S 2048, D 128, causal), each rank holding its chunk
   of the sequence: out and q, k, v grads against mha_reference (ring,
   2e-5 and 1e-4) and flash_attention (Ulysses, chip_smoke.bf16_err) on
   the whole sequence.
4. moe parity - the MoE decoder at MIXTRAL_8X7B's widths at 1 layer in
   f32 (flash attention, full remat), laid out by MOE_RULES on each mesh
   of MOE_MESHES (experts over ep, and heads, d_ff and the vocab over
   tp): 3 sharded steps against 3 of the single-device step on the
   rank's own card, losses within 2e-5 (relative).
5. moe timing - the same widths at 2 layers in bf16 on (ep 4), each card
   holding 2 of the 8 experts: as the timing part, ms per step, flash
   launches per step, peak memory and the trace (of it, the NCCL share
   of device time).

Rank 0 prints one JSON line of the results with the card's name and power
limit; any failure ends the run non-zero. Run from the repository root on
a host with 4 cards:

    python3 scripts/torch_sharded_cards.py

`--cpu N` runs the same programs on N gloo processes at small widths, a
rehearsal without cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import multiprocessing
import os
import socket
import statistics
import sys
import time
import traceback

import torch
import torch.distributed as dist

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
import chip_smoke  # noqa: E402
from torch_sharded_step import trace  # noqa: E402

from ray_tpu_torch.models import MIXTRAL_8X7B, MOE_RULES  # noqa: E402
from ray_tpu_torch.models import init_params  # noqa: E402
from ray_tpu_torch.ops import attention as fa  # noqa: E402
from ray_tpu_torch.parallel import (TRANSFORMER_RULES, MeshConfig, P,  # noqa: E402
                                    make_mesh)
from ray_tpu_torch.train import (adamw, init_sharded_state,  # noqa: E402
                                 init_train_state, make_train_step,
                                 shard_train_step)
from ray_tpu_torch.util.collective import ops as col  # noqa: E402

MESHES = (MeshConfig(fsdp=2, tp=2), MeshConfig(dp=2, tp=2))
TIMING_MESH = MeshConfig(fsdp=2, tp=2)
MOE_MESHES = (MeshConfig(ep=4), MeshConfig(ep=2, tp=2))
MOE_TIMING_MESH = MeshConfig(ep=4)
PARITY_STEPS, TIMED_STEPS = 3, 5
AXES = P(("dp", "fsdp"), None)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _steps(step, state, batch, n, device):
    """(state, losses, wall ms of each step)."""
    losses, ms = [], []
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    return state, torch.stack(losses).tolist(), ms


def parity(cfg, batch, device_type, device, meshes=MESHES,
           rules=TRANSFORMER_RULES, loss_fn=chip_smoke.llama_loss):
    out = {}
    opt = adamw(3e-4, weight_decay=0.01)
    step = make_train_step(loss_fn)
    plain = init_train_state(cfg, opt, init_params(cfg, 0, device),
                             device=device)
    _, want, _ = _steps(step, plain, batch, PARITY_STEPS, device)
    del plain
    for mc in meshes:
        mesh = make_mesh(mc, device_type)
        state, specs = init_sharded_state(
            mesh, cfg, init_params, rules, opt, cfg, 0, device)
        sharded = shard_train_step(step, mesh, specs, (AXES, AXES))
        _, got, _ = _steps(sharded, state, batch, PARITY_STEPS, device)
        name = str(state.model.embed.weight.device_mesh)
        out[name] = {"losses": got, "single_device_losses": want}
        if any(abs(a - b) > 2e-5 * abs(b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: losses {got} != {want}")
        del state, sharded
    return out


def timing(cfg, batch, device_type, device, timing_mesh=TIMING_MESH,
           rules=TRANSFORMER_RULES, loss_fn=chip_smoke.llama_loss):
    opt = adamw(3e-4, weight_decay=0.01)
    mesh = make_mesh(timing_mesh, device_type)
    state, specs = init_sharded_state(mesh, cfg, init_params, rules, opt,
                                      cfg, 0, device)
    sharded = shard_train_step(make_train_step(loss_fn), mesh, specs,
                               (AXES, AXES))
    state, first, _ = _steps(sharded, state, batch, 1, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state, losses, ms = _steps(sharded, state, batch, TIMED_STEPS, device)
    counts = {k: v / TIMED_STEPS for k, v in fa.launch_counts.items()}
    out = {"mesh": str(state.model.embed.weight.device_mesh),
           "losses": first + losses, "ms_per_step": statistics.median(ms),
           "flash_launches_per_step": counts,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if device.type == "cuda" else None)}
    if device.type == "cuda" and counts != chip_smoke.flash_launches(cfg, 1):
        raise AssertionError(f"flash launches a step {counts}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"losses {out['losses']}")
    if device.type == "cuda":
        out["trace"] = trace(sharded, state, batch, n=2)
    del state, sharded
    dist.barrier()
    if dist.get_rank() == 0:
        plain = init_train_state(cfg, opt, init_params(cfg, 0, device),
                                 device=device)
        step = make_train_step(loss_fn)
        plain, _, _ = _steps(step, plain, batch, 1, device)
        _, _, ms = _steps(step, plain, batch, TIMED_STEPS, device)
        out["single_device_ms_per_step"] = statistics.median(ms)
    dist.barrier()
    return out


def sequence_parallel(shape, device_type, device):
    B, H, S, D = shape
    out = {}
    mesh = make_mesh(MeshConfig(sp=-1), device_type)
    with col.mesh_context(mesh):
        me, n = col.axis_index("sp"), col.axis_size("sp")
        c = S // n
        for fn, dtype in (("ring", torch.float32), ("ulysses", torch.bfloat16)):
            g = torch.Generator(device=device).manual_seed(0)
            q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=device)
                           .to(dtype) for _ in range(4))
            full = [t.clone().requires_grad_() for t in (q, k, v)]
            if fn == "ring":
                want = fa.mha_reference(*full, causal=True)
            else:
                want = (fa.flash_attention(*full, causal=True)
                        if device.type == "cuda"
                        else fa.mha_reference(*full, causal=True))
            want.backward(do)
            want = [want.detach()] + [t.grad for t in full]
            part = [t[:, :, me * c:(me + 1) * c].clone().requires_grad_()
                    for t in (q, k, v)]
            got = getattr(fa, f"{fn}_attention")(*part, axis="sp",
                                                 causal=True)
            got.backward(do[:, :, me * c:(me + 1) * c])
            got = [got.detach()] + [t.grad for t in part]
            want = [t[:, :, me * c:(me + 1) * c] for t in want]
            if fn == "ring":
                errs = [chip_smoke.max_err(a, b, tol) for a, b, tol in
                        zip(got, want, (2e-5, 1e-4, 1e-4, 1e-4))]
            else:
                errs = [chip_smoke.bf16_err(a, b)[0]
                        for a, b in zip(got, want)]
            out[fn] = {"sp": n, "max_abs_err_out_dq_dk_dv": errs}
    return out


def rank_main(rank, world, port, device_type, small, results):
    try:
        device = torch.device("cpu")
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
        try:
            cfg, moe_cfg = chip_smoke.TRAIN_CFG, MIXTRAL_8X7B
            S = chip_smoke.TRAIN_S
            if small:
                cfg = dataclasses.replace(cfg, vocab_size=512, d_model=128,
                                          n_heads=4, n_kv_heads=4,
                                          n_layers=2, d_ff=256)
                moe_cfg = dataclasses.replace(moe_cfg, vocab_size=512,
                                              d_model=128, n_heads=4,
                                              n_kv_heads=2, d_ff=256)
                S = 128
            g = torch.Generator().manual_seed(0)
            data = torch.randint(0, cfg.vocab_size, (chip_smoke.TRAIN_B,
                                                     S + 1), generator=g)
            batch = (data[:, :-1].to(device), data[:, 1:].to(device))
            out = {"parity": parity(dataclasses.replace(
                cfg, n_layers=2, dtype=torch.float32), batch, device_type,
                device)}
            out["timing"] = timing(cfg, batch, device_type, device)
            out["sequence_parallel"] = sequence_parallel(
                (chip_smoke.TRAIN_B, cfg.n_heads, S, cfg.head_dim),
                device_type, device)
            moe_loss = chip_smoke.moe_loss_fn()
            out["moe_parity"] = parity(
                dataclasses.replace(moe_cfg, n_layers=1,
                                    dtype=torch.float32),
                batch, device_type, device, MOE_MESHES, MOE_RULES, moe_loss)
            out["moe_timing"] = timing(
                dataclasses.replace(moe_cfg, n_layers=2), batch, device_type,
                device, MOE_TIMING_MESH, MOE_RULES, moe_loss)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, traceback.format_exc(), None))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="run on this many gloo processes at small widths")
    args = ap.parse_args()
    if args.cpu:
        world, device_type, card = args.cpu, "cpu", "CPU (gloo)"
    else:
        if not torch.cuda.is_available():
            sys.exit("torch_sharded_cards: no CUDA device available")
        world, device_type = torch.cuda.device_count(), "cuda"
        card = chip_smoke.card_line()
        chip_smoke._build.build_all()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, world, port, device_type,
                                                 bool(args.cpu), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, failed = {}, []
    deadline = time.monotonic() + 900
    try:
        for _ in range(world):
            rank, err, res = results.get(
                timeout=max(deadline - time.monotonic(), 1))
            if err:
                failed.append(f"rank {rank}:\n{err}")
                break
            out[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)
    if failed:
        sys.exit("\n".join(failed))
    print(json.dumps({"card": card, "world": world, **out[0],
                      "timing_ms_per_step_by_rank": [
                          out[r]["timing"]["ms_per_step"]
                          for r in range(world)],
                      "moe_timing_ms_per_step_by_rank": [
                          out[r]["moe_timing"]["ms_per_step"]
                          for r in range(world)]}), flush=True)


if __name__ == "__main__":
    main()
