"""Rank programs for tests/test_torch_parallel.py.

`run_world(world, programs)` spawns `world` processes joined in a gloo
process group on the CPU, runs each named program on every rank, in
turn, and returns each rank's results; it raises on the first rank that
fails or when the time limit passes, so a collective that deadlocks fails
the test instead of hanging the suite. This module imports torch and the
port only: the spawned ranks import it, and no jax.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models.encoder import EncoderConfig, mlm_loss
from ray_tpu_torch.models.llama import LlamaConfig, cross_entropy_loss
from ray_tpu_torch.models.moe import MOE_RULES, MoEConfig, moe_aux_loss
from ray_tpu_torch.models.ssm import SSM_RULES, SSMConfig
from ray_tpu_torch.models.vit import ViTConfig, vit_loss
from ray_tpu_torch.ops.attention import ring_attention, ulysses_attention
from torch.distributed.tensor import Replicate

from ray_tpu_torch.parallel import (TRANSFORMER_RULES, MeshConfig, P,
                                    make_mesh, pipeline_apply, shard_tree,
                                    with_rules_constraint)
from ray_tpu_torch.parallel.sharding import distribute, spec_placements
from ray_tpu_torch.train import (adamw, init_sharded_state, init_train_state,
                                 make_train_step, reshard_to_mesh,
                                 shard_train_step)
from ray_tpu_torch.train.checkpoint import restore_pytree, save_pytree
from ray_tpu_torch.util.collective import ops as col

# The reference dryrun's flagship model (__graft_entry__.py:157-160).
DRYRUN_CFG = LlamaConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
                         n_kv_heads=8, d_ff=256, max_seq_len=128,
                         dtype=torch.float32, attention="reference",
                         remat=False)
DRYRUN_MESH = MeshConfig(dp=2, fsdp=2, tp=2)
# The reference dryrun's expert-parallel MoE (__graft_entry__.py:245-250).
MOE_DRYRUN_CFG = MoEConfig(vocab_size=128, d_model=64, n_layers=1, n_heads=4,
                           n_kv_heads=4, d_ff=128, n_experts=4,
                           experts_per_token=2, max_seq_len=32,
                           dtype=torch.float32, attention="reference",
                           remat=False)
SP_MODEL_MESH = MeshConfig(sp=8)
DRYRUN_STEPS = 2
LR = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, programs, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out = {name: globals()[name](inputs)
                   for name, inputs in programs.items()}
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))


def run_world(world: int, programs: dict, timeout: float) -> list:
    """[{program: its result on rank r} for r in range(world)], for
    programs = {program name: its inputs}."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, programs,
                                              results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = [None] * world
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"{list(programs)} on {world} ranks did "
                                   f"not end within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.terminate()
                p.join(10)
    return out


# ---------------------------------------------------------------------------
# The programs: each runs on every rank, returns picklable results.
# ---------------------------------------------------------------------------


def llama_loss(model, batch):
    inp, tgt = batch
    return cross_entropy_loss(model(inp), tgt)


def moe_loss(model, batch):
    """The MoE model's next-token loss plus its layers' aux losses."""
    inp, tgt = batch
    inter = {}
    logits = model(inp, intermediates=inter)
    return cross_entropy_loss(logits, tgt) + moe_aux_loss(inter)


def _full(t) -> np.ndarray:
    """A copy: a replicated DTensor's full tensor is its local tensor."""
    return t.detach().full_tensor().numpy().copy()


def _sharded_run(cfg, params, data, mesh, batch_axes, steps):
    """(state, specs, step, batch, losses, seconds of each step) of
    `steps` sharded steps on the batch (data[:, :-1], data[:, 1:])."""
    state, specs = init_sharded_state(
        mesh, cfg, {n: torch.from_numpy(a) for n, a in params.items()},
        TRANSFORMER_RULES, adamw(LR))
    step = shard_train_step(make_train_step(llama_loss), mesh, specs,
                            (batch_axes, batch_axes))
    batch = (torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:]))
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        seconds.append(time.perf_counter() - t0)
    return state, specs, step, batch, losses, seconds


def _state_tensors(state) -> dict:
    """Full params and optimizer moments by name."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = _full(p)
        for k, v in state.optimizer.state[p].items():
            if v.dim():
                out[f"{name}/{k}"] = _full(v)
    return out


def dryrun(inputs):
    """Part 1 of the reference dryrun: dp 2 x fsdp 2 x tp 2, attention
    "reference"; the same on (dp 2, sp 2, tp 2) with the sequence sharded
    over sp for ring, ulysses and flash; and a second copy of the first
    state resharded to (fsdp 8) after its steps, then one more step on
    each, and the same state saved through DCP before the reshard and
    restored onto a fresh state on (fsdp 8), then one step."""
    params, data = inputs["params"], inputs["data"]
    t0 = time.perf_counter()
    seconds = {}
    mesh = make_mesh(DRYRUN_MESH, device_type="cpu")
    batch_axes = P(("dp", "fsdp"), None)
    state, specs, step, batch, losses, step_s = _sharded_run(
        DRYRUN_CFG, params, data, mesh, batch_axes, DRYRUN_STEPS)
    out = {"losses": losses, "step_s": step_s,
           "params": {n: _full(p) for n, p in state.model.named_parameters()},
           "mesh": str(state.model.embed.weight.device_mesh),
           "placements": {n: str(p.placements) for n, p in
                          state.model.named_parameters()}}

    seconds["dryrun"] = time.perf_counter() - t0
    try:     # a batch of 6 over dp 2 x fsdp 2
        step(state, tuple(t[:6] for t in batch))
        out["uneven_batch"] = "accepted"
    except ValueError as e:
        out["uneven_batch"] = str(e)
    # shard_tree lays the params out as the state's; with_rules_constraint
    # brings replicated copies back to that layout.
    full = {n: torch.from_numpy(a) for n, a in params.items()}
    tree = shard_tree(mesh, full, TRANSFORMER_RULES)
    lmesh = state.model.embed.weight.device_mesh
    replicated = {n: distribute(t, lmesh, [Replicate()] * lmesh.ndim)
                  for n, t in full.items()}
    constrained = with_rules_constraint(replicated, TRANSFORMER_RULES)
    out["layouts"] = {
        what: {"placements": {n: str(t.placements) for n, t in got.items()},
               "unequal": sorted(n for n, t in got.items()
                                 if not np.array_equal(_full(t), params[n]))}
        for what, got in (("shard_tree", tree),
                          ("with_rules_constraint", constrained))}
    # (e) the same state again, resharded to fsdp 8 after its steps.
    other, _, _, _, other_losses, _ = _sharded_run(
        DRYRUN_CFG, params, data, mesh, batch_axes, DRYRUN_STEPS)
    before = _state_tensors(other)
    ckpt = os.path.join(inputs["ckpt_dir"], "state")
    t_ckpt = time.perf_counter()
    save_pytree(other, ckpt)
    t_ckpt = time.perf_counter() - t_ckpt
    fsdp8 = make_mesh(MeshConfig(fsdp=8), device_type="cpu")
    other = reshard_to_mesh(other, specs, fsdp8)
    after = _state_tensors(other)
    restored, _ = init_sharded_state(
        fsdp8, DRYRUN_CFG, {n: torch.from_numpy(a) for n, a in params.items()},
        TRANSFORMER_RULES, adamw(LR))
    t1 = time.perf_counter()
    restore_pytree(ckpt, restored)
    t_ckpt += time.perf_counter() - t1
    restored_tensors = _state_tensors(restored)
    out["reshard"] = {
        "same_losses": other_losses == losses,
        "names": sorted(before) == sorted(after),
        "unequal": sorted(n for n in before
                          if not np.array_equal(before[n], after[n])),
        "mesh": str(other.model.embed.weight.device_mesh),
        "placements": str(other.model.layers[0].attn.q_proj.weight.placements),
    }
    step8 = shard_train_step(make_train_step(llama_loss), fsdp8, specs,
                             (batch_axes, batch_axes))
    _, m = step(state, batch)
    _, m8 = step8(other, batch)
    t2 = time.perf_counter()
    _, mr = step8(restored, batch)
    t_ckpt += time.perf_counter() - t2
    out["reshard"]["next_loss"] = m["loss"].item()
    out["reshard"]["next_loss_resharded"] = m8["loss"].item()
    stepped, stepped_restored = _state_tensors(other), \
        _state_tensors(restored)
    out["restore"] = {
        "unequal_before_step": sorted(
            n for n in after if n not in restored_tensors
            or not np.array_equal(after[n], restored_tensors[n])),
        "placements": str(
            restored.model.layers[0].attn.q_proj.weight.placements),
        "steps": [other.step, restored.step],
        "next_loss": mr["loss"].item(),
        "unequal_after_step": sorted(
            n for n in stepped
            if not np.array_equal(stepped[n], stepped_restored[n]))}
    seconds["checkpoint"] = t_ckpt   # save, restore, the restored step
    seconds["reshard"] = time.perf_counter() - t0

    sp_mesh = make_mesh(SP_MODEL_MESH, device_type="cpu")
    out["sp_model"] = {}
    for attention in ("ring", "ulysses", "flash"):
        cfg = dataclasses.replace(DRYRUN_CFG, attention=attention)
        st, _, _, _, ls, _ = _sharded_run(cfg, params, data, sp_mesh,
                                          P(("dp", "fsdp"), "sp"),
                                          DRYRUN_STEPS)
        out["sp_model"][attention] = {
            "losses": ls,
            "params": {n: _full(p) for n, p in st.model.named_parameters()}}
        seconds[attention] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out if dist.get_rank() == 0 else None


def sequence_parallel(inputs):
    """Ring and Ulysses attention on an sp=8 mesh, each rank holding its
    chunk of the sequence: out and the q, k, v grads of sum(out * dO)."""
    mesh = make_mesh(MeshConfig(sp=8), device_type="cpu")
    res = {}
    with col.mesh_context(mesh):
        me, n = col.axis_index("sp"), col.axis_size("sp")
        for key, (fn, q, k, v, do, causal) in inputs.items():
            fn = {"ring": ring_attention, "ulysses": ulysses_attention}[fn]
            S = q.shape[2] // n
            q, k, v, do = (torch.from_numpy(a[:, :, me * S:(me + 1) * S])
                           for a in (q, k, v, do))
            q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(q, k, v, axis="sp", causal=causal)
            (out * do).sum().backward()
            res[key] = [t.detach().numpy() for t in
                        (out, q.grad, k.grad, v.grad)]
    return res


def pipeline(inputs):
    """pipeline_apply on pp 4 x dp 2: layers split over pp, microbatches'
    batch dim over dp."""
    mesh = make_mesh(MeshConfig(pp=4, dp=2), device_type="cpu")
    ws, x = torch.from_numpy(inputs["ws"]), torch.from_numpy(inputs["x"])
    with col.mesh_context(mesh):
        stage, n_stages = col.axis_index("pp"), col.axis_size("pp")
        dp, n_dp = col.axis_index("dp"), col.axis_size("dp")
        per_stage, mb = ws.shape[0] // n_stages, x.shape[1] // n_dp

        def stage_fn(stage_ws, h):
            for w in stage_ws:
                h = torch.tanh(h @ w)
            return h

        y = pipeline_apply(stage_fn,
                           ws[stage * per_stage:(stage + 1) * per_stage],
                           x[:, dp * mb:(dp + 1) * mb], axis="pp")
    return {"dp": dp, "stage": stage, "y": y.numpy()}


def collectives(inputs):
    """Each collective on this rank's shard; the test assembles them."""
    rank = dist.get_rank()
    out = {}
    with col.mesh_context(make_mesh(MeshConfig(dp=8), device_type="cpu")):
        x = torch.arange(8.0)[rank:rank + 1]
        out["allreduce"] = col.allreduce(x, "dp").numpy()
        out["allreduce_mean"] = col.allreduce(x, "dp", op="mean").numpy()
        out["allreduce_max"] = col.allreduce(x, "dp", op="max").numpy()
        out["allgather"] = col.allgather(x, "dp", tiled=True).numpy()
        out["reducescatter"] = col.reducescatter(
            torch.arange(16.0) * (rank + 1), "dp").numpy()
        out["broadcast"] = col.broadcast(x, "dp", src_index=3).numpy()
        out["shift_right"] = col.shift_right(x, "dp").numpy()
        out["shift_left"] = col.shift_left(x, "dp").numpy()
        out["permute_partial"] = col.permute(x, "dp", [(2, 5)]).numpy()
        out["axis_index"] = col.axis_index("dp")
        xg = x.clone().requires_grad_()
        (col.allreduce(xg, "dp") * (rank + 1)).sum().backward()
        out["allreduce_grad"] = xg.grad.numpy()
    with col.mesh_context(make_mesh(MeshConfig(sp=8), device_type="cpu")):
        x = torch.arange(64.0).reshape(8, 8)[rank:rank + 1]
        out["alltoall"] = col.alltoall(x, "sp", split_axis=1,
                                       concat_axis=0).numpy()
    with col.mesh_context(make_mesh(MeshConfig(dp=2, tp=4),
                                    device_type="cpu")):
        x = torch.tensor([float(rank)])
        out["allreduce_two_axes"] = col.allreduce(x, ("dp", "tp")).numpy()
        out["allreduce_tp"] = col.allreduce(x, "tp").numpy()
    return out


def world_of_one(inputs):
    """shard_train_step on a world of one against make_train_step, from the
    same params and batch, for each attention of the Llama and for the MoE
    model (under remat, by MOE_RULES): losses and the parameters that
    differ after each of 3 steps."""
    mesh = make_mesh(MeshConfig(), device_type="cpu")
    cases = {attention: (dataclasses.replace(DRYRUN_CFG, attention=attention),
                         inputs["params"], inputs["data"], TRANSFORMER_RULES,
                         llama_loss)
             for attention in inputs["attentions"]}
    moe_case = inputs["moe"]
    cases["moe"] = (moe_case["cfg"], moe_case["params"], moe_case["data"],
                    MOE_RULES, moe_loss)
    out = {}
    for name, (cfg, params, data, rules, loss_fn) in cases.items():
        batch = (torch.from_numpy(data[:, :-1]),
                 torch.from_numpy(data[:, 1:]))
        step = make_train_step(loss_fn)
        plain = init_train_state(
            cfg, adamw(LR), {n: torch.from_numpy(a.copy())
                             for n, a in params.items()}, device="cpu")
        state, specs = init_sharded_state(
            mesh, cfg, {n: torch.from_numpy(a) for n, a in params.items()},
            rules, adamw(LR))
        sharded = shard_train_step(step, mesh, specs,
                                   (P(("dp", "fsdp"), None),) * 2)
        res = out[name] = {
            "mesh": str(state.model.embed.weight.device_mesh), "steps": []}
        for _ in range(3):
            plain, m = step(plain, batch)
            state, ms = sharded(state, batch)
            got = dict(state.model.named_parameters())
            res["steps"].append({
                "loss": (m["loss"].item(), ms["loss"].item()),
                "unequal": sorted(
                    n for n, p in plain.model.named_parameters()
                    if not torch.equal(p, got[n].full_tensor()))})
    return out


def moe(inputs):
    """For each case {"cfg", "mesh", "params", "data"}: a forward without
    grad that records the routing, then one shard_train_step of the MoE
    model laid out by MOE_RULES; the step's loss, every gradient, and
    w_gate's placements and local shape."""
    out = {}
    axes = P(("dp", "fsdp"), None)
    for name, case in inputs.items():
        cfg, data = case["cfg"], case["data"]
        mesh = make_mesh(MeshConfig(**case["mesh"]), device_type="cpu")
        state, specs = init_sharded_state(
            mesh, cfg, {n: torch.from_numpy(a) for n, a in
                        case["params"].items()}, MOE_RULES, adamw(LR))
        wg = state.model.layers[0].moe.w_gate
        lmesh = wg.device_mesh
        batch = (torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:]))
        inter = {}
        with torch.no_grad():
            state.model(distribute(batch[0], lmesh,
                                   spec_placements(axes, lmesh)),
                        intermediates=inter)
        routing = [{k: _full(v) for k, v in
                    inter[f"layers_{i}/moe/routing"].items()}
                   for i in range(cfg.n_layers)]
        step = shard_train_step(make_train_step(moe_loss), mesh, specs,
                                (axes, axes))
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        out[name] = {
            "loss": metrics["loss"].item(), "step_s": time.perf_counter() - t0,
            "grads": {n: _full(p.grad) for n, p in
                      state.model.named_parameters()},
            "routing": routing, "mesh": str(lmesh),
            "w_gate": (str(wg.placements), tuple(wg.to_local().shape))}
    return out if dist.get_rank() == 0 else None


def _family_loss(cfg, model, batch):
    if isinstance(cfg, ViTConfig):
        return vit_loss(model(batch[0]), batch[1])
    if isinstance(cfg, EncoderConfig):
        return mlm_loss(model(batch[0])[1], batch[1], batch[2])
    return cross_entropy_loss(model(batch[0]), batch[1])


def families(inputs):
    """For each case {"cfg", "mesh", "params", "batch"}: one
    shard_train_step of the model laid out by its rules (SSM_RULES for the
    SSM, TRANSFORMER_RULES for the others), the batch over dp and fsdp;
    the step's loss, every gradient, and each parameter's local shape on
    this rank."""
    out = {}
    for name, case in inputs.items():
        cfg = case["cfg"]
        mesh = make_mesh(MeshConfig(**case["mesh"]), device_type="cpu")
        rules = SSM_RULES if isinstance(cfg, SSMConfig) else TRANSFORMER_RULES
        state, specs = init_sharded_state(
            mesh, cfg, {n: torch.from_numpy(a) for n, a in
                        case["params"].items()}, rules, adamw(LR))
        batch = tuple(torch.from_numpy(np.asarray(b)) for b in case["batch"])
        spec = tuple(P(("dp", "fsdp"), *([None] * (b.dim() - 1)))
                     for b in batch)
        step = shard_train_step(make_train_step(
            lambda model, b, cfg=cfg: _family_loss(cfg, model, b)), mesh,
            specs, spec)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        out[name] = {
            "loss": metrics["loss"].item(), "step_s": time.perf_counter() - t0,
            "grads": {n: _full(p.grad) for n, p in
                      state.model.named_parameters()},
            "local": {n: tuple(p.to_local().shape) for n, p in
                      state.model.named_parameters()}}
    return out if dist.get_rank() == 0 else None
