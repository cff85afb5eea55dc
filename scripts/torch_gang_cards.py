"""The training gang and the device plane's collective route across the
cards of one host, on the port's runtime (ray_tpu_torch.init()).

1. baseline - chip_smoke.py's training phase on the driver's card:
   TRAIN_CFG (1.2B, bf16), B 2, S 2048, one warm-up and 5 timed steps.
2. device plane - a num_gpus=1 task on one card returns chip_smoke's 64
   MiB bf16 tensor with tensor_transport="device"; a num_gpus=1 actor on
   another card (which it alone sees) gets it by the collective route
   (NCCL send/recv between the two processes): bitwise, its GB/s, and
   the routes each side counted.
3. gang - TorchTrainer(num_workers=2, use_gpu=True, a whole card each):
   one NCCL group over the gang, the driver's seed-0 weights by
   broadcast_weights (the worker on the driver's card by ipc, the other
   by the collective route), and each rank one of the batch's two
   sequences from a split(2) Dataset read with iter_device_batches (its
   landings on the free cards, so by the collective route). Gradients
   are averaged with session.allreduce_gradients; the gang's mean loss
   a step must stay within 2^-8 of the baseline's on the full batch
   (bf16: the halves' GEMMs round otherwise). Tokens/s of the gang
   (both sequences a step) beside the baseline's, the fetch and step ms
   per step, K1 and K1-bwd launches per rank.

4. elastic - chip_smoke.py's elastic gang (phase 18's loop, CKPT_CFG
   0.40B, bf16, the training batch on every rank) on NCCL, one rank a
   card: a cluster_utils.Cluster whose gang nodes each see one card of
   their own (CUDA_VISIBLE_DEVICES), three workers on cards 1-3, rank
   1's node drained (the gang shrinks to 2), then removed and a node on
   card 0, the fourth card, added (the gang grows back to 3, the new
   rank seeded from rank 0). Steps 0-3 on 3 ranks, 4-7 on 2, 8-11 on 3.
   The losses against chip_smoke's uninterrupted run on one card, the
   resizes' seconds, and the route each hand-off took (between cards:
   the collective route, a fresh NCCL pair a pull).

5. rllib - PPO at chip_smoke.py phase 19's config (RLlib's Atari config:
   atari_cnn, hidden 256, on VisualCatch-v0, PPOConfig's defaults) with
   num_learners=4: a LearnerGroup of four learners, a whole card each,
   over NCCL; two iterations. The fingerprints must be equal after every
   update; prints each learner's gradient mean in ms and bytes an
   update, and samples/s and updates/s.

Prints one JSON line with the card's name and power limit; any failure
ends the run non-zero. Run from the repository root on a host with 2 or
more cards (steps 4 and 5 need 4):

    python3 scripts/torch_gang_cards.py

`--cpu` runs steps 3-5 on gloo workers at tiny widths on the CPU
(landings, weights and states by the host route; step 2 needs cards; step
5 at its full widths, its learners on the CPU), a rehearsal without
cards. `--only elastic` runs step 4 alone, `--only rllib` step 5.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
# What the workers run of chip_smoke, by name: the module object itself
# does not pickle.
from chip_smoke import llama_loss, runtime_tensor, same_bits  # noqa: E402

from ray_tpu_torch.models import init_params  # noqa: E402

STEPS = 5


def plane_check(rt) -> dict:
    """Step 2: the collective route between two cards."""
    from ray_tpu_torch._private import device_objects as dobj

    @rt.remote(num_gpus=1)
    class Producer:
        def make(self):
            t = runtime_tensor("cuda")
            torch.cuda.synchronize()
            return t

        def card(self):
            return str(torch.cuda.get_device_properties(0).uuid)

        def routes(self):
            return dobj.counters()

    @rt.remote(num_gpus=1)
    class Consumer:
        def card(self):
            return str(torch.cuda.get_device_properties(0).uuid)

        def take(self, t, t_sent):
            got = time.perf_counter() - t_sent
            want = runtime_tensor("cuda")
            return {"bitwise": same_bits(t, want), "s": got,
                    "routes": dobj.counters()}

    p, c = Producer.remote(), Consumer.remote()
    cards = rt.get([p.card.remote(), c.card.remote()], timeout=300)
    if cards[0] == cards[1]:
        raise AssertionError(f"gang cards: producer and consumer share "
                             f"card {cards[0]}")
    out = {"gb_s": []}
    for _ in range(3):
        ref = p.make.options(tensor_transport="device").remote()
        rt.wait([ref], timeout=300)
        got = rt.get(c.take.remote(ref, time.perf_counter()), timeout=300)
        del ref
        if not got["bitwise"]:
            raise AssertionError("gang cards: the collective route's "
                                 "tensor is not bitwise")
        out["gb_s"].append(64 * 2**20 / got["s"] / 1e9)
    out["consumer_routes"] = {k: got["routes"][k] for k in
                              ("ipc", "collective", "host_fallback")}
    prod = rt.get(p.routes.remote())
    out["producer_routes"] = {k: prod[k] for k in
                              ("ipc_out", "collective_out", "host_out")}
    if out["consumer_routes"]["collective"] != 3 or \
            out["consumer_routes"]["host_fallback"]:
        raise AssertionError(f"gang cards: routes {out}")
    rt.kill(p)
    rt.kill(c)
    return out


def cards_loop(config):
    """Each rank: the broadcast weights, its sequence of each batch, the
    gang's mean of the gradients, AdamW."""
    from ray_tpu_torch._private import device_objects as dobj
    from ray_tpu_torch.data import dataset as data_mod
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.train import adamw, init_train_state, session

    device = config["device"]
    rank = session.get_world_rank()
    state = init_train_state(config["cfg"], adamw(3e-4, weight_decay=0.01),
                             session.get_broadcast_weights(), device=device)
    batches = iter(config["shards"][rank].iter_device_batches(
        batch_size=1, device=device))
    fetch, step_s = [], []
    for i in range(STEPS + 1):
        t0 = time.perf_counter()
        batch = next(batches)
        fetch.append(time.perf_counter() - t0)
        if i == 1:
            fa.reset_launch_counts()
            t_steps = time.perf_counter()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        loss = llama_loss(state.model, (batch["inp"], batch["tgt"]))
        loss.backward()
        session.allreduce_gradients(
            [p.grad for p in state.model.parameters()])
        state.optimizer.step()
        mean = session.allreduce_gradients([loss.detach().float()])[0]
        session.report({"step": i, "loss": mean.item()})
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_steps
    session.report({"step": "end", "rank": rank, "wall_s": wall,
                    "fetch_ms": [x * 1e3 for x in fetch],
                    "step_ms": [x * 1e3 for x in step_s],
                    "launches": dict(fa.launch_counts),
                    "routes": dobj.counters(),
                    "landings": data_mod.landing_counters(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def gang_run(rt, cfg, cpu: bool, baseline: dict) -> dict:
    """Step 3."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    B, S = chip_smoke.TRAIN_B, chip_smoke.TRAIN_S
    rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
    # split(2) cuts the rows in two halves: rank r's are all row r.
    items = [{"tokens": rows[r]} for r in range(2) for _ in range(STEPS + 1)]
    shards = rd.from_items(items).map_batches(chip_smoke.gang_inputs) \
        .split(2)
    device = "cpu" if cpu else None
    weights = init_params(cfg, seed=0, device=device)
    trainer = TorchTrainer(
        cards_loop,
        train_loop_config={"cfg": cfg, "shards": shards, "device": device},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=not cpu),
        initial_weights=weights)
    t0 = time.time()
    result = trainer.fit()
    fit_s = time.time() - t0
    ends = [m for m in result.metrics_history if m["step"] == "end"]
    losses = [m["loss"] for m in result.metrics_history
              if m["step"] != "end"]
    end = ends[0]
    out = {"fit_s": fit_s, "losses": losses,
           "baseline_losses": baseline["losses"][:STEPS + 1],
           "weights_received": trainer.weights_received,
           "tokens_per_s": B * S * STEPS / end["wall_s"],
           "baseline_tokens_per_s": baseline["tokens_per_s"],
           "rank0_fetch_ms": end["fetch_ms"], "rank0_step_ms": end["step_ms"],
           "rank0_launches": end["launches"], "rank0_landings":
           end["landings"], "rank0_routes": {k: end["routes"][k] for k in (
               "ipc", "collective", "host_fallback", "in_process")},
           "rank0_visible": end["visible"]}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses,
                                               out["baseline_losses"])]
    out["max_loss_rel"] = max(rel)
    if max(rel) > 2 ** -8 or not losses[-1] < losses[0]:
        raise AssertionError(f"gang cards: losses {losses} against "
                             f"{out['baseline_losses']}")
    want = chip_smoke.flash_launches(cfg, STEPS)
    if not cpu and end["launches"] != want:
        raise AssertionError(f"gang cards: launches {end['launches']} != "
                             f"{want}")
    return out


def cpu_baseline(cfg) -> dict:
    """The single-process steps on the CPU for --cpu."""
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step

    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01), seed=0,
                             device="cpu")
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (chip_smoke.TRAIN_B, chip_smoke.TRAIN_S + 1))
    data = torch.from_numpy(rows)
    batch = (data[:, :-1], data[:, 1:])
    step = make_train_step(llama_loss)
    t0 = time.perf_counter()
    losses = [step(state, batch)[1]["loss"].item() for _ in range(STEPS + 1)]
    return {"losses": losses, "tokens_per_s": chip_smoke.TRAIN_B
            * chip_smoke.TRAIN_S * (STEPS + 1) / (time.perf_counter() - t0)}


def elastic_run(cfg, cpu: bool) -> dict:
    """Step 4: three workers, one card each; 3 -> 2 -> 3."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition
    from ray_tpu_torch.train import ElasticConfig, ScalingConfig, TorchTrainer

    device = "cpu" if cpu else None
    want = chip_smoke.elastic_reference(cfg, device=device)
    cards = (lambda i: "") if cpu else str
    cluster = Cluster(initialize_head=True, connect=True,
                      head_node_args={"cuda_visible_devices": cards(0)})
    try:
        gang = [cluster.add_node(num_cpus=4, resources={"trainer": 1},
                                 cuda_visible_devices=cards(i))
                for i in (1, 2, 3)]
        cluster.wait_for_nodes()
        trainer = TorchTrainer(
            chip_smoke.elastic_loop,
            train_loop_config={"cfg": cfg, "device": device,
                               "plan": chip_smoke.ELASTIC_PLAN},
            scaling_config=ScalingConfig(
                num_workers=3, use_gpu=not cpu,
                resources_per_worker={"trainer": 1},
                elastic=ElasticConfig(min_workers=2, max_workers=3)),
            initial_weights=init_params(cfg, seed=0, device=device))
        holder = {}

        def fit():
            try:
                holder["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001
                holder["error"] = e

        import threading

        th = threading.Thread(target=fit, daemon=True)
        th.start()

        def at_epoch_end(e):
            if "error" in holder:
                raise holder["error"]
            m = trainer.latest_metrics
            return m.get("step") == "epoch" and m.get("epoch") == e

        wait_for_condition(lambda: at_epoch_end(0), timeout=900)
        rank1 = trainer.latest_metrics["workers"][1]["node"]
        victim = next(n for n in gang if n.node_id == rank1)
        t_drain = time.time()
        drain = NodePreempter(cluster, deadline_s=10).preempt(victim,
                                                              kill=False)
        wait_for_condition(lambda: at_epoch_end(1), timeout=600)
        cluster.remove_node(victim)
        cluster.add_node(num_cpus=4, resources={"trainer": 1},
                         cuda_visible_devices=cards(0))
        cluster.wait_for_nodes()
        t_new = time.time()
        th.join(900)
        if th.is_alive() or "error" in holder:
            raise AssertionError(f"gang cards: elastic fit "
                                 f"{holder or 'hung'}")
        hist = holder["result"].metrics_history
    finally:
        cluster.shutdown()
    steps = [h for h in hist if h["step"] != "epoch"]
    epochs = chip_smoke.elastic_summaries(hist)
    losses = [h["loss"] for h in steps]
    first = {e: next(h for h in steps if h["epoch"] == e) for e in (1, 2)}
    t = trainer.telemetry
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    out = {"drain_state": drain.get("state"),
           "worlds": [h["world"] for h in steps], "losses": losses,
           "one_card_losses": want, "bitwise": losses == want,
           "max_loss_rel": max(rel) if rel else None,
           "drain_to_first_step_of_2_s": first[1]["t"] - t_drain,
           "new_node_to_first_step_of_3_s": first[2]["t"] - t_new,
           "resizes": [{k: r[k] for k in ("direction", "lost", "pause_s",
                                          "total_s", "evacuated_in",
                                          "handoffs")}
                       for r in t["resize_log"]],
           "visible": {e: [w["visible"] for w in ws]
                       for e, ws in epochs.items()},
           "telemetry": {k: v for k, v in t.items() if k != "resize_log"}}
    if out["worlds"] != [3] * 4 + [2] * 4 + [3] * 4 or \
            (t["shrinks"], t["grows"], t["elastic_fallbacks"]) != (1, 1, 0) \
            or not rel or max(rel) > 2 ** -8:
        raise AssertionError(f"gang cards: elastic run {out}")
    return out


RL_ITERS = 2


def rllib_run(cpu: bool) -> dict:
    """Step 5: PPO's LearnerGroup of four, a card each, over NCCL."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import PPOConfig

    cfg = PPOConfig(env="VisualCatch-v0", model="atari_cnn", num_learners=4)
    rt.init(num_cpus=8) if cpu else rt.init()
    try:
        algo = cfg.build(device="cpu" if cpu else None)
        try:
            group = algo._learner_group
            want = ("gloo", 0) if cpu else ("nccl", 1)
            if (group.backend, group.num_gpus) != want:
                raise AssertionError(f"gang cards: rllib group on "
                                     f"{group.backend}, {group.num_gpus} "
                                     "of a card a learner")
            real, checks = group.update_shards, []

            def update_shards(shards):
                out = real(shards)
                checks.append(len(set(group.fingerprints())) == 1)
                return out

            group.update_shards = update_shards
            t0 = time.perf_counter()
            results, comms = [], []
            for _ in range(RL_ITERS):
                results.append(algo.train())
                comms.append(group.comm_stats())
            iter_s = time.perf_counter() - t0
            visible = rt.get([a.process_state.remote()
                              for a in algo.workers], timeout=60)
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    learn_s = sum(r["learn_time_s"] for r in results)
    sample_s = sum(r["sample_time_s"] for r in results)
    steps = sum(r["timesteps_this_iter"] for r in results)
    out = {"learners": 4, "backend": group.backend,
           "iterations": RL_ITERS, "iter_s": iter_s, "updates": len(checks),
           "fingerprints_equal_every_update": all(checks),
           "sample_time_s": sample_s, "learn_time_s": learn_s,
           "samples_per_s": steps / sample_s,
           "updates_per_s": len(checks) / learn_s,
           "per_iteration": [{k: r[k] for k in ("sample_time_s",
                                                 "learn_time_s")}
                             for r in results],
           # Each learner's mean over all updates, and over the last
           # iteration's alone (the first allreduce sets NCCL up).
           "grad_mean_ms_per_update": [
               1e3 * c["allreduce_s"] / c["updates"] for c in comms[-1]],
           "grad_mean_ms_per_update_last_iteration": [
               1e3 * (c["allreduce_s"] - p["allreduce_s"])
               / (c["updates"] - p["updates"])
               for c, p in zip(comms[-1], comms[-2])],
           "grad_mean_bytes_per_update": comms[-1][0]["allreduce_bytes"]
           // comms[-1][0]["updates"],
           "rollout_workers_cuda": [v["cuda_initialized"] for v in visible],
           "losses": [{k: r[k] for k in ("loss", "pi_loss", "vf_loss",
                                          "entropy")} for r in results]}
    if not all(checks) or not checks or any(out["rollout_workers_cuda"]) \
            or not all(np.isfinite(v) for r in out["losses"]
                       for v in r.values()):
        raise AssertionError(f"gang cards: rllib run {out}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo workers at tiny widths on the CPU")
    ap.add_argument("--only", choices=("elastic", "rllib"),
                    help="run step 4 or step 5 alone")
    args = ap.parse_args()
    import ray_tpu_torch as rt
    from ray_tpu_torch._vendor import cloudpickle

    # The workers need not import chip_smoke: what they run of it travels.
    cloudpickle.register_pickle_by_value(chip_smoke)

    if args.cpu:
        cfg = dataclasses.replace(
            chip_smoke.TRAIN_CFG, vocab_size=256, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=4, d_ff=128, dtype=torch.float32)
        chip_smoke.TRAIN_S = 32
        card = "cpu"
    else:
        if torch.cuda.device_count() < (4 if args.only else 2):
            sys.exit("torch_gang_cards: needs 2 or more cards (4 for "
                     "steps 4 and 5)")
        cfg = chip_smoke.TRAIN_CFG
        card = chip_smoke.card_line()
        if args.only != "rllib":    # step 5 runs no kernel
            chip_smoke._build.build_all()
    plane = gang = None
    if not args.only:
        if args.cpu:
            baseline = cpu_baseline(cfg)
            rt.init(num_cpus=4)
        else:
            chip_smoke.training_phase(card, steps=STEPS)
            baseline = chip_smoke.TRAINED["training"]
            rt.init()
        try:
            plane = None if args.cpu else plane_check(rt)
            gang = gang_run(rt, cfg, args.cpu, baseline)
        finally:
            rt.shutdown()
    elastic = rllib = None
    four = args.cpu or torch.cuda.device_count() >= 4
    if four and args.only in (None, "elastic"):
        elastic = elastic_run(cfg if args.cpu else chip_smoke.CKPT_CFG,
                              args.cpu)
    if four and args.only in (None, "rllib"):
        rllib = rllib_run(args.cpu)
    print(json.dumps({"card": card, "cards": torch.cuda.device_count(),
                      "device_plane": plane, "gang": gang,
                      "elastic": elastic, "rllib": rllib}), flush=True)


if __name__ == "__main__":
    main()
