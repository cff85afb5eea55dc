"""The port's elastic gang (ray_tpu_torch/train: the trainer's elastic
path, the session's keep_state and voted pause, the worker's kept state
and evacuation preparer), the port of tests/test_elastic_train.py, with
a tiny Llama trained by a gang that goes 2 -> 1 -> 2 held against the
JAX package's full-batch training.

One fake multi-node cluster for the file (ray_tpu_torch.cluster_utils),
with the reference test's fast Config. Each test adds its own gang nodes
(a `trainer` resource), so the driver, the ref owner of every kept pin,
never shares a node with a drain victim. The loops wait for the
resizes the tests drive (they idle at their kept step's boundary, or
step until paused), so no wait depends on the machine's speed.
Worker-side code is defined inside the tests: a closure pickles by
value, and a port worker then never imports this module (or jax).
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu_torch._private import device_objects  # noqa: E402
from ray_tpu_torch._private.config import Config  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition  # noqa: E402
from ray_tpu_torch.train import (ElasticConfig, FailureConfig, RunConfig,  # noqa: E402
                                 ScalingConfig, TorchTrainer)

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
B, S = 4, 16
# The Llama gang's steps by epoch: 0-3 on 2 ranks, 4-6 on 1, 7-8 on 2.
PLAN = {0: 3, 1: 6, 2: 8}
STEPS = PLAN[2] + 1
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)


def _config() -> Config:
    cfg = Config()
    cfg.health_check_period_s = 0.2
    cfg.num_heartbeats_timeout = 5
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.num_workers_soft_limit = 16
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # CPU nodes, whatever the host
    c = Cluster(initialize_head=True, connect=True,
                head_node_args={"num_cpus": 2}, config=_config())
    try:
        yield c
    finally:
        c.shutdown()
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


class _GangNodes:
    """The gang nodes one test adds; all removed when it ends."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.added = []

    def add(self, n: int = 1):
        nodes = [self.cluster.add_node(num_cpus=2, resources={"trainer": 1})
                 for _ in range(n)]
        self.added += nodes
        self.cluster.wait_for_nodes()
        return nodes

    def remove(self, node):
        self.cluster.remove_node(node)

    def close(self):
        gone = {n.node_id for n in self.added}
        for n in self.added:
            if n in self.cluster.nodes:
                self.cluster.remove_node(n)
        # The next test schedules nothing on a node still dying.
        wait_for_condition(lambda: not any(
            n["alive"] and n["node_id"] in gone
            for n in ray_tpu_torch.nodes()), timeout=60)


@pytest.fixture()
def gang_nodes(cluster):
    g = _GangNodes(cluster)
    try:
        yield g
    finally:
        g.close()


def _scaling(n, *, min_workers, max_workers=None, reshard_timeout_s=20.0):
    return ScalingConfig(
        num_workers=n, use_gpu=False,
        resources_per_worker={"trainer": 1.0, "CPU": 0.5},
        elastic=ElasticConfig(min_workers=min_workers,
                              max_workers=max_workers,
                              reshard_timeout_s=reshard_timeout_s,
                              grow_poll_s=0.5))


def _fit_in_thread(trainer):
    holder = {}

    def run():
        try:
            holder["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001
            holder["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, holder


def _finish(th, holder, timeout=180):
    th.join(timeout=timeout)
    assert not th.is_alive(), "fit() did not finish"
    assert "error" not in holder, f"fit raised: {holder.get('error')}"
    return holder["result"]


def _shrink_grow(cluster, nodes: _GangNodes, trainer, victim,
                 ready=lambda: True):
    """Preempt `victim` without killing it, wait for the shrink (and for
    `ready`), remove it, add a node and wait for the grow."""
    drain = NodePreempter(cluster, deadline_s=10).preempt(victim, kill=False)
    assert drain["state"] == "DRAINED"
    wait_for_condition(lambda: trainer.telemetry["shrinks"] >= 1 and ready(),
                       timeout=120)
    nodes.remove(victim)
    nodes.add(1)
    wait_for_condition(lambda: trainer.telemetry["grows"] >= 1, timeout=120)


# ---------------------------------------------------------------------------
# A counter tensor, updated in place: shrink, grow back, and the kept
# state's consistency
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resized(cluster):
    """One fit of a 2-worker gang (no collective group, as the reference's
    test) whose loop updates a tensor IN PLACE in two halves a step, so a
    gather in the middle of a step would read an odd value. Epochs 0 and
    1 step until the resize; epoch 2 takes 4 more steps. A worker raises
    (and fails the fit) if the state it starts from, or a peer's, breaks
    w == 2 (step + 1)."""
    nodes = _GangNodes(cluster)
    try:
        gang = nodes.add(2)
        evac0 = device_objects.counters()["evacuated_in"]

        def loop(cfg):
            import time as _t

            import torch as _torch

            import ray_tpu_torch as _rt
            from ray_tpu_torch.train import session

            node = _rt.get_runtime_context().node_id

            def ok(tree):
                return bool((tree["w"] == 2.0 * (tree["step"] + 1)).all())

            state = session.get_elastic_state()
            peers = session.get_peer_states()
            epoch = session.get_elastic_epoch()
            seeded = state is None and bool(peers)
            if seeded:
                state = peers[0]
            if state is not None and not ok(state):
                raise AssertionError(f"start state {state}")
            bad = {r: p["step"] for r, p in peers.items() if not ok(p)}
            if bad:
                raise AssertionError(f"peer states torn at steps {bad}")
            if state is None:
                # Join at the current wall-clock step, as the reference's
                # loop does: the gang stays within a step of itself.
                step = max(0, int((_t.time() - cfg["t0"]) / cfg["period"]))
                w = _torch.full((8,), 2.0 * step)
            else:
                step, w = state["step"] + 1, state["w"]
            first = step
            while epoch < 2 or step < first + 4:
                w.add_(1.0)
                _t.sleep(cfg["period"] / 4)   # the half-updated window
                w.add_(1.0)
                session.report({"step": step, "world":
                                session.get_world_size(), "epoch": epoch,
                                "node": node,
                                "peers": sorted(peers),
                                "peer_steps": [p["step"] for p in
                                               peers.values()],
                                "seeded": seeded,
                                "restored": session.get_checkpoint()
                                is not None})
                session.keep_state({"step": step, "w": w}, step=step)
                step += 1
                _t.sleep(max(0.0, cfg["t0"] + step * cfg["period"]
                             - _t.time()))
            return float(w[0])

        import time

        trainer = TorchTrainer(
            loop, train_loop_config={"t0": time.time(), "period": 0.05},
            scaling_config=_scaling(2, min_workers=1, max_workers=2),
            collective_backend=None)
        th, holder = _fit_in_thread(trainer)
        wait_for_condition(
            lambda: trainer.latest_metrics.get("step", -1) >= 3, timeout=120)
        # Drain rank 1's node: the one rank 0 does not report from.
        victim = next(n for n in gang
                      if n.node_id != trainer.latest_metrics["node"])
        _shrink_grow(cluster, nodes, trainer, victim)
        result = _finish(th, holder)
        evacuated = device_objects.counters()["evacuated_in"] - evac0
        return trainer, result, evacuated
    finally:
        nodes.close()


def test_elastic_shrink_then_grow_back(resized):
    """The reference's acceptance scenario at 2 workers: a drained member
    is a resize to 1 with zero checkpoint restores, and a new node grows
    the gang back to 2, seeded from rank 0 through the device plane."""
    trainer, result, _ = resized
    hist = result.metrics_history
    worlds = [h["world"] for h in hist]
    assert 1 in worlds and 2 in worlds and hist[-1]["world"] == 2
    assert [h["epoch"] for h in hist][-1] == 2
    # After the shrink the survivor holds the departed rank's tree.
    assert any(h["peers"] == [1] for h in hist if h["world"] == 1)
    assert not any(h["restored"] for h in hist)
    t = trainer.telemetry
    assert (t["shrinks"], t["grows"]) == (1, 1)
    assert t["elastic_fallbacks"] == 0 and t["full_restarts"] == 0
    assert t["steps_lost"] <= 2 * t["resizes"], t["resize_log"]
    steps = [h["step"] for h in hist]
    assert all(b - a >= -2 for a, b in zip(steps, steps[1:]))
    shrink, grow = t["resize_log"]
    assert shrink["direction"] == "shrink" and grow["direction"] == "grow"
    # The grown member pulled rank 0's kept tree (host route on the CPU).
    seed = [h for h in grow["handoffs"] if "new rank" in h["what"]]
    assert seed and seed[0]["bytes"] == 8 * 4
    assert seed[0]["routes"]["host_fallback"] >= 1


def test_rehomed_state_is_the_kept_steps_exactly(resized):
    """The kept tensor is updated in place, in two halves a step. The
    departed rank's tree reached the survivor equal to the state of the
    step it was kept at (every worker checks w == 2 (step + 1) of its own
    and its peers' trees, and the fit would have failed): the drain's
    evacuation parked the loop at its boundary before gathering the
    pins. The tree rode the plane, re-homed to the trainer."""
    trainer, result, evacuated = resized
    after_shrink = [h for h in result.metrics_history if h["peers"] == [1]]
    assert after_shrink and after_shrink[0]["peer_steps"][0] >= 0
    shrink = trainer.telemetry["resize_log"][0]
    to_trainer = [h for h in shrink["handoffs"] if "to the trainer" in
                  h["what"]]
    assert to_trainer and to_trainer[0]["bytes"] == 8 * 4
    routes = to_trainer[0]["routes"]
    # Found in the trainer's registry (the drain evacuated it first) or
    # pulled from the parked worker: either way, never a torn tree.
    assert routes["in_process"] + routes["host_fallback"] >= 1
    assert evacuated >= 1 or routes["host_fallback"] >= 1
    # Nothing the resize re-homed stays pinned in the trainer.
    assert not [e for e in device_objects.registry().entries()
                if e["key"].startswith("elastic:")]


def test_elastic_deadline_falls_back_to_checkpoint(cluster, gang_nodes,
                                                   tmp_path):
    """When the gang cannot reach a step boundary within
    reshard_timeout_s, the elastic path gives up and the retry restores
    from the last checkpoint, counted (elastic_fallbacks, full_restarts).
    At step 3 the worker off the drained node blocks inside a step (no
    boundary), leaving a marker when it does; the one on it waits at a
    report() boundary, so neither runs past step 3's checkpoint."""
    nodes = gang_nodes.add(2)
    marker = tmp_path / "blocked"

    def loop(cfg):
        import os as _os
        import time as _t

        import ray_tpu_torch as _rt
        from ray_tpu_torch.train import session

        ck = session.get_checkpoint()
        start = int(ck.to_dict()["step"]) + 1 if ck is not None else 0
        my_node = _rt.get_runtime_context().node_id
        for step in range(start, cfg["total_steps"]):
            ckpt = {"step": step} if session.get_world_rank() == 0 else None
            session.report({"step": step, "restored": ck is not None},
                           checkpoint=ckpt)
            if step == 3 and ck is None and session.get_elastic_epoch() == 0:
                if my_node != cfg["drain_node"]:
                    open(cfg["marker"], "w").close()
                    _t.sleep(60.0)   # a step with no boundary in reach
                while True:   # the drained worker waits at a boundary
                    _t.sleep(0.05)
                    session.report({"step": step, "restored": False})
            _t.sleep(0.05)

    trainer = TorchTrainer(
        loop, train_loop_config={"total_steps": 8, "marker": str(marker),
                                 "drain_node": nodes[0].node_id},
        scaling_config=_scaling(2, min_workers=1, reshard_timeout_s=1.5),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
        collective_backend=None)
    th, holder = _fit_in_thread(trainer)
    wait_for_condition(marker.exists, timeout=120)
    NodePreempter(cluster, deadline_s=6).preempt(nodes[0])
    gang_nodes.add(1)  # room for the checkpoint-restart gang
    result = _finish(th, holder)
    assert result.metrics["step"] == 7
    assert result.metrics["restored"] is True, (trainer.telemetry,
                                                result.metrics_history)
    assert trainer.telemetry["elastic_fallbacks"] == 1
    assert trainer.telemetry["full_restarts"] == 1
    assert trainer.telemetry["resizes"] == 0


def test_preempter_step_schedule_deterministic():
    """The same seed gives the same preemption schedule."""
    from ray_tpu.test_utils import NodePreempter as JNodePreempter

    def gaps(cls, seed):
        p = cls(None, step_interval=20, step_jitter=0.3, seed=seed,
                step_source=lambda: 0)
        return [p._next_gap() for _ in range(8)]

    assert gaps(NodePreempter, 3) == gaps(NodePreempter, 3)
    assert all(14 <= g <= 26 for g in gaps(NodePreempter, 3))
    assert gaps(NodePreempter, 4) != gaps(NodePreempter, 3)
    # The reference draws the same schedule from the same seed.
    assert gaps(NodePreempter, 3) == gaps(JNodePreempter, 3)


def test_node_killer_kills_and_respawns(cluster, gang_nodes):
    """NodeKiller removes a non-head node at its interval and starts a
    replacement; the cluster's alive count comes back."""
    from ray_tpu_torch.test_utils import NodeKiller

    (victim,) = gang_nodes.add(1)
    alive = len([n for n in ray_tpu_torch.nodes() if n["alive"]])
    before = set(cluster.nodes)
    with NodeKiller(cluster, interval_s=0.2, respawn=True, max_kills=1,
                    node_args={"num_cpus": 1}, seed=0) as killer:
        wait_for_condition(lambda: killer.kills == 1, timeout=60)
    new = [n for n in cluster.nodes if n not in before]
    gang_nodes.added += new
    assert victim not in cluster.nodes and len(new) == 1
    wait_for_condition(lambda: len(
        [n for n in ray_tpu_torch.nodes() if n["alive"]]) == alive,
        timeout=60)


def test_train_worker_stop_joins_user_loop(cluster):
    """TrainWorker.stop(timeout): the stop lands at a step boundary, the
    loop's thread is joined, and the last reports come back with it."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.train.worker_group import TrainWorker
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    def loop(cfg):
        import time as _t

        from ray_tpu_torch.train import session

        for step in range(100_000):
            session.report({"step": step})
            _t.sleep(0.01)

    w = TrainWorker.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=cluster.head_node.node_id)).remote(0, 1, None)
    try:
        ray_tpu_torch.get(w.run.remote(serialization.dumps_func(loop), {}),
                          timeout=60)
        wait_for_condition(
            lambda: ray_tpu_torch.get(w.poll.remote(), timeout=10)["reports"],
            timeout=60)
        out = ray_tpu_torch.get(w.stop.remote(5.0), timeout=30)
        assert out["joined"] is True
        assert out["done"] is True
        assert out["error"] is None  # SessionStopped is shutdown, not failure
        assert out["reports"]
    finally:
        ray_tpu_torch.kill(w)


# ---------------------------------------------------------------------------
# A tiny Llama on gloo, 2 -> 1 -> 2, against JAX's full-batch training
# ---------------------------------------------------------------------------


def _flax_weights(model, seed: int = 0):
    """tests/test_torch_trainer.py's weights: the tree's structure from
    tracing flax's init, each leaf drawn from a numpy seed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape)
        if path[-1].key == "kernel":
            a /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            a = (path[-1].key == "scale") + 0.1 * a
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_losses():
    """Flax weights, the token batches, and JAX's losses over STEPS
    full-batch AdamW steps (its plain attention)."""
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32,
                          attention="reference", remat=False)
    model = jl.LlamaModel(jcfg)
    params = _flax_weights(model)
    tokens = np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], (STEPS, B, S + 1))

    def loss_fn(p, batch):
        inp, tgt = batch
        return jl.cross_entropy_loss(model.apply(p, inp), tgt)

    opt = optax.adamw(3e-4, weight_decay=0.01)
    step = jax.jit(jspmd.make_train_step(loss_fn, opt))
    state = jspmd.TrainState(params, opt.init(params),
                             jnp.zeros((), jnp.int32))
    losses = []
    for i in range(STEPS):
        batch = (jnp.asarray(tokens[i, :, :-1], jnp.int32),
                 jnp.asarray(tokens[i, :, 1:], jnp.int32))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return params, tokens, losses


def test_llama_gang_2_1_2_matches_jax_full_batch(cluster, gang_nodes,
                                                 jax_losses):
    """A gloo gang of 2 trains the tiny Llama (f32, the flash path's plain
    versions) on the full batch on every rank, so the gang's mean
    gradient is the full batch's. It idles at step 3's boundary until
    rank 1's node is drained (2 -> 1), at step 6's until a new node
    joins (1 -> 2, seeded from rank 0), then ends at step 8. Its losses
    by step are JAX's full-batch training's within 1e-4; the state every
    resumed or seeded rank starts from is the kept state of its step,
    bitwise (a digest a tensor, gathered to rank 0); no checkpoint."""
    params, tokens, want = jax_losses
    cfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="flash",
                         remat=False)
    weights = convert.params_from_flax(params, cfg)
    gang_nodes.add(2)

    def loop(config):
        import hashlib
        import time as _t

        import torch as _torch
        import torch.distributed as _dist

        import ray_tpu_torch as _rt
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.train import session, spmd

        def digest(tree):
            h = hashlib.sha256()
            for name in sorted(tree["params"]):
                h.update(tree["params"][name].numpy().tobytes())
            for st in tree["opt"]["state"].values():
                for k in sorted(st):
                    h.update(st[k].numpy().tobytes())
            return h.hexdigest()

        def gathered(value):
            if session.get_world_size() == 1:
                return [value]
            out = [None] * session.get_world_size()
            _dist.all_gather_object(out, value)
            return out

        epoch = session.get_elastic_epoch()
        kept = session.get_elastic_state()
        peers = session.get_peer_states()
        start_tree = kept if kept is not None else peers.get(0)
        opt = spmd.adamw(3e-4, weight_decay=0.01)
        if start_tree is None:
            state = spmd.init_train_state(
                config["cfg"], opt,
                {n: t.clone() for n, t in
                 session.get_broadcast_weights().items()}, device="cpu")
            first = 0
        else:
            state = spmd.init_train_state(
                config["cfg"], opt,
                {n: t.clone() for n, t in start_tree["params"].items()},
                device="cpu")
            state.optimizer.load_state_dict(start_tree["opt"])
            first = start_tree["step"] + 1
        start = {"epoch": epoch, "first": first,
                 "node": _rt.get_runtime_context().node_id,
                 "start_digest": digest(start_tree) if start_tree else None,
                 "peer_digests": {r: digest(p) for r, p in peers.items()},
                 "peer_steps": {r: p["step"] for r, p in peers.items()}}
        starts = gathered(start)
        tok = config["tokens"]
        for step in range(first, config["plan"][epoch] + 1):
            inp = _torch.from_numpy(tok[step, :, :-1])
            tgt = _torch.from_numpy(tok[step, :, 1:])
            state.optimizer.zero_grad(set_to_none=True)
            loss = llama.cross_entropy_loss(state.model(inp), tgt)
            loss.backward()
            session.allreduce_gradients(
                {n: p.grad for n, p in state.model.named_parameters()})
            state.optimizer.step()
            session.report({"step": step, "loss": loss.item(),
                            "world": session.get_world_size(),
                            "epoch": epoch, "starts": starts})
            tree = {"step": step,
                    "params": {n: p.detach() for n, p in
                               state.model.named_parameters()},
                    "opt": state.optimizer.state_dict()}
            session.keep_state(tree, step=step)
        if epoch < 2:
            # Idle at the kept step's boundary until the resize pauses
            # the gang (each call is a voted boundary on 2 ranks).
            while True:
                _t.sleep(0.05)
                session.keep_state(tree, step=config["plan"][epoch])

    trainer = TorchTrainer(
        loop, train_loop_config={"cfg": cfg, "tokens": tokens,
                                 "plan": PLAN},
        scaling_config=_scaling(2, min_workers=1, max_workers=2),
        collective_backend="gloo", initial_weights=weights)
    th, holder = _fit_in_thread(trainer)
    wait_for_condition(
        lambda: trainer.latest_metrics.get("step", -1) >= PLAN[0],
        timeout=180)
    first = trainer.latest_metrics
    assert first["world"] == 2
    # Rank 1's node, from the starts rank 0 gathered in this epoch.
    victim_id = first["starts"][1]["node"]
    victim = next(n for n in gang_nodes.added if n.node_id == victim_id)
    # The new node joins once the gang of 1 idles at step 6's boundary.
    _shrink_grow(cluster, gang_nodes, trainer, victim, ready=lambda: (
        trainer.latest_metrics.get("step") == PLAN[1]))
    result = _finish(th, holder)
    hist = result.metrics_history
    assert [h["step"] for h in hist] == list(range(STEPS))
    assert [h["world"] for h in hist] == [2] * 4 + [1] * 3 + [2] * 2
    np.testing.assert_allclose([h["loss"] for h in hist], want, **LOSS_TOL)
    # Shrink: the survivor resumes from its own step-3 state, and the
    # departed rank's tree is the same state bitwise (data parallel).
    (survivor,) = hist[4]["starts"]
    assert survivor["first"] == 4 and survivor["peer_steps"] == {1: 3}
    assert survivor["peer_digests"][1] == survivor["start_digest"]
    # Grow: the new rank 1 starts from rank 0's kept step-6 state.
    rank0, rank1 = hist[7]["starts"]
    assert rank0["first"] == rank1["first"] == 7
    assert rank1["start_digest"] == rank0["start_digest"]
    assert rank1["peer_steps"] == {0: 6}
    t = trainer.telemetry
    assert (t["shrinks"], t["grows"], t["elastic_fallbacks"],
            t["full_restarts"], t["steps_lost"]) == (1, 1, 0, 0, 0)
