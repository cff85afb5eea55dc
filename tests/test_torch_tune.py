"""Tune and the actor helpers on the port's runtime (ray_tpu_torch.tune,
ray_tpu_torch.util.actor_pool, queue and multiprocessing), on the CPU.

The reference's own tests, ported: every test of tests/test_tune.py and
tests/test_tune_extended.py, tests/test_util.py's ActorPool and Queue
tests and tests/test_ecosystem.py's Pool tests, on one port cluster for
the file (4 CPUs and two declared GPUs, CUDA_VISIBLE_DEVICES "", so no
card is touched). The searchers and schedulers start no runtime: their
variants, suggestions, brackets and perturbations are held equal to the
reference's from the same seeds. Trials at {"CPU": 1, "GPU": 0.5} each
lease a share of one declared card.

The functions the cluster's workers run are closures, pickled by value:
a module-level function of this file pickles by reference, and a worker
would import this module, the reference and jax.
"""

import json
import os
import time
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu import tune as jtune  # noqa: E402
from ray_tpu.tune import schedulers as jsched  # noqa: E402
from ray_tpu.tune import search as jsearch  # noqa: E402
from ray_tpu_torch import tune  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.train import session  # noqa: E402
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: E402
from ray_tpu_torch.train.config import RunConfig  # noqa: E402
from ray_tpu_torch.tune.schedulers import CONTINUE, PB2, STOP  # noqa: E402
from ray_tpu_torch.tune.search import (TPESearcher, _flatten,  # noqa: E402
                                       _unflatten, bohb, generate_variants)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: E402
from ray_tpu_torch.util.multiprocessing import Pool  # noqa: E402
from ray_tpu_torch.util.queue import Empty, Queue  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu", "msgpack",
          "cloudpickle")


@pytest.fixture(scope="module")
def rt():
    cfg = PortConfig()
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2}, config=cfg)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _worker_fns():
    """The functions the Pool's workers and the trials run, made here so
    that they pickle by value."""

    def sq(x):
        return x * x

    def add(a, b):
        return a + b

    def process_state():
        import sys

        import torch

        return {"packages": sorted({m.split(".")[0] for m in sys.modules}),
                "cuda_initialized": torch.cuda.is_initialized()}

    return sq, add, process_state


_sq, _add, _process_state = _worker_fns()


class _FakeTrial:
    def __init__(self, tid, config=None):
        self.trial_id = tid
        self.config = config or {}
        self.last_metric = None
        self.resources = None
        self.pending_resources = None


# ---------------- tests/test_tune.py ----------------

def test_generate_variants_grid_and_samples():
    space = {"lr": tune.grid_search([0.1, 0.01]), "wd": tune.uniform(0, 1)}
    variants = generate_variants(space, num_samples=3, seed=0)
    assert len(variants) == 6
    assert {v["lr"] for v in variants} == {0.1, 0.01}
    assert all(0 <= v["wd"] <= 1 for v in variants)


def test_basic_tune_run(rt):
    def trainable(config):
        session.report({"score": config["x"] ** 2})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 9


def test_trial_error_captured(rt):
    def trainable(config):
        if config["x"] == 2:
            raise ValueError("bad trial")
        session.report({"score": config["x"]})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(grid.errors) == 1
    assert grid.get_best_result().config["x"] == 1


def test_asha_early_stops(rt):
    def trainable(config):
        import time

        for i in range(12):
            session.report({"acc": config["quality"] * (i + 1)})
            # Slow enough that the controller's poll loop can early-stop
            # weak trials before they finish on their own.
            time.sleep(0.25)

    sched = tune.ASHAScheduler(metric="acc", mode="max", max_t=12,
                               grace_period=2, reduction_factor=2)
    # Strong trials first: ASHA is asynchronous, so a weak trial that
    # reaches every rung before any strong result is recorded never stops.
    grid = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([1.0, 0.9, 0.2, 0.1])},
        tune_config=tune.TuneConfig(metric="acc", mode="max", scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    best = grid.get_best_result()
    assert best.config["quality"] in (0.9, 1.0)
    # The weakest trial should have been stopped before 12 iterations.
    histories = sorted(len(r.metrics_history) for r in grid)
    assert histories[0] < 12


def test_pbt_exploits_checkpoint(rt, tmp_path):
    def trainable(config):
        import os

        # Restore cloned weight if PBT gave us a checkpoint.
        w = 0.0
        if config.get("_checkpoint_path"):
            w = float(np.asarray(
                Checkpoint(config["_checkpoint_path"]).to_pytree()["w"]))
        for i in range(10):
            w += config["lr"]
            ck = Checkpoint.from_pytree(
                {"w": np.float64(w)},
                os.path.join(config["dir"], f"ck_{session.get_world_rank()}_"
                                            f"{os.getpid()}_{i}"))
            session.report({"w": w}, checkpoint=ck)

    sched = tune.PopulationBasedTraining(
        metric="w", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 1.0]}, quantile_fraction=0.5,
        seed=0)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.1, 1.0]),
                     "dir": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="w", mode="max", scheduler=sched,
                                    max_concurrent_trials=2),
    ).fit()
    best = grid.get_best_result()
    assert best.metrics["w"] >= 3.0  # the strong trial made progress
    assert len(grid) == 2


def test_tuner_experiment_resume(rt, tmp_path):
    """Experiment state persists; Tuner.restore re-runs only unfinished
    trials, restoring them from their last checkpoint (reference:
    Tuner.restore + experiment_state.py)."""
    marker = tmp_path / "ran.jsonl"

    def trainable(config):
        import json
        import os

        w = 0.0
        if config.get("_checkpoint_path"):
            w = float(np.asarray(
                Checkpoint(config["_checkpoint_path"]).to_pytree()["w"]))
        with open(marker, "a") as f:
            f.write(json.dumps({"lr": config["lr"], "start_w": w}) + "\n")
        for i in range(3):
            w += config["lr"]
            ck = Checkpoint.from_pytree(
                {"w": np.float64(w)},
                os.path.join(config["dir"],
                             f"r_{config['lr']}_{os.getpid()}_{i}"))
            session.report({"w": w}, checkpoint=ck)

    exp_dir = str(tmp_path / "exp")
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([1.0, 2.0]),
                     "dir": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="w", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path), name="exp"),
    ).fit()
    assert len(grid) == 2
    state_file = os.path.join(exp_dir, "experiment_state.json")
    assert os.path.exists(state_file)

    # Simulate an interruption: mark one finished trial as RUNNING.
    with open(state_file) as f:
        state = json.load(f)
    assert all(t["status"] == "TERMINATED" for t in state["trials"])
    state["trials"][1]["status"] = "RUNNING"
    with open(state_file, "w") as f:
        json.dump(state, f)

    runs_before = len(marker.read_text().splitlines())
    grid2 = tune.Tuner.restore(exp_dir, trainable).fit()
    runs_after = len(marker.read_text().splitlines())
    # Only the interrupted trial re-ran...
    assert runs_after == runs_before + 1
    # ...and it resumed from its checkpoint, not from zero.
    last = json.loads(marker.read_text().splitlines()[-1])
    assert last["start_w"] > 0.0
    assert len(grid2) == 2
    best = grid2.get_best_result()
    assert best.metrics["w"] >= 6.0


# ---------------- tests/test_tune_extended.py ----------------

def test_hyperband_brackets_stagger_and_halve():
    sched = tune.HyperBandScheduler(metric="score", max_t=27,
                                    reduction_factor=3)
    trials = [_FakeTrial(f"t{i}") for i in range(6)]
    # Trials land in different brackets round-robin → different first
    # milestones (bracket 0 halves at t=1, bracket 1 first at t=3...).
    assert sched._bracket_of(trials[0]) != sched._bracket_of(trials[1])
    # Bracket-0 rung at t=1: first reporter sets the bar; a much worse
    # later report at the same rung stops.
    b0 = [t for t in trials if sched._bracket_of(t) == 0]
    assert sched.on_result(b0[0], 10.0, 1) == CONTINUE
    decisions = [sched.on_result(t, 0.1 * i, 1) for i, t in enumerate(b0[1:])]
    assert STOP in decisions
    # Reaching max_t always stops.
    assert sched.on_result(b0[0], 99.0, 27) == STOP


def test_flatten_roundtrip():
    d = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}
    assert _unflatten(_flatten(d)) == d


def test_tpe_searcher_converges_toward_good_region():
    space = {"x": tune.uniform(-10, 10), "fixed": 7}
    s = TPESearcher(space, metric="score", mode="max", num_samples=40,
                    n_initial=10, seed=0)
    # Feed observations: score = -(x-3)^2 — optimum at x=3.
    for i in range(40):
        cfg = s.suggest(f"t{i}")
        if cfg is None:
            break
        assert cfg["fixed"] == 7
        x = cfg["x"]
        s.on_trial_complete(f"t{i}", cfg, -(x - 3.0) ** 2)
    late = [s.suggest(f"late{i}") for i in range(5)]
    # Suggestion budget exhausted → None.
    assert all(c is None for c in late)
    # The model-based suggestions should cluster near x=3 far better than
    # uniform(-10,10) would: check mean |x-3| of the last 10 suggestions.
    xs = [o[0]["x"] for o in s.observations[-10:]]
    assert np.mean(np.abs(np.array(xs) - 3.0)) < 4.0


def test_tpe_in_tuner_finds_minimum(rt):
    def objective(config):
        session.report({"loss": (config["lr"] - 0.01) ** 2})

    searcher = TPESearcher({"lr": tune.loguniform(1e-4, 1.0)},
                           metric="loss", mode="min", num_samples=12,
                           n_initial=6, seed=1)
    tuner = tune.Tuner(
        objective,
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    search_alg=searcher,
                                    max_concurrent_trials=3))
    results = tuner.fit()
    assert len(results) == 12
    best = results.get_best_result()
    assert best.metrics["loss"] < 0.05


def test_resource_changing_scheduler(rt):
    """Trials start at 1 CPU; after 2 reports the allocator doubles them —
    the trial restarts from checkpoint with the new allocation."""

    def allocator(trial, metric_value, iteration):
        if iteration >= 2:
            return {"CPU": 2}
        return None

    def trainable(config):
        for step in range(4):
            session.report({"step": step, "score": float(step)},
                           checkpoint={"step": step})

    sched = tune.ResourceChangingScheduler(
        resources_allocation_function=allocator)
    tuner = tune.Tuner(
        trainable,
        param_space={"a": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched))
    results = tuner.fit()
    assert len(results) == 2
    assert not results.errors
    for r in results:
        assert r.metrics["score"] >= 0.0


def test_pg_per_trial_bundles(rt):
    """A list of bundles as resources_per_trial reserves a placement
    group per trial (reference: tune PlacementGroupFactory); the trial
    actor runs in bundle 0 and the trainable receives the PG to place
    sub-workers into the rest."""

    def trainable(config):
        import ray_tpu_torch

        pg = config["_trial_pg"]
        assert len(pg.bundle_specs) == 2

        @ray_tpu_torch.remote(num_cpus=1, placement_group=pg,
                              placement_group_bundle_index=1)
        def sub():
            return 7

        session.report({"sub": ray_tpu_torch.get(sub.remote(), timeout=60)})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="sub", mode="max",
                                    max_concurrent_trials=1),
        resources_per_trial=[{"CPU": 1}, {"CPU": 1}])
    results = tuner.fit()
    assert len(results) == 2 and not results.errors
    assert all(r.metrics["sub"] == 7 for r in results)
    # PGs are removed with their trials.
    from ray_tpu_torch.util.placement_group import placement_group_table

    table = placement_group_table()
    assert all(p.get("state") == "REMOVED" for p in table) or not table


def test_pb2_model_guided_perturbation():
    """PB2 unit: with history showing higher lr -> bigger improvement, the
    GP-UCB explore step proposes lr in the upper region of the bounds."""

    class _T:
        def __init__(self, tid, lr):
            self.trial_id = tid
            self.config = {"lr": lr}

    sched = PB2(metric="reward", mode="max", perturbation_interval=2,
                hyperparam_bounds={"lr": [0.0, 1.0]}, seed=0)
    # Feed deltas: improvement proportional to lr.
    for step in range(6):
        for i, lr in enumerate([0.1, 0.5, 0.9]):
            t = _T(f"t{i}", lr)
            sched.on_result(t, metric_value=step * lr, iteration=step)
    new = [sched.perturb({"lr": 0.1})["lr"] for _ in range(5)]
    assert all(0.0 <= v <= 1.0 for v in new)
    assert np.mean(new) > 0.45, f"model should favor high lr, got {new}"


def test_pb2_in_tuner(rt, tmp_path):
    def trainable(config):
        import os

        w = 0.0
        if config.get("_checkpoint_path"):
            w = float(np.asarray(
                Checkpoint(config["_checkpoint_path"]).to_pytree()["w"]))
        for i in range(8):
            w += config["lr"]
            ck = Checkpoint.from_pytree(
                {"w": np.float64(w)},
                os.path.join(config["dir"],
                             f"pb2_{os.getpid()}_{i}"))
            session.report({"w": w}, checkpoint=ck)

    sched = tune.PB2(metric="w", mode="max", perturbation_interval=3,
                     hyperparam_bounds={"lr": [0.05, 1.0]},
                     quantile_fraction=0.5, seed=0)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.05, 1.0]),
                     "dir": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="w", mode="max", scheduler=sched,
                                    max_concurrent_trials=2),
    ).fit()
    assert grid.get_best_result().metrics["w"] >= 2.0
    assert len(grid) == 2


def test_bohb_factory_in_tuner(rt):
    """BOHB = TPE searcher + HyperBand budgets driving one Tuner run."""

    def objective(config):
        for i in range(8):
            session.report(
                {"loss": (config["lr"] - 0.01) ** 2 + 0.1 / (i + 1)})

    searcher, scheduler = bohb({"lr": tune.loguniform(1e-4, 1.0)},
                               metric="loss", mode="min", num_samples=8,
                               max_t=8, seed=2)
    results = tune.Tuner(
        objective,
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    search_alg=searcher,
                                    scheduler=scheduler,
                                    max_concurrent_trials=2)).fit()
    assert len(results) == 8
    assert results.get_best_result().metrics["loss"] < 0.3


def test_external_searcher_adapter(rt):
    """Any ask/tell pair drives the Tuner through ExternalSearcher."""
    suggested, observed = [], []

    def ask():
        if len(suggested) >= 4:
            return None
        cfg = {"x": 0.25 * len(suggested)}
        suggested.append(cfg)
        return cfg

    def tell(config, value):
        observed.append((config["x"], value))

    def objective(config):
        session.report({"score": -abs(config["x"] - 0.5)})

    searcher = tune.ExternalSearcher(ask, tell)
    results = tune.Tuner(
        objective,
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    search_alg=searcher,
                                    max_concurrent_trials=2)).fit()
    assert len(results) == 4 and len(observed) == 4
    assert results.get_best_result().config["x"] == 0.5


# ---------------- tests/test_util.py: ActorPool, Queue ----------------

def test_actor_pool(rt):
    @rt.remote
    class Doubler:
        def double(self, x):
            return x * 2

    pool = ActorPool([Doubler.remote(), Doubler.remote()])
    out = list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4]))
    assert out == [2, 4, 6, 8]


def test_queue(rt):
    q = Queue(maxsize=3)
    q.put("a")
    q.put("b")
    assert q.qsize() == 2
    assert q.get() == "a"
    assert q.get() == "b"
    with pytest.raises(Empty):
        q.get_nowait()


# ---------------- tests/test_ecosystem.py: Pool ----------------

@pytest.fixture
def pool(rt):
    p = Pool(processes=2)
    yield p
    p.terminate()


def test_pool_map(pool):
    assert pool.map(_sq, range(10)) == [x * x for x in range(10)]


def test_pool_map_chunked(pool):
    assert pool.map(_sq, range(7), chunksize=3) == [x * x for x in range(7)]


def test_pool_apply(pool):
    assert pool.apply(_add, (2, 3)) == 5
    res = pool.apply_async(_add, (4, 5))
    res.wait(timeout=30)
    assert res.ready()
    assert res.get() == 9


def test_pool_starmap(pool):
    assert pool.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]


def test_pool_imap(pool):
    assert list(pool.imap(_sq, range(5), chunksize=2)) == [0, 1, 4, 9, 16]
    assert sorted(pool.imap_unordered(_sq, range(5), chunksize=2)) == \
        sorted([0, 1, 4, 9, 16])


def test_pool_lifecycle(rt):
    p = Pool(processes=1)
    p.close()
    with pytest.raises(ValueError):
        p.map(_sq, [1])
    p.join()


def test_pool_context_manager(rt):
    with Pool(processes=1) as p:
        assert p.map(_sq, [3]) == [9]


# ---------------- the port against the reference ----------------

SPACE = {"lr": tune.loguniform(1e-4, 1e-1), "layers": tune.randint(1, 5),
         "act": tune.choice(["relu", "tanh", "gelu"]),
         "q": tune.quniform(0.0, 1.0, 0.25),
         "nest": {"wd": tune.uniform(0, 1),
                  "grid": tune.grid_search([8, 16, 32])}, "fixed": 3}
J_SPACE = {"lr": jtune.loguniform(1e-4, 1e-1), "layers": jtune.randint(1, 5),
           "act": jtune.choice(["relu", "tanh", "gelu"]),
           "q": jtune.quniform(0.0, 1.0, 0.25),
           "nest": {"wd": jtune.uniform(0, 1),
                    "grid": jtune.grid_search([8, 16, 32])}, "fixed": 3}


def test_variants_and_suggestions_match_reference():
    """generate_variants, BasicVariantGenerator and TPESearcher.suggest
    (its random phase and its model phase, with the same observations)
    give the reference's configs from the same seeds."""
    for seed in (0, 7):
        assert generate_variants(SPACE, 4, seed) == \
            jsearch.generate_variants(J_SPACE, 4, seed)
    got = tune.BasicVariantGenerator(SPACE, 2, seed=3)
    want = jtune.BasicVariantGenerator(J_SPACE, 2, seed=3)
    for i in range(7):
        assert got.suggest(f"t{i}") == want.suggest(f"t{i}")
    space = {k: v for k, v in SPACE.items() if k != "nest"}
    j_space = {k: v for k, v in J_SPACE.items() if k != "nest"}
    got = TPESearcher(space, metric="m", mode="min", num_samples=20,
                      n_initial=5, seed=11)
    want = jsearch.TPESearcher(j_space, metric="m", mode="min",
                               num_samples=20, n_initial=5, seed=11)
    for i in range(22):
        g, w = got.suggest(f"t{i}"), want.suggest(f"t{i}")
        assert g == w, i
        if w is not None:
            value = (np.log10(w["lr"]) + 2.5) ** 2 + 0.1 * w["layers"]
            got.on_trial_complete(f"t{i}", g, value)
            want.on_trial_complete(f"t{i}", w, value)


def test_schedulers_match_reference():
    """HyperBand's brackets, milestones and decisions, ASHA's rungs,
    MedianStoppingRule's and PBT's decisions, and PB2's GP-guided
    perturbation (cold start and model phase) are the reference's for
    the same results and seeds."""
    rng = np.random.default_rng(0)
    pairs = [(tune.HyperBandScheduler(metric="s", max_t=27,
                                      reduction_factor=3),
              jtune.HyperBandScheduler(metric="s", max_t=27,
                                       reduction_factor=3)),
             (tune.ASHAScheduler(metric="s", max_t=16, grace_period=1,
                                 reduction_factor=2),
              jtune.ASHAScheduler(metric="s", max_t=16, grace_period=1,
                                  reduction_factor=2)),
             (tune.MedianStoppingRule(metric="s", grace_period=2),
              jtune.MedianStoppingRule(metric="s", grace_period=2))]
    trials = [_FakeTrial(f"t{i}") for i in range(9)]
    for got, want in pairs:
        for it in range(1, 28):
            for t in trials:
                v = float(rng.normal())
                assert got.on_result(t, v, it) == want.on_result(t, v, it)
    hb_got, hb_want = pairs[0]
    assert hb_got.brackets == hb_want.brackets
    assert [hb_got._milestones(s) for s in range(hb_got.s_max)] == \
        [hb_want._milestones(s) for s in range(hb_want.s_max)]
    assert pairs[1][0].rungs == pairs[1][1].rungs

    bounds = {"lr": [1e-4, 1e-1], "momentum": [0.5, 0.99]}
    got = PB2(metric="r", mode="max", perturbation_interval=2,
              hyperparam_bounds=bounds, seed=5)
    want = jsched.PB2(metric="r", mode="max", perturbation_interval=2,
                      hyperparam_bounds=bounds, seed=5)
    cfg = {"lr": 0.01, "momentum": 0.9}
    assert got.perturb(cfg) == want.perturb(cfg)         # cold start
    pop = [_FakeTrial(f"p{i}", {"lr": float(lr), "momentum": float(m)})
           for i, (lr, m) in enumerate(rng.uniform([1e-4, 0.5],
                                                   [1e-1, 0.99], (4, 2)))]
    for it in range(1, 7):
        for t in pop:
            v = float(it * t.config["lr"] * 10 + rng.normal() * 0.01)
            assert got.on_result(t, v, it) == want.on_result(t, v, it)
    for _ in range(3):
        assert got.perturb(cfg) == want.perturb(cfg)     # the GP's pick
    mut = {"lr": [0.1, 0.01, 0.001], "wd": tune.uniform(0, 1)}
    j_mut = {"lr": [0.1, 0.01, 0.001], "wd": jtune.uniform(0, 1)}
    got = tune.PopulationBasedTraining(metric="r", hyperparam_mutations=mut,
                                       seed=9)
    want = jtune.PopulationBasedTraining(metric="r",
                                         hyperparam_mutations=j_mut, seed=9)
    for _ in range(6):
        c = {"lr": 0.01, "wd": 0.5, "other": 2}
        assert got.perturb(c) == want.perturb(c)
        assert got.exploit_target(pop[3], pop).trial_id == \
            want.exploit_target(pop[3], pop).trial_id


def test_optuna_search_needs_optuna():
    """Without the optuna package OptunaSearch raises ImportError, as the
    reference's does."""
    try:
        import optuna  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="optuna"):
            tune.OptunaSearch({"x": tune.uniform(0, 1)}, metric="m")
    else:
        assert tune.OptunaSearch({"x": tune.uniform(0, 1)}, metric="m")


def test_exports_match_reference():
    assert tune.__all__ == jtune.__all__
    from ray_tpu.util import multiprocessing as jmp

    assert ray_tpu_torch.util.multiprocessing.__all__ == jmp.__all__


# ---------------- trials on GPU leases ----------------

def test_trials_lease_shares_of_cards(rt):
    """Four trials at {"CPU": 1, "GPU": 0.5} on two declared cards, held
    at once: each sees one card id in CUDA_VISIBLE_DEVICES and in
    get_accelerator_ids(), no trial makes a CUDA context, two trials
    share each card, and every share is back in the pool after fit()."""

    @rt.remote(num_cpus=0)
    class Meet:
        def __init__(self):
            self.n = 0

        def arrive(self):
            self.n += 1

        def count(self):
            return self.n

    meet = Meet.options(name="tune_meet").remote()
    rt.get(meet.count.remote())

    def trainable(config):
        import os
        import time

        import torch

        import ray_tpu_torch

        m = ray_tpu_torch.get_actor("tune_meet")
        ray_tpu_torch.get(m.arrive.remote())
        deadline = time.monotonic() + 30
        while ray_tpu_torch.get(m.count.remote()) < 4 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        session.report({
            "visible": os.environ["CUDA_VISIBLE_DEVICES"],
            "ids": ray_tpu_torch.get_runtime_context()
            .get_accelerator_ids()["GPU"],
            "met": ray_tpu_torch.get(m.count.remote()),
            "cuda": torch.cuda.is_initialized()})

    try:
        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([0, 1, 2, 3])},
            tune_config=tune.TuneConfig(max_concurrent_trials=4),
            resources_per_trial={"CPU": 1, "GPU": 0.5}).fit()
    finally:
        rt.kill(meet)
    assert not grid.errors
    seen = [r.metrics for r in grid]
    assert all(m["met"] == 4 for m in seen)
    assert all(m["visible"] in ("0", "1") and m["ids"] == [m["visible"]]
               and not m["cuda"] for m in seen)
    assert Counter(m["visible"] for m in seen) == {"0": 2, "1": 2}
    deadline = time.monotonic() + 10
    while rt.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_helper_processes_load_no_banned_package(rt):
    """A Pool worker and a trial without a GPU demand make no CUDA
    context and load neither jax nor the reference nor cloudpickle; a
    trial without a GPU lease sees no card."""
    with Pool(processes=1) as p:
        state = p.apply(_process_state)
    assert not state["cuda_initialized"]
    assert not set(state["packages"]) & set(BANNED), state["packages"]

    def trainable(config):
        import os

        session.report({**_process_state(),
                        "visible": os.environ["CUDA_VISIBLE_DEVICES"]})

    m = tune.Tuner(trainable).fit()[0].metrics
    assert not m["cuda_initialized"] and m["visible"] == ""
    assert not set(m["packages"]) & set(BANNED), m["packages"]
