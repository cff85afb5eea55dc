"""Tuner + trial controller. Port of ray_tpu/tune/tuner.py.

Parity: reference python/ray/tune/tuner.py:59 (Tuner) and
tune/execution/tune_controller.py (the event loop managing trials as
actors). Trials run as TrainWorker actors (the same session/report
machinery Train uses — the reference likewise runs trainers as Tune
trials, base_trainer.py:877); the controller polls reports, applies the
scheduler (ASHA early-stopping, PBT exploit/explore with checkpoint
cloning), and collects a ResultGrid.

A trial's "GPU" in resources_per_trial (a whole card or a share of
one, {"CPU": 1, "GPU": 0.25}) is its TrainWorker's lease: the raylet
takes it from its card free list and pins the worker's
CUDA_VISIBLE_DEVICES to that card, so the trainable finds its card in
get_runtime_context().get_accelerator_ids() and as cuda:0. The worker
makes no CUDA context until the trainable does.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.worker_group import TrainWorker
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import (CONTINUE, EXPLOIT, STOP,
                                           FIFOScheduler)
from ray_tpu_torch.tune.search import generate_variants


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    scheduler: Any = None
    search_alg: Any = None   # a tune.search.Searcher; None = expand upfront
    seed: int | None = None


class Trial:
    def __init__(self, trial_id: str, config: dict):
        self.trial_id = trial_id
        self.config = config
        self.status = "PENDING"
        self.actor = None
        self.iteration = 0
        self.last_metric: float | None = None
        self.metrics_history: list[dict] = []
        self.checkpoint: Checkpoint | None = None
        self.error: str | None = None
        self.resources: dict | None = None       # None = controller default
        self.pending_resources: dict | None = None  # set by REALLOCATE

    def best_metric(self, metric: str, mode: str):
        vals = [m[metric] for m in self.metrics_history if metric in m]
        if not vals:
            return None
        return max(vals) if mode == "max" else min(vals)


@dataclass
class TrialResult:
    config: dict
    metrics: dict
    checkpoint: Checkpoint | None
    error: str | None
    metrics_history: list = field(default_factory=list)


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric: str | None,
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: str | None = None,
                        mode: str | None = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required")
        scored = [r for r in self._results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise ValueError("no successful trials with metric " + metric)
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([{**r.metrics, **{f"config/{k}": v
                                              for k, v in r.config.items()}}
                             for r in self._results])

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: RunConfig | None = None,
                 resources_per_trial: dict | None = None,
                 _restored_trials: list | None = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._resources = resources_per_trial or {"CPU": 1}
        self._restored_trials = _restored_trials

    def _experiment_dir(self) -> str | None:
        rc = self.run_config
        if rc.storage_path is None:
            return None
        import os

        d = os.path.join(rc.storage_path, rc.name or "tune_experiment")
        os.makedirs(d, exist_ok=True)
        return d

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                *, resume_errored: bool = False) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        Tuner.restore + tune/execution/experiment_state.py).  Finished
        trials keep their recorded results; unfinished (and optionally
        errored) trials re-run, restoring from their last checkpoint."""
        import json
        import os

        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        trials = []
        for ts in state["trials"]:
            t = Trial(ts["trial_id"], ts["config"])
            t.status = ts["status"]
            t.iteration = ts["iteration"]
            t.metrics_history = ts["metrics_history"]
            t.error = ts.get("error")
            if ts.get("checkpoint_path"):
                t.checkpoint = Checkpoint(ts["checkpoint_path"])
            if t.status in ("PENDING", "RUNNING", "PAUSED") or \
                    (resume_errored and t.status == "ERROR"):
                t.status = "PENDING"
                t.error = None
            trials.append(t)
        tc = TuneConfig(**state.get("tune_config", {}))
        from ray_tpu_torch._private import serialization as _ser

        sched_path = os.path.join(path, "scheduler.pkl")
        if os.path.exists(sched_path):
            with open(sched_path, "rb") as f:
                tc.scheduler = _ser.loads_func(f.read())
        searcher_path = os.path.join(path, "searcher.pkl")
        if os.path.exists(searcher_path):
            with open(searcher_path, "rb") as f:
                tc.search_alg = _ser.loads_func(f.read())
        rc = RunConfig(storage_path=os.path.dirname(path.rstrip("/")),
                       name=os.path.basename(path.rstrip("/")))
        return cls(trainable, param_space=state.get("param_space", {}),
                   tune_config=tc, run_config=rc,
                   resources_per_trial=state.get("resources"),
                   _restored_trials=trials)

    def fit(self) -> ResultGrid:
        searcher = self.tune_config.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            trials = []  # created lazily from searcher.suggest()
        else:
            cfgs = generate_variants(self._param_space,
                                     self.tune_config.num_samples,
                                     self.tune_config.seed)
            trials = [Trial(f"trial_{i:04d}_{uuid.uuid4().hex[:6]}", c)
                      for i, c in enumerate(cfgs)]
        scheduler = self.tune_config.scheduler or FIFOScheduler()
        metric = self.tune_config.metric
        default_conc = max(1, len(trials)) if searcher is None else 2
        max_conc = self.tune_config.max_concurrent_trials or default_conc
        controller = _TuneController(
            self._trainable, trials, scheduler, metric,
            self.tune_config.mode, max_conc, self._resources,
            searcher=searcher,
            experiment_dir=self._experiment_dir(),
            experiment_state={
                "param_space": self._param_space,
                "tune_config": {
                    "metric": metric, "mode": self.tune_config.mode,
                    "num_samples": self.tune_config.num_samples,
                    "max_concurrent_trials":
                        self.tune_config.max_concurrent_trials,
                    "seed": self.tune_config.seed},
                "resources": self._resources})
        controller.run()
        results = [TrialResult(
            config=t.config,
            metrics=t.metrics_history[-1] if t.metrics_history else {},
            checkpoint=t.checkpoint, error=t.error,
            metrics_history=t.metrics_history) for t in trials]
        return ResultGrid(results, metric, self.tune_config.mode)


class _TuneController:
    """Polling event loop (reference: tune_controller.py)."""

    def __init__(self, trainable, trials, scheduler, metric, mode,
                 max_concurrent, resources, searcher=None,
                 experiment_dir: str | None = None,
                 experiment_state: dict | None = None):
        self.trainable_blob = serialization.dumps_func(trainable)
        self.trials: list[Trial] = trials
        self.scheduler = scheduler
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent
        self.resources = resources
        self.searcher = searcher
        self.experiment_dir = experiment_dir
        self.experiment_state = experiment_state or {}

    def _notify_searcher(self, trial: Trial) -> None:
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id, trial.config,
                                            trial.last_metric)

    def _next_from_searcher(self) -> Trial | None:
        if self.searcher is None:
            return None
        tid = f"trial_{len(self.trials):04d}_{uuid.uuid4().hex[:6]}"
        cfg = self.searcher.suggest(tid)
        if cfg is None:
            return None
        t = Trial(tid, cfg)
        self.trials.append(t)
        return t

    def _save_experiment_state(self, force: bool = False):
        """Durable experiment snapshot for Tuner.restore, throttled to one
        write per few seconds (reference: experiment_state.py time-based
        periodic checkpointing — per-tick writes would put O(total
        reports) of JSON I/O in the scheduling hot loop)."""
        if self.experiment_dir is None:
            return
        now = time.monotonic()
        if not force and now - getattr(self, "_last_state_save", 0.0) < 5.0:
            return
        self._last_state_save = now
        import json
        import os

        def _plain(x):
            """JSON-safe: numpy scalars → python numbers (default=str
            would silently stringify metrics and break get_best_result
            comparisons after a restore)."""
            if hasattr(x, "item") and not isinstance(x, (str, bytes)):
                try:
                    return x.item()
                except Exception:
                    pass
            return str(x)

        state = dict(self.experiment_state)
        state["trials"] = [{
            "trial_id": t.trial_id, "config": t.config, "status": t.status,
            "iteration": t.iteration, "metrics_history": t.metrics_history,
            "error": t.error,
            "checkpoint_path": t.checkpoint.path if t.checkpoint else None,
        } for t in self.trials]
        tmp = os.path.join(self.experiment_dir, "experiment_state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=_plain)
        os.replace(tmp, os.path.join(self.experiment_dir,
                                     "experiment_state.json"))
        # The scheduler (ASHA rungs, PBT state) and searcher (TPE
        # observations) ride along as pickles so restore resumes under the
        # SAME policy with its accumulated state.
        sched_blob = serialization.dumps_func(self.scheduler)
        with open(os.path.join(self.experiment_dir, "scheduler.pkl"),
                  "wb") as f:
            f.write(sched_blob)
        if self.searcher is not None:
            with open(os.path.join(self.experiment_dir, "searcher.pkl"),
                      "wb") as f:
                f.write(serialization.dumps_func(self.searcher))

    def _start_trial(self, trial: Trial,
                     restore_from: Checkpoint | None = None):
        res = trial.resources or self.resources
        if isinstance(res, (list, tuple)):
            # PlacementGroupFactory-style bundles (reference:
            # tune/execution/placement_groups.py — a PG per trial): the
            # trial actor takes bundle 0; the rest stay reserved for the
            # trainable's own sub-workers via config["_trial_pg"].
            from ray_tpu_torch.util.placement_group import (placement_group,
                                                      remove_placement_group)

            trial.pg = placement_group([dict(b) for b in res],
                                       strategy="PACK")
            try:
                ray_tpu_torch.get(trial.pg.ready(), timeout=120)
            except Exception:
                # Unschedulable (cluster too small / oversubscribed by
                # concurrent trials): release the reservation — a leaked
                # PG would starve every later trial.
                remove_placement_group(trial.pg)
                trial.pg = None
                raise
            b0 = res[0]
            opts = {"num_cpus": b0.get("CPU", 0),
                    "resources": {k: v for k, v in b0.items() if k != "CPU"},
                    "placement_group": trial.pg,
                    "placement_group_bundle_index": 0}
        else:
            trial.pg = None
            opts = {"num_cpus": res.get("CPU", 1),
                    "resources": {k: v for k, v in res.items() if k != "CPU"}}
        trial.actor = TrainWorker.options(**opts).remote(0, 1, {})
        cfg = dict(trial.config)
        if restore_from is not None:
            cfg["_checkpoint_path"] = restore_from.path
        if trial.pg is not None:
            # The trainable places its own sub-workers into the reserved
            # bundles (reference: trials run inside their PG by default).
            cfg["_trial_pg"] = trial.pg
        ray_tpu_torch.get(trial.actor.run.remote(self.trainable_blob, cfg))
        trial.status = "RUNNING"

    def _stop_trial(self, trial: Trial, status: str):
        trial.status = status
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        if getattr(trial, "pg", None) is not None:
            from ray_tpu_torch.util.placement_group import \
                remove_placement_group

            try:
                remove_placement_group(trial.pg)
            except Exception:
                pass
            trial.pg = None

    def run(self):
        # Restored TERMINATED/ERROR trials keep their results; only
        # PENDING ones (fresh or reset by Tuner.restore) run.
        pending = [t for t in self.trials if t.status == "PENDING"]
        running: list[Trial] = []
        searcher_done = False
        self._save_experiment_state()
        while True:
            while len(running) < self.max_concurrent:
                if pending:
                    t = pending.pop(0)
                elif not searcher_done:
                    t = self._next_from_searcher()
                    if t is None:
                        searcher_done = True
                        break
                else:
                    break
                # A restored trial resumes from its last checkpoint. A
                # start failure (unschedulable PG, worker spawn) fails
                # THAT trial; it must not abort the experiment and lose
                # every other trial's results.
                try:
                    self._start_trial(t, restore_from=t.checkpoint)
                except Exception as e:  # noqa: BLE001
                    t.error = f"trial start failed: {type(e).__name__}: {e}"
                    self._stop_trial(t, "ERROR")
                    self._notify_searcher(t)
                    continue
                running.append(t)
            if not running and not pending:
                break
            polls = ray_tpu_torch.get([t.actor.poll.remote() for t in running],
                                timeout=300)
            for trial, p in zip(list(running), polls):
                decision = CONTINUE
                for rep in p["reports"]:
                    m = rep["metrics"]
                    trial.metrics_history.append(m)
                    trial.iteration += 1
                    if rep.get("checkpoint_path"):
                        trial.checkpoint = Checkpoint(rep["checkpoint_path"])
                    if self.metric and self.metric in m:
                        trial.last_metric = m[self.metric]
                        decision = self.scheduler.on_result(
                            trial, m[self.metric], trial.iteration)
                        if decision != CONTINUE:
                            break
                if p["done"]:
                    trial.error = p["error"]
                    self._stop_trial(trial,
                                     "ERROR" if p["error"] else "TERMINATED")
                    running.remove(trial)
                    self._notify_searcher(trial)
                elif decision == STOP:
                    self._stop_trial(trial, "TERMINATED")
                    running.remove(trial)
                    self._notify_searcher(trial)
                elif decision == EXPLOIT:
                    target = self.scheduler.exploit_target(trial, self.trials)
                    if target is not None and target.checkpoint is not None:
                        # PBT exploit: clone checkpoint + perturbed config.
                        self._stop_trial(trial, "PAUSED")
                        trial.config = self.scheduler.perturb(target.config)
                        self._start_trial(trial,
                                          restore_from=target.checkpoint)
                elif decision == sched_mod.REALLOCATE and trial.checkpoint:
                    # ResourceChanging: restart from the last checkpoint
                    # with the scheduler's new allocation.
                    self._stop_trial(trial, "PAUSED")
                    trial.resources = trial.pending_resources
                    trial.pending_resources = None
                    self._start_trial(trial, restore_from=trial.checkpoint)
            self._save_experiment_state()
            if running or pending:
                time.sleep(0.05)
        # Final snapshot must not be lost to the throttle window.
        self._save_experiment_state(force=True)
