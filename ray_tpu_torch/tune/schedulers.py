"""Trial schedulers: FIFO, ASHA, PBT. Port of
ray_tpu/tune/schedulers.py.

Parity: reference python/ray/tune/schedulers/ — ASHA
(async_hyperband.py:19: asynchronous successive halving with rungs at
reduction_factor intervals) and PBT (pbt.py:222; exploit at :881 clones a
better trial's checkpoint and perturbs hyperparams).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"      # PBT: restart from better trial's checkpoint
REALLOCATE = "REALLOCATE"  # ResourceChanging: restart with new resources


class FIFOScheduler:
    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        return CONTINUE

    def exploit_target(self, trial, trials):
        return None


class ASHAScheduler:
    """Async successive halving: at each rung, trials below the top
    1/reduction_factor quantile of completed rung results stop early."""

    def __init__(self, *, metric: str, mode: str = "max", max_t: int = 100,
                 grace_period: int = 1, reduction_factor: int = 4):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> list of recorded metric values
        self.rungs: dict[int, list[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self.milestones = milestones

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        if iteration >= self.max_t:
            return STOP
        for m in self.milestones:
            if iteration == m:
                sign = metric_value if self.mode == "max" else -metric_value
                recorded = self.rungs.setdefault(m, [])
                recorded.append(sign)
                k = max(1, len(recorded) // self.rf)
                top_k = sorted(recorded, reverse=True)[:k]
                if sign < top_k[-1]:
                    return STOP
        return CONTINUE

    def exploit_target(self, trial, trials):
        return None


class PopulationBasedTraining:
    """PBT: every perturbation_interval iterations, bottom-quantile trials
    clone a top-quantile trial's checkpoint and perturb hyperparams."""

    def __init__(self, *, metric: str, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: int | None = None):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_probability = resample_probability
        self.rng = random.Random(seed)

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        trial.last_metric = metric_value
        if iteration > 0 and iteration % self.interval == 0:
            return EXPLOIT
        return CONTINUE

    def exploit_target(self, trial, trials):
        """If `trial` is bottom-quantile, return a top-quantile trial to
        clone from; else None (keep training)."""
        scored = [t for t in trials if t.last_metric is not None]
        if len(scored) < 2:
            return None
        key = (lambda t: t.last_metric) if self.mode == "max" \
            else (lambda t: -t.last_metric)
        ranked = sorted(scored, key=key, reverse=True)
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = ranked[-k:]
        top = ranked[:k]
        if trial in bottom and trial not in top:
            return self.rng.choice(top)
        return None

    def perturb(self, config: dict) -> dict:
        """Mutate hyperparams (reference: pbt.py explore)."""
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if self.rng.random() < self.resample_probability:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    out[key] = self.rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            else:
                cur = out.get(key)
                if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                    factor = self.rng.choice([0.8, 1.2])
                    out[key] = type(cur)(cur * factor)
                elif isinstance(spec, list) and cur in spec:
                    idx = spec.index(cur)
                    shift = self.rng.choice([-1, 1])
                    out[key] = spec[max(0, min(len(spec) - 1, idx + shift))]
        return out


class PB2(PopulationBasedTraining):
    """Population-based bandits (reference: tune/schedulers/pb2.py).

    Exploitation is PBT's (bottom-quantile trials clone a top trial's
    checkpoint); EXPLORATION replaces random perturbation with a
    GP-UCB model fit to (hyperparameters -> recent reward improvement)
    observations from the whole population, selecting the new
    hyperparameters inside `hyperparam_bounds` that maximize predicted
    improvement plus an exploration bonus. The GP is an RBF-kernel
    ridge regression over normalized hyperparameters — closed form, no
    external dependency."""

    def __init__(self, *, metric: str, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: dict,
                 quantile_fraction: float = 0.25,
                 kappa: float = 1.0, n_candidates: int = 64,
                 seed: int | None = None):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds: "
                             "{key: [low, high]}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = kappa
        self.n_candidates = n_candidates
        self._last_metric: dict[str, float] = {}
        self._history: list[tuple[list[float], float]] = []

    def _vec(self, config: dict) -> list[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        prev = self._last_metric.get(trial.trial_id)
        if prev is not None:
            sign = 1.0 if self.mode == "max" else -1.0
            self._history.append((self._vec(trial.config),
                                  sign * (metric_value - prev)))
            self._history = self._history[-200:]  # bounded model data
        self._last_metric[trial.trial_id] = metric_value
        return super().on_result(trial, metric_value, iteration)

    def perturb(self, config: dict) -> dict:
        """Model-guided explore step (replaces PBT's random factors)."""
        import numpy as np

        out = dict(config)
        keys = list(self.bounds)
        if len(self._history) < 4:
            # Cold start: uniform within bounds.
            for k in keys:
                lo, hi = self.bounds[k]
                out[k] = type(config.get(k, lo))(self.rng.uniform(lo, hi))
            return out
        X = np.asarray([x for x, _ in self._history])
        y = np.asarray([d for _, d in self._history])
        y = (y - y.mean()) / (y.std() + 1e-8)
        ell, lam = 0.2, 0.1
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        K = np.exp(-d2 / (2 * ell * ell)) + lam * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, y)
        Kinv = np.linalg.inv(K)
        cands = np.asarray([[self.rng.random() for _ in keys]
                            for _ in range(self.n_candidates)])
        kstar = np.exp(-((cands[:, None, :] - X[None, :, :]) ** 2
                         ).sum(-1) / (2 * ell * ell))
        mu = kstar @ Kinv_y
        var = np.clip(1.0 - np.einsum("ci,ij,cj->c", kstar, Kinv, kstar),
                      1e-9, None)
        best = cands[int(np.argmax(mu + self.kappa * np.sqrt(var)))]
        for k, u in zip(keys, best):
            lo, hi = self.bounds[k]
            val = lo + float(u) * (hi - lo)
            cur = config.get(k, lo)
            out[k] = type(cur)(val) if isinstance(cur, (int, float)) \
                and not isinstance(cur, bool) else val
        return out


class HyperBandScheduler:
    """HyperBand (Li et al. 2017): several successive-halving brackets with
    staggered starting budgets, so some trials get long uninterrupted runs
    while others are aggressively halved (reference:
    tune/schedulers/hyperband.py; this is the async formulation — each
    bracket behaves like ASHA with grace_period scaled by rf^s)."""

    def __init__(self, *, metric: str, mode: str = "max", max_t: int = 81,
                 reduction_factor: int = 3):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        self.s_max = max(1, int(math.log(max_t) / math.log(reduction_factor)))
        # bracket s -> {milestone -> recorded signed metrics}
        self.brackets: list[dict[int, list[float]]] = [
            {} for _ in range(self.s_max)]
        self._assignment: dict[Any, int] = {}
        self._next_bracket = 0

    def _bracket_of(self, trial) -> int:
        tid = trial.trial_id
        if tid not in self._assignment:
            self._assignment[tid] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % self.s_max
        return self._assignment[tid]

    def _milestones(self, s: int) -> list[int]:
        out, t = [], self.rf ** s
        while t < self.max_t:
            out.append(t)
            t *= self.rf
        return out

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        if iteration >= self.max_t:
            return STOP
        s = self._bracket_of(trial)
        for m in self._milestones(s):
            if iteration == m:
                sign = metric_value if self.mode == "max" else -metric_value
                recorded = self.brackets[s].setdefault(m, [])
                recorded.append(sign)
                k = max(1, len(recorded) // self.rf)
                top_k = sorted(recorded, reverse=True)[:k]
                if sign < top_k[-1]:
                    return STOP
        return CONTINUE

    def exploit_target(self, trial, trials):
        return None


class ResourceChangingScheduler:
    """Wraps a base scheduler and grows/shrinks a trial's resources
    mid-run (reference: tune/schedulers/resource_changing_scheduler.py).
    `resources_allocation_function(trial, metric_value, iteration)
    -> dict | None` returns the new resource dict (None = keep current);
    a different allocation restarts the trial from its last checkpoint
    with those resources."""

    def __init__(self, base_scheduler=None,
                 resources_allocation_function=None):
        self.base = base_scheduler or FIFOScheduler()
        self.alloc_fn = resources_allocation_function
        self.metric = getattr(self.base, "metric", None)
        self.mode = getattr(self.base, "mode", "max")

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        decision = self.base.on_result(trial, metric_value, iteration)
        if decision != CONTINUE or self.alloc_fn is None:
            return decision
        new_res = self.alloc_fn(trial, metric_value, iteration)
        if new_res and new_res != getattr(trial, "resources", None):
            trial.pending_resources = dict(new_res)
            return REALLOCATE
        return CONTINUE

    def exploit_target(self, trial, trials):
        return self.base.exploit_target(trial, trials)

    def perturb(self, config: dict) -> dict:
        return self.base.perturb(config) if hasattr(self.base, "perturb") \
            else dict(config)


class MedianStoppingRule:
    """Stop trials whose running mean falls below the median of others
    (reference: schedulers/median_stopping_rule.py)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 grace_period: int = 4):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.histories: dict[Any, list[float]] = {}

    def on_result(self, trial, metric_value: float, iteration: int) -> str:
        sign = metric_value if self.mode == "max" else -metric_value
        self.histories.setdefault(trial.trial_id, []).append(sign)
        if iteration < self.grace:
            return CONTINUE
        means = [sum(h) / len(h) for tid, h in self.histories.items()
                 if tid != trial.trial_id and h]
        if not means:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        mine = self.histories[trial.trial_id]
        if sum(mine) / len(mine) < median:
            return STOP
        return CONTINUE

    def exploit_target(self, trial, trials):
        return None
