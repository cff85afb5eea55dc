"""ES + ARS: gradient-free population search over policy weights. Port of
ray_tpu/rllib/es.py.

Parity: reference rllib/algorithms/es/ (OpenAI Evolution Strategies —
antithetic Gaussian perturbations, rank-normalized update) and
rllib/algorithms/ars/ (Augmented Random Search — top-k directions
weighted by reward std). Both map cleanly onto the rollout-actor plane:
each worker evaluates perturbed policies episode-by-episode on CPU; the
driver does the (tiny) parameter update in numpy — there is no gradient
step to put on an accelerator, so no learner program is built at all.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (init_policy_params, numpy_forward,
                                     stop_actors)


def _flatten(params: dict) -> tuple[np.ndarray, list]:
    """Flatten the nested param dict into one vector + a rebuild spec."""
    parts, spec = [], []
    for layer in sorted(params):
        for name in sorted(params[layer]):
            arr = np.asarray(params[layer][name], np.float64)
            spec.append((layer, name, arr.shape))
            parts.append(arr.reshape(-1))
    return np.concatenate(parts), spec


def _unflatten(vec: np.ndarray, spec: list) -> dict:
    out: dict = {}
    pos = 0
    for layer, name, shape in spec:
        n = int(np.prod(shape))
        out.setdefault(layer, {})[name] = (
            vec[pos:pos + n].reshape(shape).astype(np.float32))
        pos += n
    return out


@ray_tpu_torch.remote
class _EvalWorker:
    """Evaluates policy weight vectors for whole episodes (no learning)."""

    def __init__(self, env_spec, worker_index: int):
        self.env = make_env(env_spec)
        self._seed = 1000 + worker_index

    def evaluate(self, vec: np.ndarray, spec: list, episodes: int,
                 max_steps: int) -> tuple[float, int]:
        params = _unflatten(vec, spec)
        total, steps = 0.0, 0
        for ep in range(episodes):
            self._seed += 1
            obs = self.env.reset(seed=self._seed)
            for _ in range(max_steps):
                logits, _ = numpy_forward(params, obs[None, :])
                obs, rew, done, _info = self.env.step(int(np.argmax(logits)))
                total += rew
                steps += 1
                if done:
                    break
        return total / episodes, steps


@dataclass
class ESConfig:
    """Fluent config (parity: rllib ESConfig)."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    population: int = 16          # perturbation PAIRS per iteration
    sigma: float = 0.05           # perturbation stddev
    lr: float = 0.02
    episodes_per_eval: int = 1
    max_episode_steps: int = 500
    hidden_size: int = 32
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def rollouts(self, num_rollout_workers: int | None = None, **kw):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown ES option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "ES":
        return ES(self)


class ES:
    """Antithetic ES: theta += lr/(n*sigma) * sum_i rank(r_i) * eps_i."""

    def __init__(self, config: ESConfig):
        self.config = config
        probe = make_env(config.env)
        params = init_policy_params(probe.observation_size,
                                    probe.num_actions, config.hidden_size,
                                    config.seed)
        # The full dict (incl. the unused value head) flattens into the
        # search space — numpy_forward wants every layer present, and a
        # few dead dims are cheaper than a special-cased forward.
        self.theta, self.spec = _flatten(params)
        self.rng = np.random.default_rng(config.seed)
        self.workers = [_EvalWorker.remote(config.env, i)
                        for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    def _center_weights(self, rewards: np.ndarray) -> np.ndarray:
        """Centered-rank transform in [-0.5, 0.5] (reference ES utility)."""
        ranks = np.empty_like(rewards)
        ranks[np.argsort(rewards)] = np.arange(len(rewards))
        return ranks / (len(rewards) - 1) - 0.5

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        eps = self.rng.standard_normal((cfg.population, self.theta.size))
        candidates = np.concatenate([self.theta + cfg.sigma * eps,
                                     self.theta - cfg.sigma * eps])
        futs = [self.workers[i % len(self.workers)].evaluate.remote(
                    candidates[i], self.spec, cfg.episodes_per_eval,
                    cfg.max_episode_steps)
                for i in range(len(candidates))]
        results = ray_tpu_torch.get(futs, timeout=600)
        rewards = np.array([r for r, _ in results])
        self.total_steps += sum(s for _, s in results)

        w = self._center_weights(rewards)
        pos, neg = w[:cfg.population], w[cfg.population:]
        grad = ((pos - neg)[:, None] * eps).sum(0) / (
            cfg.population * cfg.sigma)
        self.theta = self.theta + cfg.lr * grad
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(rewards.mean()),
            "episode_reward_max": float(rewards.max()),
            "timesteps_this_iter": int(sum(s for _, s in results)),
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
        }

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return _unflatten(self.theta, self.spec)

    def compute_single_action(self, obs) -> int:
        logits, _ = numpy_forward(self.get_policy_params(), obs[None, :])
        return int(np.argmax(logits[0]))


@dataclass
class ARSConfig(ESConfig):
    """ARS: like ES but only the top-k directions update, scaled by the
    reward std of those directions (parity: rllib ARSConfig)."""

    top_directions: int = 8

    def build(self) -> "ARS":  # type: ignore[override]
        return ARS(self)


class ARS(ES):
    def train(self) -> dict:
        cfg: ARSConfig = self.config  # type: ignore[assignment]
        t0 = time.time()
        eps = self.rng.standard_normal((cfg.population, self.theta.size))
        candidates = np.concatenate([self.theta + cfg.sigma * eps,
                                     self.theta - cfg.sigma * eps])
        futs = [self.workers[i % len(self.workers)].evaluate.remote(
                    candidates[i], self.spec, cfg.episodes_per_eval,
                    cfg.max_episode_steps)
                for i in range(len(candidates))]
        results = ray_tpu_torch.get(futs, timeout=600)
        rewards = np.array([r for r, _ in results])
        self.total_steps += sum(s for _, s in results)

        r_pos, r_neg = rewards[:cfg.population], rewards[cfg.population:]
        k = min(cfg.top_directions, cfg.population)
        order = np.argsort(-np.maximum(r_pos, r_neg))[:k]
        used = np.concatenate([r_pos[order], r_neg[order]])
        sigma_r = used.std() + 1e-8
        grad = ((r_pos[order] - r_neg[order])[:, None] * eps[order]).sum(0)
        self.theta = self.theta + cfg.lr / (k * sigma_r) * grad
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(rewards.mean()),
            "episode_reward_max": float(rewards.max()),
            "timesteps_this_iter": int(sum(s for _, s in results)),
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
        }
