"""Contextual bandits: LinUCB and Linear Thompson Sampling. Port of
ray_tpu/rllib/bandit.py, a copy (numpy only).

Parity: reference rllib/algorithms/bandit/ (BanditLinUCB / BanditLinTS
over the per-arm linear model in bandit_torch_model.py). Exact linear
algebra — A = I + sum x x^T per arm, ridge solve per step — so the
whole algorithm is numpy on the driver; there is nothing to place on an
accelerator or distribute. The env contract is one-step episodic:
reset() -> context, step(arm) -> (next context, reward, True, {}).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from ray_tpu_torch.rllib.env import ENV_REGISTRY, Env, make_env


class LinearDiscreteBandit(Env):
    """Synthetic contextual bandit: reward = theta_arm . context + noise
    (parity: the reference's LinearDiscreteEnv test env)."""

    observation_size = 8
    num_actions = 4

    def __init__(self, seed: int = 0, noise: float = 0.1):
        self._rng = np.random.default_rng(seed)
        self._theta = self._rng.standard_normal(
            (self.num_actions, self.observation_size))
        self._noise = noise
        self._ctx = None

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.standard_normal(self.observation_size)
        return self._ctx.astype(np.float32)

    def step(self, action: int):
        rew = float(self._theta[action] @ self._ctx
                    + self._noise * self._rng.standard_normal())
        best = float(np.max(self._theta @ self._ctx))
        nxt = self.reset()
        return nxt, rew, True, {"regret": best - rew}


ENV_REGISTRY.setdefault("LinearBandit-v0", LinearDiscreteBandit)


@dataclass
class BanditConfig:
    """Fluent config (parity: rllib BanditConfig). exploration:
    "ucb" (LinUCB, alpha-scaled bonus) or "ts" (Thompson sampling)."""

    env: Any = "LinearBandit-v0"
    exploration: str = "ucb"
    alpha: float = 1.0            # UCB bonus scale / TS posterior scale
    steps_per_iter: int = 256
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def rollouts(self, **kw):
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown Bandit option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "Bandit":
        return Bandit(self)


class Bandit:
    """Per-arm ridge regression; arm choice by UCB bonus or posterior
    sample. Runs in-process (a bandit step is a dot product — remote
    workers would be pure overhead)."""

    def __init__(self, config: BanditConfig):
        self.config = config
        self.env = make_env(config.env)
        d = self.env.observation_size
        k = self.env.num_actions
        self._A = np.stack([np.eye(d) for _ in range(k)])   # (k, d, d)
        self._b = np.zeros((k, d))
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.total_steps = 0
        self._obs = self.env.reset(seed=config.seed)

    def _choose(self, x: np.ndarray) -> int:
        k = self._A.shape[0]
        scores = np.empty(k)
        for a in range(k):
            A_inv = np.linalg.inv(self._A[a])
            theta = A_inv @ self._b[a]
            if self.config.exploration == "ts":
                theta = self.rng.multivariate_normal(
                    theta, self.config.alpha ** 2 * A_inv)
                scores[a] = theta @ x
            else:
                bonus = self.config.alpha * np.sqrt(x @ A_inv @ x)
                scores[a] = theta @ x + bonus
        return int(np.argmax(scores))

    def train(self) -> dict:
        t0 = time.time()
        rewards, regrets = [], []
        for _ in range(self.config.steps_per_iter):
            x = np.asarray(self._obs, np.float64)
            a = self._choose(x)
            self._obs, rew, _done, info = self.env.step(a)
            self._A[a] += np.outer(x, x)
            self._b[a] += rew * x
            rewards.append(rew)
            if "regret" in info:
                regrets.append(info["regret"])
        self.iteration += 1
        self.total_steps += len(rewards)
        out = {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(rewards)),
            "timesteps_this_iter": len(rewards),
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
        }
        if regrets:
            out["mean_regret"] = float(np.mean(regrets))
        return out

    def compute_single_action(self, obs) -> int:
        return self._choose(np.asarray(obs, np.float64))

    def stop(self):
        pass
