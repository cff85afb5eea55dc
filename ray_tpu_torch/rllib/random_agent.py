"""RandomAgent: uniform-random baseline. Port of
ray_tpu/rllib/random_agent.py, a copy (parity: reference
rllib/algorithms/random_agent.py — the sanity floor every real
algorithm must beat, and a fixture for pipeline tests)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from ray_tpu_torch.rllib.env import make_env


@dataclass
class RandomAgentConfig:
    env: Any = "CartPole-v1"
    episodes_per_iter: int = 8
    max_episode_steps: int = 500
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def rollouts(self, **kw):
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown RandomAgent option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "RandomAgent":
        return RandomAgent(self)


class RandomAgent:
    def __init__(self, config: RandomAgentConfig):
        self.config = config
        self.env = make_env(config.env)
        self.rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.total_steps = 0

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        returns = []
        steps = 0
        for ep in range(cfg.episodes_per_iter):
            obs = self.env.reset(seed=cfg.seed + self.iteration * 1000 + ep)
            total = 0.0
            for _ in range(cfg.max_episode_steps):
                a = int(self.rng.integers(self.env.num_actions))
                obs, rew, done, _ = self.env.step(a)
                total += rew
                steps += 1
                if done:
                    break
            returns.append(total)
        self.iteration += 1
        self.total_steps += steps
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(returns)),
            "episodes_this_iter": len(returns),
            "timesteps_this_iter": steps,
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
        }

    def compute_single_action(self, obs) -> int:
        return int(self.rng.integers(self.env.num_actions))

    def stop(self):
        pass
