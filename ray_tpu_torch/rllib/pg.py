"""PG: vanilla policy gradient (REINFORCE with value baseline). Port of
ray_tpu/rllib/pg.py.

Parity: reference rllib/algorithms/pg/ — the minimal on-policy
algorithm, sharing PPO's rollout actors (GAE advantages double as the
return-minus-baseline signal) with a plain -logp * advantage learner
update; no clipping, no multiple epochs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.impala import mlp_forward
from ray_tpu_torch.rllib.ppo import (RolloutWorker, TorchLearner,
                                     init_policy_params, stop_actors)


@dataclass
class PGConfig:
    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 256
    gamma: float = 0.99
    lambda_: float = 1.0             # pure returns by default
    lr: float = 5e-3
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.0
    hidden_size: int = 64
    model: str = "mlp"
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
                raise ValueError(f"unknown PG option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "PG":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return PG(self, device=device)


def make_pg_loss(vf_coeff: float, entropy_coeff: float):
    """-logp * normalized advantage, plus the value and entropy terms:
    (total, {"pg_loss", "vf_loss", "entropy"}). The advantages are
    normalized by their population std, as jnp.std computes it."""

    def loss_fn(p, batch):
        logits, value = mlp_forward(p, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg_loss = -(logp * adv).mean()
        vf_loss = ((value - batch["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        return (pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy), {
            "pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}

    return loss_fn


class PG:
    """Sample (all workers) -> one gradient step on the learner, which
    runs in the driver on `device` (None: the card, raising without
    one)."""

    def __init__(self, config: PGConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        self.learner = TorchLearner(
            init_policy_params(probe.observation_size, probe.num_actions,
                               config.hidden_size, config.seed),
            make_pg_loss(config.vf_coeff, config.entropy_coeff), config.lr,
            device)
        self.workers = [
            RolloutWorker.remote(config.env, i, config.gamma,
                                 config.lambda_, config.model)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        frags = ray_tpu_torch.get(
            [w.sample.remote(self.params, cfg.rollout_fragment_length)
             for w in self.workers], timeout=600)
        episode_returns = []
        batch = {}
        for f in frags:
            episode_returns += f.pop("episode_returns")
            for k, v in f.items():
                batch.setdefault(k, []).append(np.asarray(v))
        batch = {k: np.concatenate(v) for k, v in batch.items()}
        self.total_steps += len(batch["obs"])
        sample_time = time.time() - t0

        t1 = time.time()
        loss, aux = self.learner.update(batch)
        metrics = {"loss": loss, **aux}
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "timesteps_total": self.total_steps,
            "timesteps_this_iter": len(batch["obs"]),
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(time.time() - t1, 3),
            **{k: float(v) for k, v in metrics.items()},
        }

    def stop(self):
        stop_actors(self.workers)
