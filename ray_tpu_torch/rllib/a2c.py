"""A2C: synchronous advantage actor-critic. Port of ray_tpu/rllib/a2c.py.

Parity: reference rllib/algorithms/a2c/ — synchronous variant of A3C:
every iteration all rollout workers sample with the current policy, the
learner does ONE gradient step on the combined batch (no PPO-style
minibatch epochs, no clipping), then weights broadcast back.
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
                                     init_policy_params, numpy_forward,
                                     stop_actors)

_BATCH_KEYS = ("obs", "actions", "advantages", "returns")


@dataclass
class A2CConfig:
    """Fluent config (parity: rllib A2CConfig)."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 256
    gamma: float = 0.99
    lam: float = 1.0              # GAE(λ=1) = Monte-Carlo advantages
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 1e-3
    hidden_size: int = 64
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
                raise ValueError(f"unknown A2C option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "A2C":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return A2C(self, device=device)


def make_a2c_loss(vf_coeff: float, entropy_coeff: float):
    """The actor-critic loss: (total, {"pi_loss", "vf_loss", "entropy"}),
    the advantages normalized by their population std (jnp.std's)."""

    def loss_fn(params, batch):
        logits, value = mlp_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pi_loss = -(logp * adv).mean()
        vf_loss = ((value - batch["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


class A2C:
    """Algorithm driver: sample (sync, all workers) → one gradient step,
    the learner in the driver on `device` (None: the card, raising
    without one)."""

    def __init__(self, config: A2CConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.learner = TorchLearner(
            init_policy_params(self.obs_size, self.num_actions,
                               config.hidden_size, config.seed),
            make_a2c_loss(config.vf_coeff, config.entropy_coeff), config.lr,
            device)
        # PPO's worker computes GAE with (gamma, lam) — with lam=1 that is
        # the plain discounted advantage A2C wants.
        self.workers = [
            RolloutWorker.remote(config.env, i, config.gamma, config.lam)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        host_params = self.params
        batches = ray_tpu_torch.get(
            [w.sample.remote(host_params, cfg.rollout_fragment_length)
             for w in self.workers], timeout=600)
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in _BATCH_KEYS}
        episode_returns = sum((b["episode_returns"] for b in batches), [])
        loss, aux = self.learner.update(batch)
        n = len(batch["obs"])
        self.total_steps += n
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else 0.0,
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": n,
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
            **{k: float(v) for k, v in aux.items()},
        }

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.params

    def compute_single_action(self, obs) -> int:
        logits, _ = numpy_forward(self.get_policy_params(), obs[None, :])
        return int(np.argmax(logits[0]))
