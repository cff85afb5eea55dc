"""CQL: conservative Q-learning for offline RL (discrete actions). Port of
ray_tpu/rllib/cql.py.

Parity: reference rllib/algorithms/cql/ — offline batches only (no env
interaction during training), with the conservative penalty
E[logsumexp_a Q(s,a)] - E[Q(s, a_data)] added to the Bellman loss so
out-of-distribution actions are pushed DOWN instead of exploited. Built
on the DQN learner shape (max-Q target from a target network) over the
port's JsonReader batches, one process, the Q network on the card;
evaluation rolls the greedy policy in the real env.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.dqn import take
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.ppo import (adam, device_batch, numpy_params,
                                     tensor_params)
from ray_tpu_torch.rllib.utils import tree_assign, tree_copy


def init_q_params(obs_size: int, num_actions: int, hidden: int = 64,
                  seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    return {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
            "out": dense(hidden, num_actions)}


def numpy_q(params: dict, obs: np.ndarray) -> np.ndarray:
    h = np.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def q_fn(p, obs):
    """numpy_q on tensors."""
    h = torch.tanh(obs @ p["h1"]["w"] + p["h1"]["b"])
    h = torch.tanh(h @ p["h2"]["w"] + p["h2"]["b"])
    return h @ p["out"]["w"] + p["out"]["b"]


@dataclass
class CQLConfig:
    env: Any = "CartPole-v1"          # evaluation env only
    input_path: str = ""              # offline JSON data (JsonReader)
    train_batch_size: int = 256
    num_updates_per_iter: int = 200
    gamma: float = 0.99
    lr: float = 3e-4
    cql_alpha: float = 1.0            # conservative penalty weight
    target_update_every: int = 100
    hidden_size: int = 64
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def offline_data(self, input_path: str):
        self.input_path = input_path
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown CQL option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "CQL":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return CQL(self, device=device)


class CQL:
    """The offline learner: the Q network and its target as f32 tensors
    on `device` (None: the card, raising without one), torch Adam with
    optax.adam's defaults; `update` one step, `train` an iteration of
    them, the target synced every target_update_every updates."""

    def __init__(self, config: CQLConfig, device=None):
        if not config.input_path:
            raise ValueError("CQL is offline-only: set offline_data(path)")
        self.device = resolve_device(device)
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.params = tensor_params(init_q_params(
            self.obs_size, self.num_actions, config.hidden_size, config.seed),
            self.device, trainable=True)
        self.optimizer = adam(self.params, config.lr)
        self.target = tree_copy(self.params)
        data = JsonReader(config.input_path).read_all()
        n = len(data["obs"])
        if n < 2:
            raise ValueError("offline dataset too small")
        # next_obs/dones reconstructed from the flat log (step i -> i+1;
        # a done at i ends the episode, obs[i+1] starts the next).
        self.data = {
            "obs": data["obs"][:-1],
            "actions": data["actions"][:-1],
            "rewards": data["rewards"][:-1],
            "next_obs": data["obs"][1:],
            "dones": data["dones"][:-1].astype(np.float32),
        }
        self._rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self._updates = 0

    def update(self, minibatch: dict) -> dict:
        """One Adam step; the target syncs after every
        target_update_every-th. Returns the reference's metrics as device
        tensors."""
        cfg = self.config
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            with torch.no_grad():
                y = batch["rewards"] + cfg.gamma * (1 - batch["dones"]) \
                    * q_fn(self.target, batch["next_obs"]).max(-1).values
            self.optimizer.zero_grad(set_to_none=True)
            q = q_fn(self.params, batch["obs"])
            q_data = take(q, batch["actions"])
            bellman = ((q_data - y) ** 2).mean()
            # Conservative penalty: push down the soft-max over ALL
            # actions, push up the dataset action.
            conservative = (torch.logsumexp(q, dim=-1) - q_data).mean()
            loss = bellman + cfg.cql_alpha * conservative
            loss.backward()
            self.optimizer.step()
            self._updates += 1
            if self._updates % cfg.target_update_every == 0:
                tree_assign(self.target, self.params)
        return {"loss": loss.detach(), "bellman": bellman.detach(),
                "cql_penalty": conservative.detach()}

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        n = len(self.data["obs"])
        metrics = {}
        for _ in range(cfg.num_updates_per_iter):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            metrics = self.update({k: v[idx] for k, v in self.data.items()})
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "learn_time_s": round(time.time() - t0, 3),
                **{k: float(v) for k, v in metrics.items()}}

    def get_policy_params(self) -> dict:
        return numpy_params(self.params)

    def evaluate(self, num_episodes: int = 5) -> dict:
        """Greedy rollout in the real env (offline training never touches
        it — this is the measurement, reference: evaluation workers)."""
        params = self.get_policy_params()
        env = make_env(self.config.env)
        returns = []
        for ep in range(num_episodes):
            obs = env.reset(seed=1000 + ep)
            ret, done = 0.0, False
            while not done:
                a = int(np.argmax(numpy_q(params, obs[None])[0]))
                obs, rew, done, _ = env.step(a)
                ret += rew
            returns.append(ret)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episodes": num_episodes}

    def stop(self):
        pass
