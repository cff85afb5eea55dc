"""DQN: off-policy Q-learning with replay buffer and target network.
Port of ray_tpu/rllib/dqn.py.

Parity: reference rllib/algorithms/dqn/ (double-DQN update, epsilon-greedy
exploration schedule, target-network sync every N steps) with the
rollout/learner split of SURVEY.md §3.6: CPU sampling actors of the
port's runtime feed a replay buffer (reference:
rllib/utils/replay_buffers/replay_buffer.py); the learner is
`DQNLearner` in the driver, its Q network and target as f32 tensors on
the card and torch Adam with optax.adam's defaults. The rollout actors
run the reference's numpy forward, so their samples are bitwise the
reference's, and the buffer keeps its seeded numpy generator, so it
draws the reference's indices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import TorchLearner, stop_actors
from ray_tpu_torch.rllib.utils import CPUActor, tree_assign, tree_copy


def init_q_params(obs_size: int, num_actions: int, hidden: int = 64,
                  seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    return {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
            "q": dense(hidden, num_actions)}


def numpy_q_values(params: dict, obs: np.ndarray) -> np.ndarray:
    h = np.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return h @ params["q"]["w"] + params["q"]["b"]


def q_values(params: dict, obs):
    """numpy_q_values on tensors (the learner's forward)."""
    h = torch.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return h @ params["q"]["w"] + params["q"]["b"]


def huber(td):
    """The Huber loss of each TD error (reference: dqn's default)."""
    return torch.where(td.abs() < 1.0, 0.5 * td * td, td.abs() - 0.5)


def take(values, index):
    """values[b, index[b]] along the last axis (jnp.take_along_axis)."""
    return values.gather(-1, index.long()[..., None])[..., 0]


class ReplayBuffer:
    """Uniform-sampling ring buffer (reference:
    rllib/utils/replay_buffers/replay_buffer.py storage + sample)."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0,
                 action_shape: tuple = (), action_dtype=np.int32):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        self.actions = np.zeros((capacity, *action_shape), action_dtype)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.pos = 0
        self.size = 0
        self.rng = np.random.default_rng(seed)

    def add_batch(self, batch: dict) -> None:
        n = len(batch["obs"])
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self.size, batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx]}


@ray_tpu_torch.remote(num_cpus=1)
class DQNRolloutWorker(CPUActor):
    """CPU epsilon-greedy sampler (parity: rollout_worker.py)."""

    def __init__(self, env_spec, worker_index: int):
        super().__init__()
        self.env = make_env(env_spec)
        self.index = worker_index
        self.rng = np.random.default_rng(2000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.ep_ret = 0.0

    def sample(self, params: dict, num_steps: int, epsilon: float) -> dict:
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        episode_returns = []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.rng.integers(self.env.num_actions))
            else:
                q = numpy_q_values(params, self.obs[None, :])[0]
                action = int(np.argmax(q))
            next_obs, reward, done, _ = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            rew_b.append(reward)
            next_b.append(next_obs)
            done_b.append(float(done))
            self.ep_ret += reward
            if done:
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {"obs": np.asarray(obs_b, np.float32),
                "actions": np.asarray(act_b, np.int32),
                "rewards": np.asarray(rew_b, np.float32),
                "next_obs": np.asarray(next_b, np.float32),
                "dones": np.asarray(done_b, np.float32),
                "episode_returns": episode_returns}


@dataclass
class DQNConfig:
    """Parity: rllib DQNConfig fluent-config object."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 256
    buffer_capacity: int = 50_000
    learning_starts: int = 1_000
    train_batch_size: int = 128
    num_sgd_iter: int = 32
    gamma: float = 0.99
    lr: float = 1e-3
    hidden_size: int = 64
    target_network_update_freq: int = 4  # iterations between target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 20
    double_q: bool = True
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
                raise ValueError(f"unknown DQN option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "DQN":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return DQN(self, device=device)


class DQNLearner(TorchLearner):
    """DQN's learner on one device: the Q network and its target as f32
    tensors, one Adam step an update of the Huber TD loss (double-Q when
    config.double_q). params: a numpy tree (init_q_params from
    config.seed when None). device: None means CUDA and raises without a
    card."""

    def __init__(self, config, obs_size: int, num_actions: int, *,
                 params: dict | None = None, device=None):
        self.config = config
        if params is None:
            params = init_q_params(obs_size, num_actions, config.hidden_size,
                                   config.seed)
        super().__init__(params, self._loss, config.lr, device)
        self.target = tree_copy(self.params)

    def td_error(self, params: dict, batch: dict, double_q: bool):
        """q(s, a) - (r + gamma (1 - done) q_target(s', a*)), the target
        out of the graph; a* the online net's argmax with double_q, else
        the target's max."""
        cfg = self.config
        q_sel = take(q_values(params, batch["obs"]), batch["actions"])
        with torch.no_grad():
            q_next_target = q_values(self.target, batch["next_obs"])
            if double_q:
                # Double DQN: online net picks the argmax, target net rates it.
                a_star = q_values(params, batch["next_obs"]).argmax(1)
                q_next = take(q_next_target, a_star)
            else:
                q_next = q_next_target.max(1).values
            target = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) \
                * q_next
        return q_sel - target

    def _loss(self, params, batch):
        td = self.td_error(params, batch, self.config.double_q)
        return huber(td).mean(), {}

    def sync_target(self) -> None:
        tree_assign(self.target, self.params)


class DQN:
    """Algorithm driver (parity: Algorithm.step / DQN training_step). The
    learner is made before the rollout workers, so a missing card starts
    no actor."""

    def __init__(self, config: DQNConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.learner = self._make_learner(device)
        self.buffer = self._make_buffer()
        self.workers = [DQNRolloutWorker.remote(config.env, i)
                        for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    def _make_learner(self, device):
        return DQNLearner(self.config, self.obs_size, self.num_actions,
                          device=device)

    def _make_buffer(self):
        return ReplayBuffer(self.config.buffer_capacity, self.obs_size,
                            self.config.seed)

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _sync_if_due(self) -> None:
        if self.iteration % self.config.target_network_update_freq == 0:
            self.learner.sync_target()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        eps = self._epsilon()
        host_params = self.learner.get_params()
        batches = ray_tpu_torch.get(
            [w.sample.remote(host_params, cfg.rollout_fragment_length, eps)
             for w in self.workers], timeout=600)
        episode_returns = []
        for b in batches:
            episode_returns.extend(b.pop("episode_returns"))
            self.buffer.add_batch(b)
            self.total_steps += len(b["obs"])
        sample_time = time.time() - t0

        t1 = time.time()
        loss = 0.0
        updates_done = 0
        if self.buffer.size >= max(cfg.train_batch_size, cfg.learning_starts):
            for _ in range(cfg.num_sgd_iter):
                mb = self.buffer.sample(cfg.train_batch_size)
                loss, _aux = self.learner.update(mb)
                updates_done += 1
        self.iteration += 1
        self._sync_if_due()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else 0.0,
            "episodes_this_iter": len(episode_returns),
            "timesteps_total": self.total_steps,
            "buffer_size": self.buffer.size,
            "epsilon": round(eps, 4),
            "num_updates": updates_done,
            "loss": float(loss),
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(time.time() - t1, 3),
        }

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()

    def compute_single_action(self, obs) -> int:
        return int(np.argmax(
            numpy_q_values(self.get_policy_params(), obs[None, :])[0]))
