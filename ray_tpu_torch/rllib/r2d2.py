"""R2D2: recurrent replay distributed DQN. Port of ray_tpu/rllib/r2d2.py.

Parity: reference rllib/algorithms/r2d2/ (recurrent Q-network trained
on stored SEQUENCES with burn-in: the first `burn_in` steps of each
replayed sequence only warm the hidden state — no gradient — so the
recurrent state the network trains from is close to the state it acted
from; double-Q targets; target network). The reference unrolls the GRU
with lax.scan inside one jitted update; `R2D2Learner` unrolls it as a
Python loop over the sequence's steps on the card, the burn-in under
torch.no_grad().
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.dqn import take
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import TorchLearner, stop_actors
from ray_tpu_torch.rllib.utils import CPUActor, tree_assign, tree_copy


def init_r2d2_params(obs_size: int, num_actions: int, hidden: int = 32,
                     seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    return {
        # GRU: update gate z, reset gate r, candidate n (torch layout).
        "wx": mat(obs_size, 3 * hidden), "wh": mat(hidden, 3 * hidden),
        "b": np.zeros(3 * hidden, np.float32),
        "q_w": mat(hidden, num_actions),
        "q_b": np.zeros(num_actions, np.float32),
    }


def _gru_step_np(params, h, x):
    g = x @ params["wx"] + h @ params["wh"] + params["b"]
    H = h.shape[-1]
    z = 1.0 / (1.0 + np.exp(-g[..., :H]))
    r = 1.0 / (1.0 + np.exp(-g[..., H:2 * H]))
    n = np.tanh(x @ params["wx"][:, 2 * H:]
                + r * (h @ params["wh"][:, 2 * H:])
                + params["b"][2 * H:])
    return (1.0 - z) * n + z * h


def numpy_r2d2_q(params: dict, h: np.ndarray, obs: np.ndarray):
    """One recurrent step on CPU: returns (q_values, next_hidden)."""
    h2 = _gru_step_np(params, h, obs)
    return h2 @ params["q_w"] + params["q_b"], h2


def gru_step(params, h, x):
    """_gru_step_np on tensors."""
    H = h.shape[-1]
    g = x @ params["wx"] + h @ params["wh"] + params["b"]
    z = torch.sigmoid(g[..., :H])
    r = torch.sigmoid(g[..., H:2 * H])
    n = torch.tanh(x @ params["wx"][:, 2 * H:]
                   + r * (h @ params["wh"][:, 2 * H:])
                   + params["b"][2 * H:])
    return (1.0 - z) * n + z * h


def unroll_q(params, h0, obs_seq, resets):
    """obs_seq [B, T, obs] -> (q [B, T, A], the carried state after T).
    `resets` [B, T] zeroes the carried state AFTER a step where the
    episode ended — matching the actor, which starts the next episode
    from h = 0 (sequences may span resets)."""
    h, qs = h0, []
    for t in range(obs_seq.shape[1]):
        h2 = gru_step(params, h, obs_seq[:, t])
        qs.append(h2 @ params["q_w"] + params["q_b"])
        h = h2 * (1.0 - resets[:, t])[:, None]
    return torch.stack(qs, 1), h


class SequenceReplay:
    """Ring buffer of fixed-length sequences with their initial hidden
    state (reference: r2d2's sequence storage — replay_sequence_length
    = burn_in + train length, zero/stored initial states)."""

    def __init__(self, capacity: int, seq_len: int, obs_size: int,
                 hidden: int, seed: int = 0):
        self.capacity, self.seq_len = capacity, seq_len
        self.obs = np.zeros((capacity, seq_len, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, seq_len, obs_size), np.float32)
        self.actions = np.zeros((capacity, seq_len), np.int32)
        self.rewards = np.zeros((capacity, seq_len), np.float32)
        self.dones = np.zeros((capacity, seq_len), np.float32)
        self.resets = np.zeros((capacity, seq_len), np.float32)
        self.h0 = np.zeros((capacity, hidden), np.float32)
        self.pos = 0
        self.size = 0
        self.rng = np.random.default_rng(seed)

    def add_sequences(self, seqs: list[dict]) -> None:
        for s in seqs:
            i = self.pos
            self.obs[i] = s["obs"]
            self.next_obs[i] = s["next_obs"]
            self.actions[i] = s["actions"]
            self.rewards[i] = s["rewards"]
            self.dones[i] = s["dones"]
            self.resets[i] = s.get("resets", s["dones"])
            self.h0[i] = s["h0"]
            self.pos = (self.pos + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self.size, batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx], "resets": self.resets[idx],
                "h0": self.h0[idx]}


@ray_tpu_torch.remote(num_cpus=1)
class R2D2RolloutWorker(CPUActor):
    """CPU sampler carrying the recurrent state across fragments; emits
    fixed-length sequences stamped with the hidden state they started
    from (parity: rollout_worker.py + R2D2's state-in-replay)."""

    def __init__(self, env_spec, worker_index: int, hidden: int,
                 seq_len: int):
        super().__init__()
        self.env = make_env(env_spec)
        self.hidden = hidden
        self.seq_len = seq_len
        self.rng = np.random.default_rng(4000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.h = np.zeros(hidden, np.float32)
        self.ep_ret = 0.0

    def sample(self, params: dict, num_seqs: int, epsilon: float) -> dict:
        seqs = []
        episode_returns = []
        for _ in range(num_seqs):
            seq = {k: [] for k in ("obs", "actions", "rewards",
                                   "next_obs", "dones", "resets")}
            h0 = self.h.copy()
            for _ in range(self.seq_len):
                q, self.h = numpy_r2d2_q(params, self.h[None, :],
                                         self.obs[None, :])
                self.h = self.h[0]
                if self.rng.random() < epsilon:
                    action = int(self.rng.integers(self.env.num_actions))
                else:
                    action = int(np.argmax(q[0]))
                next_obs, reward, done, info = self.env.step(action)
                seq["obs"].append(self.obs)
                seq["actions"].append(action)
                seq["rewards"].append(reward)
                seq["next_obs"].append(next_obs)
                # dones = bootstrap mask (time-limit cuts bootstrap
                # through, env.py convention); resets = where the
                # episode ended and the actor zeroed its hidden state —
                # the training unroll must do the same.
                seq["dones"].append(float(bool(done)
                                    and not info.get("truncated",
                                                     False)))
                seq["resets"].append(float(done))
                self.ep_ret += reward
                if done:
                    episode_returns.append(self.ep_ret)
                    self.ep_ret = 0.0
                    self.obs = self.env.reset()
                    self.h = np.zeros(self.hidden, np.float32)
                else:
                    self.obs = next_obs
            seqs.append({"obs": np.asarray(seq["obs"], np.float32),
                         "actions": np.asarray(seq["actions"], np.int32),
                         "rewards": np.asarray(seq["rewards"], np.float32),
                         "next_obs": np.asarray(seq["next_obs"],
                                                np.float32),
                         "dones": np.asarray(seq["dones"], np.float32),
                         "resets": np.asarray(seq["resets"], np.float32),
                         "h0": h0})
        return {"sequences": seqs, "episode_returns": episode_returns,
                "steps": num_seqs * self.seq_len}


@dataclass
class R2D2Config:
    """Parity: rllib R2D2Config (replay_sequence_length = burn_in +
    train segment, zero_init_states=False — states come from the actor)."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    sequences_per_rollout: int = 8
    burn_in: int = 4
    train_length: int = 12
    buffer_capacity: int = 4_000
    train_batch_size: int = 32
    num_sgd_iter: int = 16
    gamma: float = 0.99
    lr: float = 1e-3
    hidden_size: int = 32
    target_network_update_freq: int = 4
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 15
    seed: int = 0

    @property
    def seq_len(self) -> int:
        return self.burn_in + self.train_length

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
                raise ValueError(f"unknown R2D2 option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "R2D2":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return R2D2(self, device=device)


class R2D2Learner(TorchLearner):
    """R2D2's learner on one device: the recurrent Q network and its
    target, one Adam step an update of the squared double-Q TD error over
    each sequence's train segment, its hidden state warmed on the
    burn-in prefix without gradient."""

    def __init__(self, config: R2D2Config, obs_size: int, num_actions: int,
                 *, params: dict | None = None, device=None):
        self.config = config
        if params is None:
            params = init_r2d2_params(obs_size, num_actions,
                                      config.hidden_size, config.seed)
        super().__init__(params, self._loss, config.lr, device)
        self.target = tree_copy(self.params)

    def _loss(self, params, batch):
        cfg = self.config
        train = slice(cfg.burn_in, cfg.seq_len)
        train_resets = batch["resets"][:, train]
        with torch.no_grad():
            # Burn-in: warm the hidden state on the replayed prefix with
            # NO gradient (R2D2's stored-state + burn-in strategy).
            _, h_warm = unroll_q(params, batch["h0"],
                                 batch["obs"][:, :cfg.burn_in],
                                 batch["resets"][:, :cfg.burn_in])
            # Targets: the online unroll over next_obs picks a*, the
            # TARGET net's rates it (double-Q).
            q_next_online, _ = unroll_q(params, h_warm,
                                        batch["next_obs"][:, train],
                                        train_resets)
            q_next_target, _ = unroll_q(self.target, h_warm,
                                        batch["next_obs"][:, train],
                                        train_resets)
            q_boot = take(q_next_target, q_next_online.argmax(-1))
            target = batch["rewards"][:, train] + cfg.gamma * (
                1.0 - batch["dones"][:, train]) * q_boot
        q_seq, _ = unroll_q(params, h_warm, batch["obs"][:, train],
                            train_resets)
        q_taken = take(q_seq, batch["actions"][:, train])
        return torch.mean((q_taken - target) ** 2), {}

    def sync_target(self) -> None:
        tree_assign(self.target, self.params)


class R2D2:
    """Algorithm driver (parity: Algorithm.step / R2D2 training_step). The
    learner is made before the rollout workers."""

    def __init__(self, config: R2D2Config, device=None):
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.learner = R2D2Learner(config, self.obs_size, self.num_actions,
                                   device=device)
        self.buffer = SequenceReplay(config.buffer_capacity,
                                     config.seq_len, self.obs_size,
                                     config.hidden_size, config.seed)
        self.workers = [
            R2D2RolloutWorker.remote(config.env, i, config.hidden_size,
                                     config.seq_len)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def train(self) -> dict:
        cfg = self.config
        eps = self._epsilon()
        rollout_params = self.learner.get_params()
        outs = ray_tpu_torch.get([
            w.sample.remote(rollout_params, cfg.sequences_per_rollout, eps)
            for w in self.workers])
        returns = []
        for out in outs:
            self.buffer.add_sequences(out["sequences"])
            returns += out["episode_returns"]
            self.total_steps += out["steps"]
        losses = []
        if self.buffer.size >= cfg.train_batch_size:
            for _ in range(cfg.num_sgd_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                loss, _aux = self.learner.update(batch)
                losses.append(loss)
        self.iteration += 1
        if self.iteration % cfg.target_network_update_freq == 0:
            self.learner.sync_target()
        return {"training_iteration": self.iteration,
                "episode_reward_mean":
                    float(np.mean(returns)) if returns else float("nan"),
                "num_env_steps_sampled": self.total_steps,
                "loss": float(np.mean(torch.stack(losses).tolist()))
                if losses else None}

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()
