"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing.
Port of ray_tpu/rllib/qmix.py.

Parity: reference rllib/algorithms/qmix/ (per-agent Q networks whose
chosen-action values feed a mixing network with non-negative weights —
hypernetworks conditioned on the GLOBAL state — so argmax per agent is
argmax of the team value; trained by TD on the shared team reward).

Ships with `CoopSwitch`, a minimal cooperative env where the team
reward exists only when agents coordinate — independent learners
plateau on it, the mixer's credit assignment does not (the standard
QMIX motivation, miniaturized).

One process: the env loop and the transition buffer are numpy (the
reference's, bitwise); the shared agent net, the hypernetwork mixer,
their target copy and torch Adam with optax.adam's defaults live on the
learner's device, and each env step's agent Q-values are a forward
there. The target is a copy from the start (the reference aliases it,
which is safe only because optax returns new arrays; torch's Adam
updates in place).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.dqn import take
from ray_tpu_torch.rllib.env import ENV_REGISTRY, MultiAgentEnv
from ray_tpu_torch.rllib.ppo import adam, device_batch, tensor_params
from ray_tpu_torch.rllib.utils import tree_assign, tree_copy


class CoopSwitch(MultiAgentEnv):
    """Two agents each observe a private bit; the team earns +1 only
    when their JOINT action matches the XOR of the bits (a matrix game
    per step, re-randomized; episode of fixed length). Global state =
    both bits (the mixer may use it; each agent sees only its own)."""

    agent_ids = ("agent_0", "agent_1")
    observation_size = 2           # own bit (one-hot)
    num_actions = 2
    episode_len = 16

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bits = (0, 0)

    @property
    def global_state(self) -> np.ndarray:
        return np.asarray(self._bits, np.float32)

    def _obs(self) -> dict:
        return {a: np.eye(2, dtype=np.float32)[self._bits[i]]
                for i, a in enumerate(self.agent_ids)}

    def reset(self, seed: int | None = None) -> dict:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bits = tuple(self._rng.integers(0, 2, 2))
        return self._obs()

    def step(self, actions: dict):
        want = self._bits[0] ^ self._bits[1]
        team = float(actions["agent_0"] == want and
                     actions["agent_1"] == want)
        self._t += 1
        done = self._t >= self.episode_len
        self._bits = tuple(self._rng.integers(0, 2, 2))
        obs = self._obs()
        rew = {a: team for a in self.agent_ids}   # shared team reward
        dones = {a: done for a in self.agent_ids}
        dones["__all__"] = done
        return obs, rew, dones, {"team_reward": team}


ENV_REGISTRY.setdefault("CoopSwitch-v0", CoopSwitch)


@dataclass
class QMIXConfig:
    """Fluent config (parity: rllib QMIXConfig)."""

    env: Any = "CoopSwitch-v0"
    episodes_per_iter: int = 16
    gamma: float = 0.95
    lr: float = 5e-3
    hidden: int = 32
    mixer_hidden: int = 16
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 15
    target_update_freq: int = 5
    buffer_episodes: int = 256
    train_batches: int = 16
    batch_size: int = 128
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def rollouts(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown QMIX option {k!r}")
            setattr(self, k, v)
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown QMIX option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "QMIX":
        """device: where the networks run; None means the card, and
        raises without one."""
        return QMIX(self, device=device)


def agent_q(p: dict, obs_aug):
    """The shared agent network: (rows, obs + id) -> Q-values."""
    h = torch.tanh(obs_aug @ p["q1"]["w"] + p["q1"]["b"])
    return h @ p["q2"]["w"] + p["q2"]["b"]


def mix(p: dict, qs, state, n_agents: int, mixer_hidden: int):
    """qs (B, n_agents) -> Q_tot (B, 1), monotonic through the abs of the
    hypernetworks' weights."""
    w1 = torch.abs(state @ p["hw1"]["w"] + p["hw1"]["b"]) \
        .reshape(-1, n_agents, mixer_hidden)
    b1 = state @ p["hb1"]["w"] + p["hb1"]["b"]
    h = torch.tanh(torch.einsum("ba,bam->bm", qs, w1) + b1)
    w2 = torch.abs(state @ p["hw2"]["w"] + p["hw2"]["b"])
    b2 = state @ p["hb2"]["w"] + p["hb2"]["b"]
    return (h * w2).sum(-1, keepdim=True) + b2


class QMIX:
    def __init__(self, config: QMIXConfig, device=None):
        self.device = resolve_device(device)
        self.config = config
        env_cls = (ENV_REGISTRY[config.env]
                   if isinstance(config.env, str) else config.env)
        self.env = env_cls()
        self.n_agents = len(self.env.agent_ids)
        self.obs_size = self.env.observation_size
        self.num_actions = self.env.num_actions
        # Envs without a global_state fall back to concatenated agent
        # observations as the mixer conditioning (reference QMIX does
        # the same when no state space is provided).
        self._has_global_state = hasattr(self.env, "global_state")
        probe_obs = self.env.reset(seed=config.seed)
        self.state_size = len(self._global_state(probe_obs))
        self.params = tensor_params(self._init_params(), self.device,
                                    trainable=True)
        self.target = tree_copy(self.params)
        self.optimizer = adam(self.params, config.lr)
        self.iteration = 0
        self.total_steps = 0
        self._buffer: list = []     # transitions across episodes
        self.rng = np.random.default_rng(config.seed)

    def _init_params(self) -> dict:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)

        def dense(i, o):
            return {"w": (rng.standard_normal((i, o)) *
                          (1.0 / np.sqrt(i))).astype(np.float32),
                    "b": np.zeros(o, np.float32)}

        return {
            # One shared agent network (parameter sharing, the QMIX
            # default) with an agent-id one-hot appended to the obs.
            "q1": dense(self.obs_size + self.n_agents, cfg.hidden),
            "q2": dense(cfg.hidden, self.num_actions),
            # Hypernetworks: global state -> mixer weights (abs => the
            # monotonicity constraint) and biases.
            "hw1": dense(self.state_size, self.n_agents * cfg.mixer_hidden),
            "hb1": dense(self.state_size, cfg.mixer_hidden),
            "hw2": dense(self.state_size, cfg.mixer_hidden),
            "hb2": dense(self.state_size, 1),
        }

    def _loss(self, batch: dict):
        cfg = self.config
        n, M = self.n_agents, cfg.mixer_hidden
        B = batch["obs"].shape[0]
        qs = agent_q(self.params, batch["obs"].reshape(B * n, -1)) \
            .reshape(B, n, -1)
        q_tot = mix(self.params, take(qs, batch["actions"]),
                    batch["state"], n, M)[:, 0]
        with torch.no_grad():
            qs_next = agent_q(self.target,
                              batch["next_obs"].reshape(B * n, -1)) \
                .reshape(B, n, -1)
            q_tot_next = mix(self.target, qs_next.max(-1).values,
                             batch["next_state"], n, M)[:, 0]
            y = batch["reward"] + cfg.gamma * (1.0 - batch["done"]) \
                * q_tot_next
        td = q_tot - y
        return (td * td).mean()

    def update(self, batch: dict):
        """One Adam step of the TD loss on a batch (numpy arrays or
        tensors: obs, actions, state, reward, next_obs, next_state,
        done); returns the loss as a device tensor."""
        with device_context(self.device):
            b = device_batch(batch, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._loss(b)
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def sync_target(self) -> None:
        tree_assign(self.target, self.params)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _obs_of(self, obs: dict, agent: str) -> np.ndarray:
        """Agents already done may be absent from the obs dict (e.g.
        DualCartPole omits them): zeros stand in."""
        v = obs.get(agent)
        if v is None:
            return np.zeros(self.obs_size, np.float32)
        return np.asarray(v, np.float32).reshape(-1)

    def _global_state(self, obs: dict) -> np.ndarray:
        if self._has_global_state:
            return np.asarray(self.env.global_state,
                              np.float32).reshape(-1)
        return np.concatenate([self._obs_of(obs, a)
                               for a in self.env.agent_ids])

    def _aug_obs(self, obs: dict) -> np.ndarray:
        """(n_agents, obs+id) — shared net with agent-id one-hot."""
        rows = []
        for i, a in enumerate(self.env.agent_ids):
            one = np.zeros(self.n_agents, np.float32)
            one[i] = 1.0
            rows.append(np.concatenate([self._obs_of(obs, a), one]))
        return np.stack(rows)

    def agent_q_values(self, aug: np.ndarray) -> np.ndarray:
        """The agents' Q-values for (n_agents, obs + id) rows, a forward
        on the learner's device."""
        with torch.no_grad(), device_context(self.device):
            x = torch.as_tensor(aug).to(self.device)
            return agent_q(self.params, x).cpu().numpy()

    def _act(self, obs: dict, eps: float) -> dict:
        qs = self.agent_q_values(self._aug_obs(obs))
        acts = {}
        for i, a in enumerate(self.env.agent_ids):
            if self.rng.random() < eps:
                acts[a] = int(self.rng.integers(self.num_actions))
            else:
                acts[a] = int(np.argmax(qs[i]))
        return acts

    def _sample_batch(self) -> dict:
        cfg = self.config
        idx = self.rng.integers(0, len(self._buffer), cfg.batch_size)
        cols = list(zip(*[self._buffer[i] for i in idx]))
        return {
            "obs": np.stack(cols[0]),
            "actions": np.stack(cols[1]),
            "state": np.stack(cols[2]),
            "reward": np.asarray(cols[3], np.float32),
            "next_obs": np.stack(cols[4]),
            "next_state": np.stack(cols[5]),
            "done": np.asarray(cols[6], np.float32),
        }

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        eps = self._epsilon()
        team_returns = []
        for ep in range(cfg.episodes_per_iter):
            obs = self.env.reset(seed=cfg.seed + self.iteration * 1000 + ep)
            total = 0.0
            done = False
            while not done:
                state = self._global_state(obs)
                acts = self._act(obs, eps)
                nxt, rew, dones, info = self.env.step(acts)
                next_state = self._global_state(nxt)
                team_r = float(info.get(
                    "team_reward", np.mean(list(rew.values()))))
                done = dones["__all__"]
                self._buffer.append((
                    self._aug_obs(obs),
                    np.asarray([acts[a] for a in self.env.agent_ids],
                               np.int32),
                    state, team_r, self._aug_obs(nxt), next_state,
                    float(done)))
                total += team_r
                self.total_steps += 1
                obs = nxt
            team_returns.append(total)
        max_tr = cfg.buffer_episodes * getattr(self.env, "episode_len", 64)
        self._buffer = self._buffer[-max_tr:]

        losses = []
        if len(self._buffer) >= cfg.batch_size:
            for _ in range(cfg.train_batches):
                losses.append(self.update(self._sample_batch()))
        self.iteration += 1
        if self.iteration % cfg.target_update_freq == 0:
            self.sync_target()
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()
                                  .astype(np.float64))) if losses else 0.0
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(team_returns)),
            "episodes_this_iter": len(team_returns),
            "timesteps_total": self.total_steps,
            "mean_loss": mean_loss,
            "epsilon": round(eps, 3),
            "iter_time_s": round(time.time() - t0, 3),
        }

    def compute_actions(self, obs: dict) -> dict:
        return self._act(obs, eps=0.0)

    def stop(self):
        pass
