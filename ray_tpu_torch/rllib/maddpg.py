"""MADDPG: multi-agent DDPG with centralized critics. Port of
ray_tpu/rllib/maddpg.py.

Parity: reference rllib/algorithms/maddpg/ (per-agent deterministic
actor over its OWN observation; per-agent critic over ALL observations
and ALL actions — centralized training, decentralized execution; target
networks with polyak averaging; shared replay of joint transitions).
`MADDPGLearner` runs all agents' critic and actor updates on the card.

The reference steps two optax.adam states over the whole tree, one with
the critics' gradients and one with the actors'; each leaves the other
part where it is (a zero gradient with zero moments moves nothing). The
port gives each torch Adam its own part: the critics, and the actors.

Ships CoopNav, the cooperative continuous testbed (two agents on a
line steering to their targets, shared reward) standing in for the
reference's MPE simple_spread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context
from ray_tpu_torch.rllib.ppo import (TorchLearner, adam, device_batch,
                                     stop_actors)
from ray_tpu_torch.rllib.utils import (CPUActor, polyak, tree_copy,
                                       tree_detach, tree_numpy)


def resolve_ma_env(spec):
    """Environment spec -> instance: "CoopNav" (built-in), a class, or a
    zero-arg factory. The env must expose the CoopNav contract
    (n_agents/observation_size/action_size, list-per-agent obs, shared
    scalar reward)."""
    if spec == "CoopNav" or spec is None:
        return CoopNav()
    if callable(spec):
        return spec()
    raise ValueError(f"unsupported multi-agent env spec {spec!r}; pass "
                     "'CoopNav' or an env class/factory")


class CoopNav:
    """Two agents on [-1, 1] each steering to its own target; shared
    reward -(|p0-t0| + |p1-t1|). Obs_i = [own pos, own target, other
    pos, other target]; action_i = velocity in [-1, 1]."""

    n_agents = 2
    observation_size = 4
    action_size = 1
    horizon = 25

    def __init__(self):
        self.rng = np.random.default_rng(0)

    def reset(self, seed: int | None = None) -> list[np.ndarray]:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.pos = self.rng.uniform(-1, 1, 2).astype(np.float32)
        self.targets = self.rng.uniform(-1, 1, 2).astype(np.float32)
        self.t = 0
        return self._obs()

    def _obs(self) -> list[np.ndarray]:
        out = []
        for i in range(2):
            j = 1 - i
            out.append(np.array([self.pos[i], self.targets[i],
                                 self.pos[j], self.targets[j]],
                                np.float32))
        return out

    def step(self, actions: list[float]):
        self.pos = np.clip(
            self.pos + 0.1 * np.clip(np.asarray(actions, np.float32)
                                     .reshape(2), -1, 1), -1, 1)
        self.t += 1
        reward = -float(np.abs(self.pos - self.targets).sum())
        done = self.t >= self.horizon
        # Episodes end ONLY by time limit — flag it so off-policy
        # targets bootstrap through the cut (env.py convention).
        return self._obs(), reward, done, {"truncated": done}


def init_maddpg_params(n_agents: int, obs_size: int, act_size: int,
                       hidden: int = 64, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o))
                      / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    joint = n_agents * (obs_size + act_size)
    agents = []
    for _ in range(n_agents):
        agents.append({
            "actor": {"h": dense(obs_size, hidden),
                      "out": dense(hidden, act_size)},
            "critic": {"h1": dense(joint, hidden),
                       "h2": dense(hidden, hidden),
                       "out": dense(hidden, 1)},
        })
    return {"agents": agents}


def numpy_actor(actor: dict, obs: np.ndarray) -> np.ndarray:
    h = np.tanh(obs @ actor["h"]["w"] + actor["h"]["b"])
    return np.tanh(h @ actor["out"]["w"] + actor["out"]["b"])


def actor_forward(p, obs):
    """numpy_actor on tensors."""
    h = torch.tanh(obs @ p["h"]["w"] + p["h"]["b"])
    return torch.tanh(h @ p["out"]["w"] + p["out"]["b"])


def critic_forward(p, joint):
    h = torch.tanh(joint @ p["h1"]["w"] + p["h1"]["b"])
    h = torch.tanh(h @ p["h2"]["w"] + p["h2"]["b"])
    return (h @ p["out"]["w"] + p["out"]["b"])[:, 0]


def joint_in(obs, acts):
    B = obs.shape[0]
    return torch.cat([obs.reshape(B, -1), acts.reshape(B, -1)], dim=1)


@ray_tpu_torch.remote(num_cpus=1)
class MADDPGRolloutWorker(CPUActor):
    """CPU sampler: decentralized execution — each agent acts from its
    own actor + exploration noise (parity: rollout_worker.py)."""

    def __init__(self, env_spec, worker_index: int):
        super().__init__()
        self.env = resolve_ma_env(env_spec)
        self.rng = np.random.default_rng(5000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.ep_ret = 0.0

    def sample(self, params: dict, num_steps: int, noise: float) -> dict:
        n = self.env.n_agents
        buf = {"obs": [], "actions": [], "rewards": [], "next_obs": [],
               "dones": []}
        episode_returns = []
        for _ in range(num_steps):
            acts = []
            for i in range(n):
                a = numpy_actor(params["agents"][i]["actor"],
                                self.obs[i][None, :])[0]
                a = np.clip(a + noise * self.rng.standard_normal(a.shape),
                            -1, 1)
                acts.append(a.astype(np.float32))
            next_obs, reward, done, info = self.env.step(
                [float(a[0]) for a in acts])
            buf["obs"].append(np.stack(self.obs))
            buf["actions"].append(np.stack(acts))
            buf["rewards"].append(reward)
            buf["next_obs"].append(np.stack(next_obs))
            # Time-limit cuts bootstrap through (env.py convention).
            buf["dones"].append(float(bool(done)
                                and not info.get("truncated", False)))
            self.ep_ret += reward
            if done:
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {k: np.asarray(v, np.float32) for k, v in buf.items()} | {
            "episode_returns": episode_returns}


@dataclass
class MADDPGConfig:
    """Parity: rllib MADDPGConfig."""

    env: Any = "CoopNav"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    buffer_capacity: int = 50_000
    train_batch_size: int = 128
    num_sgd_iter: int = 16
    gamma: float = 0.95
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    tau: float = 0.02  # polyak
    hidden_size: int = 64
    exploration_noise: float = 0.3
    noise_decay_iters: int = 20
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
                raise ValueError(f"unknown MADDPG option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "MADDPG":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return MADDPG(self, device=device)


class MADDPGLearner(TorchLearner):
    """MADDPG's learner on one device: every agent's actor and critic as
    one params tree ({"agents": [...]}), its target copy, one Adam over
    the critics (critic_lr, `optimizer`) and one over the actors
    (actor_lr, `actor_optimizer`). An update steps the critics, then the
    actors against the new critics, then Polyak-averages the targets."""

    def __init__(self, config: MADDPGConfig, n_agents: int, obs_size: int,
                 act_size: int, *, params: dict | None = None, device=None):
        self.config = config
        self.n_agents = n_agents
        if params is None:
            params = init_maddpg_params(n_agents, obs_size, act_size,
                                        config.hidden_size, config.seed)
        super().__init__(params, None, config.critic_lr, device)
        agents = self.params["agents"]
        self.critics = {"agents": [{"critic": a["critic"]} for a in agents]}
        self.actors = {"agents": [{"actor": a["actor"]} for a in agents]}
        self.optimizer = adam(self.critics, config.critic_lr)
        self.actor_optimizer = adam(self.actors, config.actor_lr)
        self.target = tree_copy(self.params)

    def _critic_loss(self, batch):
        cfg, n = self.config, self.n_agents
        agents, target = self.params["agents"], self.target["agents"]
        with torch.no_grad():
            # Centralized TD target: all target actors act on next obs.
            next_acts = torch.stack(
                [actor_forward(target[i]["actor"], batch["next_obs"][:, i])
                 for i in range(n)], dim=1)
            next_joint = joint_in(batch["next_obs"], next_acts)
        joint = joint_in(batch["obs"], batch["actions"])
        total = 0.0
        for i in range(n):
            with torch.no_grad():
                q_next = critic_forward(target[i]["critic"], next_joint)
                y = batch["rewards"] + cfg.gamma * \
                    (1.0 - batch["dones"]) * q_next
            q = critic_forward(agents[i]["critic"], joint)
            total = total + torch.mean((q - y) ** 2)
        return total

    def _actor_loss(self, batch):
        # Each agent maximizes ITS centralized critic with its own action
        # re-derived from its actor, others' from replay.
        total = 0.0
        for i, agent in enumerate(self.params["agents"]):
            my_act = actor_forward(agent["actor"], batch["obs"][:, i])
            acts = batch["actions"].clone()
            acts[:, i] = my_act
            q = critic_forward(tree_detach(agent["critic"]),
                               joint_in(batch["obs"], acts))
            total = total - torch.mean(q)
        return total

    def update(self, minibatch: dict):
        """One critic step, one actor step, the targets' Polyak update.
        Returns (critic loss, actor loss) as device tensors."""
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            closs = self._critic_loss(batch)
            closs.backward()
            self.optimizer.step()
            self.actor_optimizer.zero_grad(set_to_none=True)
            aloss = self._actor_loss(batch)
            aloss.backward()
            self.actor_optimizer.step()
            polyak(self.target, self.params, self.config.tau)
        self.updates += 1
        return closs.detach(), aloss.detach()


class MADDPG:
    """Algorithm driver (parity: Algorithm.step / MADDPG training_step).
    The learner is made before the rollout workers."""

    def __init__(self, config: MADDPGConfig, device=None):
        self.config = config
        env = resolve_ma_env(config.env)
        self.n_agents = env.n_agents
        self.obs_size = env.observation_size
        self.act_size = env.action_size
        self.learner = MADDPGLearner(config, self.n_agents, self.obs_size,
                                     self.act_size, device=device)
        cap = config.buffer_capacity
        self.buf = {
            "obs": np.zeros((cap, self.n_agents, self.obs_size),
                            np.float32),
            "actions": np.zeros((cap, self.n_agents, self.act_size),
                                np.float32),
            "rewards": np.zeros(cap, np.float32),
            "next_obs": np.zeros((cap, self.n_agents, self.obs_size),
                                 np.float32),
            "dones": np.zeros(cap, np.float32),
        }
        self.buf_pos = 0
        self.buf_size = 0
        self.rng = np.random.default_rng(config.seed)
        self.workers = [MADDPGRolloutWorker.remote(config.env, i)
                        for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def _add(self, batch: dict) -> None:
        n = len(batch["obs"])
        cap = self.config.buffer_capacity
        idx = (self.buf_pos + np.arange(n)) % cap
        for k in self.buf:
            self.buf[k][idx] = batch[k]
        self.buf_pos = int((self.buf_pos + n) % cap)
        self.buf_size = int(min(self.buf_size + n, cap))

    def _sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self.buf_size, batch_size)
        return {k: v[idx] for k, v in self.buf.items()}

    def train(self) -> dict:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.noise_decay_iters))
        noise = cfg.exploration_noise * (1.0 - 0.9 * frac)
        rollout_params = tree_numpy(self.learner.params)
        outs = ray_tpu_torch.get([
            w.sample.remote(rollout_params, cfg.rollout_fragment_length,
                            noise) for w in self.workers])
        returns = []
        for out in outs:
            self._add(out)
            returns += out["episode_returns"]
            self.total_steps += len(out["obs"])
        closses = []
        if self.buf_size >= cfg.train_batch_size:
            for _ in range(cfg.num_sgd_iter):
                closs, _aloss = self.learner.update(
                    self._sample(cfg.train_batch_size))
                closses.append(closs)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "episode_reward_mean":
                    float(np.mean(returns)) if returns else float("nan"),
                "num_env_steps_sampled": self.total_steps,
                "critic_loss": float(np.mean(torch.stack(closses).tolist()))
                if closses else None}

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()
