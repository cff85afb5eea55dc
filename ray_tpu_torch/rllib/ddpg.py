"""TD3 / DDPG: deterministic-policy continuous control. Port of
ray_tpu/rllib/ddpg.py.

Parity: reference rllib/algorithms/td3/ and /ddpg/ rebuilt on the
rollout/learner split — numpy deterministic-policy rollout actors with
Gaussian exploration noise feed a replay buffer; `TD3Learner` runs the
(twin-)Q Bellman update and the delayed deterministic policy-gradient
step on the card. DDPG is TD3 with twin_q=False, policy_delay=1 and no
target-policy smoothing — one implementation, two algorithm names, the
reference's own lineage.

The reference draws the target-smoothing noise with jax.random inside
its jitted update; the port's update takes the normals as an argument
(drawn by `train` from a torch.Generator on the learner's device seeded
from config.seed). On a critic-only step the reference still takes one
Adam step over the whole tree with zero actor gradients, so the actor
moves by its decayed first moment: the port gives the actor zero
gradients there (torch's Adam would skip a parameter whose .grad is
None).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context
from ray_tpu_torch.rllib.dqn import ReplayBuffer
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (TorchLearner, device_batch, fill_grads,
                                     stop_actors)
from ray_tpu_torch.rllib.utils import (CPUActor, leaves, polyak, tree_copy,
                                       tree_detach)


def init_td3_params(obs_size: int, act_size: int, hidden: int = 64,
                    seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    def q_net():
        return {"h1": dense(obs_size + act_size, hidden),
                "h2": dense(hidden, hidden), "out": dense(hidden, 1)}

    return {
        "pi": {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
               "mu": dense(hidden, act_size)},
        "q1": q_net(),
        "q2": q_net(),
    }


def numpy_actor(params: dict, obs: np.ndarray) -> np.ndarray:
    pi = params["pi"]
    h = np.tanh(obs @ pi["h1"]["w"] + pi["h1"]["b"])
    h = np.tanh(h @ pi["h2"]["w"] + pi["h2"]["b"])
    return np.tanh(h @ pi["mu"]["w"] + pi["mu"]["b"])


def mlp(net, x):
    """The two tanh layers every actor and critic here starts with."""
    h = torch.tanh(x @ net["h1"]["w"] + net["h1"]["b"])
    return torch.tanh(h @ net["h2"]["w"] + net["h2"]["b"])


def q_val(net, obs, act):
    h = mlp(net, torch.cat([obs, act], -1))
    return (h @ net["out"]["w"] + net["out"]["b"])[..., 0]


def actor(pi, obs):
    return torch.tanh(mlp(pi, obs) @ pi["mu"]["w"] + pi["mu"]["b"])


@ray_tpu_torch.remote(num_cpus=1)
class TD3RolloutWorker(CPUActor):
    """CPU sampling actor: deterministic policy + exploration noise."""

    def __init__(self, env_spec, worker_index: int, explore_noise: float):
        super().__init__()
        self.env = make_env(env_spec)
        self.index = worker_index
        self.noise = explore_noise
        self.rng = np.random.default_rng(3000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.scale = (self.env.action_high - self.env.action_low) / 2.0
        self.mid = (self.env.action_high + self.env.action_low) / 2.0

    def sample(self, params: dict, num_steps: int,
               random_policy: bool = False) -> dict:
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        episode_returns, ep_ret = [], 0.0
        for _ in range(num_steps):
            if random_policy:
                a = self.rng.uniform(-1.0, 1.0, self.env.action_size)
            else:
                a = numpy_actor(params, self.obs[None, :])[0]
                a = np.clip(a + self.noise
                            * self.rng.standard_normal(a.shape), -1.0, 1.0)
            next_obs, reward, done, info = self.env.step(
                self.mid + self.scale * a)
            obs_b.append(self.obs)
            act_b.append(a.astype(np.float32))
            rew_b.append(reward)
            next_b.append(next_obs)
            # True terminals block bootstrapping; time-limit truncations
            # (info["truncated"]) still bootstrap through the cut.
            done_b.append(bool(done) and not info.get("truncated", False))
            ep_ret += reward
            if done:
                episode_returns.append(ep_ret)
                ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {
            "obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b, np.float32),
            "rewards": np.asarray(rew_b, np.float32),
            "next_obs": np.asarray(next_b, np.float32),
            "dones": np.asarray(done_b, np.float32),
            "episode_returns": episode_returns,
        }


@dataclass
class TD3Config:
    """Parity: rllib TD3Config fluent-config object."""

    env: Any = "Pendulum-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    train_batch_size: int = 256
    num_updates_per_iter: int = 64
    replay_buffer_capacity: int = 100_000
    learning_starts: int = 500
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    explore_noise: float = 0.1
    # TD3 tricks; DDPGConfig flips them off.
    twin_q: bool = True
    policy_delay: int = 2
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
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
                raise ValueError(f"unknown TD3/DDPG option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "TD3":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return TD3(self, device=device)


@dataclass
class DDPGConfig(TD3Config):
    """DDPG = TD3 minus the three addressing tricks."""

    twin_q: bool = False
    policy_delay: int = 1
    target_noise: float = 0.0

    def build(self, device=None) -> "TD3":
        return TD3(self, device=device)


class TD3Learner(TorchLearner):
    """TD3's (and DDPG's) learner on one device: the actor and twin
    critics as one params tree with one Adam, and a target copy of the
    whole tree. update(batch, noise, do_policy): `noise` the target
    smoothing's standard normals shaped like the actions (None when
    config.target_noise is 0); the actor and the targets move only when
    do_policy."""

    def __init__(self, config: TD3Config, obs_size: int, act_size: int, *,
                 params: dict | None = None, device=None):
        self.config = config
        self.act_size = act_size
        if params is None:
            params = init_td3_params(obs_size, act_size, config.hidden_size,
                                     config.seed)
        super().__init__(params, None, config.lr, device)
        self.target = tree_copy(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)

    def draw_noise(self, batch_size: int):
        """One update's target-smoothing normals (None without the
        smoothing trick)."""
        if self.config.target_noise <= 0:
            return None
        return torch.randn((batch_size, self.act_size), generator=self._gen,
                           device=self.device)

    def update(self, minibatch: dict, noise, do_policy: bool) -> dict:
        """One Adam step over the whole tree. Returns the critic and actor
        losses as device tensors."""
        cfg, p = self.config, self.params
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                # Target action with clipped smoothing noise (TD3 trick #3).
                next_a = actor(self.target["pi"], batch["next_obs"])
                if cfg.target_noise > 0:
                    eps = torch.clamp(
                        cfg.target_noise * torch.as_tensor(noise).to(
                            self.device), -cfg.target_noise_clip,
                        cfg.target_noise_clip)
                    next_a = torch.clamp(next_a + eps, -1.0, 1.0)
                tq = q_val(self.target["q1"], batch["next_obs"], next_a)
                if cfg.twin_q:  # TD3 trick #1: clipped double-Q
                    tq = torch.minimum(tq, q_val(self.target["q2"],
                                                 batch["next_obs"], next_a))
                y = batch["rewards"] + cfg.gamma * (1 - batch["dones"]) * tq
            closs = ((q_val(p["q1"], batch["obs"], batch["actions"]) - y)
                     ** 2).mean()
            if cfg.twin_q:
                closs = closs + ((q_val(p["q2"], batch["obs"],
                                        batch["actions"]) - y) ** 2).mean()
            a = actor(p["pi"], batch["obs"])
            aloss = -q_val(tree_detach(p["q1"]), batch["obs"], a).mean()
            # The critic loss reaches only q1/q2 and the actor loss only
            # pi, so one backward gives each part its own gradient.
            (closs + aloss).backward()
            if not do_policy:
                # Delayed policy update (TD3 trick #2): a critic-only
                # step still steps the actor's Adam, with zero gradients.
                for t in leaves(p["pi"]):
                    t.grad = None
            fill_grads(p)
            self.optimizer.step()
            if do_policy:
                polyak(self.target, p, cfg.tau)
        self.updates += 1
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}


class TD3:
    """Algorithm driver (parity: Algorithm.step for TD3/DDPG). The learner
    is made before the rollout workers."""

    def __init__(self, config: TD3Config, device=None):
        self.config = config
        probe = make_env(config.env)
        if getattr(probe, "action_size", 0) < 1:
            raise ValueError("TD3/DDPG needs a continuous-action env")
        self.obs_size = probe.observation_size
        self.act_size = probe.action_size
        self._action_mid = (probe.action_high + probe.action_low) / 2.0
        self._action_scale = (probe.action_high - probe.action_low) / 2.0
        self.learner = TD3Learner(config, self.obs_size, self.act_size,
                                  device=device)
        self.buffer = ReplayBuffer(config.replay_buffer_capacity,
                                   self.obs_size, seed=config.seed,
                                   action_shape=(self.act_size,),
                                   action_dtype=np.float32)
        self.workers = [
            TD3RolloutWorker.remote(config.env, i, config.explore_noise)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0
        self._update_calls = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        host = self.learner.get_params()
        random_phase = self.total_steps < cfg.learning_starts
        batches = ray_tpu_torch.get(
            [w.sample.remote(host, cfg.rollout_fragment_length, random_phase)
             for w in self.workers], timeout=600)
        episode_returns = []
        for b in batches:
            episode_returns += b.pop("episode_returns")
            self.buffer.add_batch(b)
            self.total_steps += len(b["obs"])
        sample_time = time.time() - t0

        t1 = time.time()
        metrics = {}
        if self.total_steps >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                self._update_calls += 1
                do_policy = (self._update_calls % cfg.policy_delay) == 0
                metrics = self.learner.update(
                    batch, self.learner.draw_noise(cfg.train_batch_size),
                    do_policy)
        metrics = {k: float(v) for k, v in metrics.items()}
        learn_time = time.time() - t1
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "timesteps_total": self.total_steps,
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
            **metrics,
        }

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()

    def compute_single_action(self, obs) -> np.ndarray:
        a = numpy_actor(self.get_policy_params(), obs[None, :])[0]
        return self._action_mid + self._action_scale * a


DDPG = TD3  # algorithm alias: construct via DDPGConfig
