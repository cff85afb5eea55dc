"""SAC: soft actor-critic for continuous control. Port of
ray_tpu/rllib/sac.py.

Parity: reference rllib/algorithms/sac/ (torch learner + replay) rebuilt
on the rollout/learner split — numpy Gaussian-policy rollout actors feed
a replay buffer; `SACLearner` runs the twin-Q soft-Bellman update with
automatic entropy-temperature tuning on the card.

The reference draws the reparameterised normals with jax.random inside
its jitted update; the port's update takes them as arguments (drawn by
`train` from a torch.Generator on the learner's device seeded from
config.seed). The reference keeps the temperature's log as a Python
float between iterations; the port keeps it as an f32 tensor with its
own Adam, the same values (an f32 read back as a float is exact).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context
from ray_tpu_torch.rllib.ddpg import mlp, q_val
from ray_tpu_torch.rllib.dqn import ReplayBuffer
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import TorchLearner, device_batch, stop_actors
from ray_tpu_torch.rllib.utils import CPUActor, polyak, tree_copy, tree_detach

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_sac_params(obs_size: int, act_size: int, hidden: int = 64,
                    seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    def q_net():
        return {"h1": dense(obs_size + act_size, hidden),
                "h2": dense(hidden, hidden), "out": dense(hidden, 1)}

    return {
        "pi": {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
               "mu": dense(hidden, act_size), "log_std": dense(hidden, act_size)},
        "q1": q_net(),
        "q2": q_net(),
    }


def numpy_policy(params: dict, obs: np.ndarray):
    """Gaussian policy forward (rollout side): returns (mu, log_std)."""
    pi = params["pi"]
    h = np.tanh(obs @ pi["h1"]["w"] + pi["h1"]["b"])
    h = np.tanh(h @ pi["h2"]["w"] + pi["h2"]["b"])
    mu = h @ pi["mu"]["w"] + pi["mu"]["b"]
    log_std = np.clip(h @ pi["log_std"]["w"] + pi["log_std"]["b"],
                      LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def pi_sample(pi, obs, eps):
    """The squashed Gaussian's reparameterised action for standard
    normals `eps`, and its log-probability with the tanh correction."""
    h = mlp(pi, obs)
    mu = h @ pi["mu"]["w"] + pi["mu"]["b"]
    log_std = torch.clamp(h @ pi["log_std"]["w"] + pi["log_std"]["b"],
                          LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    act = torch.tanh(mu + std * eps)
    logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(1 - act ** 2 + 1e-6).sum(-1)
    return act, logp


@ray_tpu_torch.remote(num_cpus=1)
class SACRolloutWorker(CPUActor):
    """CPU sampling actor with a squashed-Gaussian exploration policy."""

    def __init__(self, env_spec, worker_index: int):
        super().__init__()
        self.env = make_env(env_spec)
        self.index = worker_index
        self.rng = np.random.default_rng(2000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.scale = (self.env.action_high - self.env.action_low) / 2.0
        self.mid = (self.env.action_high + self.env.action_low) / 2.0

    def sample(self, params: dict, num_steps: int, random_policy: bool = False
               ) -> dict:
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        episode_returns, ep_ret = [], 0.0
        for _ in range(num_steps):
            if random_policy:
                a = self.rng.uniform(-1.0, 1.0, self.env.action_size)
            else:
                mu, log_std = numpy_policy(params, self.obs[None, :])
                a = np.tanh(mu[0] + np.exp(log_std[0])
                            * self.rng.standard_normal(mu.shape[1]))
            env_action = self.mid + self.scale * a
            next_obs, reward, done, info = self.env.step(env_action)
            obs_b.append(self.obs)
            act_b.append(a.astype(np.float32))
            rew_b.append(reward)
            next_b.append(next_obs)
            # True terminals block bootstrapping; time-limit truncations
            # (info["truncated"], e.g. every Pendulum episode) bootstrap
            # through the cut.
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
class SACConfig:
    """Parity: rllib SACConfig fluent-config object."""

    env: Any = "Pendulum-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    train_batch_size: int = 256
    num_updates_per_iter: int = 64
    replay_buffer_capacity: int = 100_000
    learning_starts: int = 500
    gamma: float = 0.99
    tau: float = 0.005               # polyak averaging for target nets
    lr: float = 3e-4
    initial_alpha: float = 0.1
    autotune_alpha: bool = True
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
                raise ValueError(f"unknown SAC option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "SAC":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return SAC(self, device=device)


class SACLearner(TorchLearner):
    """SAC's learner on one device: the policy and twin critics as one
    params tree with one Adam, the critics' targets, and the temperature's
    log (`log_alpha`, an f32 scalar) with an Adam of its own.
    update(batch, eps_target, eps_actor): the standard normals of the
    policy's draws at next_obs (the soft target) and at obs (the actor
    loss), each shaped like the actions."""

    def __init__(self, config: SACConfig, obs_size: int, act_size: int, *,
                 params: dict | None = None, device=None):
        self.config = config
        self.act_size = act_size
        if params is None:
            params = init_sac_params(obs_size, act_size, config.hidden_size,
                                     config.seed)
        super().__init__(params, None, config.lr, device)
        self.target = tree_copy({"q1": self.params["q1"],
                                 "q2": self.params["q2"]})
        self.log_alpha = torch.tensor(np.log(config.initial_alpha),
                                      dtype=torch.float32, device=self.device,
                                      requires_grad=True)
        self.alpha_optimizer = torch.optim.Adam(
            [self.log_alpha], lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)

    def draw_noise(self, batch_size: int) -> tuple:
        """One update's (eps_target, eps_actor) from the generator."""
        return tuple(torch.randn((batch_size, self.act_size),
                                 generator=self._gen, device=self.device)
                     for _ in range(2))

    def update(self, minibatch: dict, eps_target, eps_actor) -> dict:
        """One step of the critics and the policy (one Adam over the
        tree), then of the temperature, then the critics' Polyak targets.
        Returns the reference's metrics as device tensors."""
        cfg, p = self.config, self.params
        target_entropy = -float(self.act_size)
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            eps_t = torch.as_tensor(eps_target).to(self.device)
            eps_a = torch.as_tensor(eps_actor).to(self.device)
            alpha = torch.exp(self.log_alpha.detach())
            self.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                # Soft Bellman target from the TARGET twin-Q.
                next_act, next_logp = pi_sample(p["pi"], batch["next_obs"],
                                                eps_t)
                tq = torch.minimum(
                    q_val(self.target["q1"], batch["next_obs"], next_act),
                    q_val(self.target["q2"], batch["next_obs"], next_act))
                y = batch["rewards"] + cfg.gamma * (1 - batch["dones"]) * (
                    tq - alpha * next_logp)
            l1 = ((q_val(p["q1"], batch["obs"], batch["actions"]) - y) ** 2
                  ).mean()
            l2 = ((q_val(p["q2"], batch["obs"], batch["actions"]) - y) ** 2
                  ).mean()
            closs = l1 + l2
            act, logp = pi_sample(p["pi"], batch["obs"], eps_a)
            q1, q2 = tree_detach(p["q1"]), tree_detach(p["q2"])
            q = torch.minimum(q_val(q1, batch["obs"], act),
                              q_val(q2, batch["obs"], act))
            aloss = (alpha * logp - q).mean()
            # Critic grads touch q1/q2, actor grads touch pi.
            (closs + aloss).backward()
            self.optimizer.step()
            if cfg.autotune_alpha:
                self.alpha_optimizer.zero_grad(set_to_none=True)
                alpha_loss = -(torch.exp(self.log_alpha) * (
                    logp.detach() + target_entropy)).mean()
                alpha_loss.backward()
                self.alpha_optimizer.step()
            polyak(self.target, {"q1": p["q1"], "q2": p["q2"]}, cfg.tau)
        self.updates += 1
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "alpha": alpha, "entropy": -logp.detach().mean()}


class SAC:
    """Algorithm driver (parity: Algorithm.step / SAC training_step). The
    learner is made before the rollout workers."""

    def __init__(self, config: SACConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        if getattr(probe, "action_size", 0) < 1:
            raise ValueError("SAC needs a continuous-action env "
                             "(action_size >= 1)")
        self.obs_size = probe.observation_size
        self.act_size = probe.action_size
        self.learner = SACLearner(config, self.obs_size, self.act_size,
                                  device=device)
        self.buffer = ReplayBuffer(config.replay_buffer_capacity,
                                   self.obs_size, seed=config.seed,
                                   action_shape=(self.act_size,),
                                   action_dtype=np.float32)
        self.workers = [SACRolloutWorker.remote(config.env, i)
                        for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    @property
    def log_alpha(self) -> float:
        return float(self.learner.log_alpha)

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
                metrics = self.learner.update(
                    batch, *self.learner.draw_noise(cfg.train_batch_size))
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
        mu, _ = numpy_policy(self.get_policy_params(), obs[None, :])
        env = make_env(self.config.env)
        scale = (env.action_high - env.action_low) / 2.0
        mid = (env.action_high + env.action_low) / 2.0
        return mid + scale * np.tanh(mu[0])
