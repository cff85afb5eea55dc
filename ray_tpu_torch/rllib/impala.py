"""IMPALA: asynchronous sampling with V-trace off-policy correction.
Port of ray_tpu/rllib/impala.py.

Parity: reference rllib/algorithms/impala/ — rollout actors sample
continuously with a (stale) behavior policy while the learner consumes
whatever trajectories are ready (`ray_tpu_torch.wait`-style async
consumption, reference: impala.py's aggregation of in-flight sample
requests). The staleness gap is corrected by V-trace (Espeholt et al.
2018) importance weights, computed in the learner's step on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.catalog import get_model
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (TorchLearner, init_policy_params,
                                     numpy_forward, stop_actors)


@ray_tpu_torch.remote
class ImpalaRolloutWorker:
    """CPU sampling actor emitting fixed-length trajectory fragments with
    behavior logits (needed for the V-trace importance ratios)."""

    def __init__(self, env_spec, worker_index: int):
        self.env = make_env(env_spec)
        self.index = worker_index
        self.rng = np.random.default_rng(3000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)

    def sample(self, params: dict, num_steps: int) -> dict:
        obs_b, act_b, logp_b, rew_b, done_b = [], [], [], [], []
        episode_returns, ep_ret = [], 0.0
        for _ in range(num_steps):
            logits, _ = numpy_forward(params, self.obs[None, :])
            logits = logits[0]
            p = np.exp(logits - logits.max())
            p /= p.sum()
            action = int(self.rng.choice(len(p), p=p))
            next_obs, reward, done, _ = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            logp_b.append(float(np.log(p[action] + 1e-8)))
            rew_b.append(reward)
            done_b.append(done)
            ep_ret += reward
            if done:
                episode_returns.append(ep_ret)
                ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {
            "obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b, np.int32),
            "behavior_logp": np.asarray(logp_b, np.float32),
            "rewards": np.asarray(rew_b, np.float32),
            "dones": np.asarray(done_b, np.float32),
            "bootstrap_obs": np.asarray(self.obs, np.float32),
            "episode_returns": episode_returns,
        }


@dataclass
class ImpalaConfig:
    """Parity: rllib ImpalaConfig fluent-config object."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 128
    num_fragments_per_iter: int = 4   # learner consumes this many per train()
    gamma: float = 0.99
    vtrace_clip_rho: float = 1.0      # rho-bar: value-target IS clip
    vtrace_clip_c: float = 1.0        # c-bar: trace-cutting IS clip
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 5e-4
    hidden_size: int = 64
    seed: int = 0
    # >1: updates run on a LearnerGroup of remote learner actors, one
    # whole trajectory fragment per learner per step, allreduced
    # gradients (reference: impala's LearnerGroup fan-out).
    num_learners: int = 1

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
                raise ValueError(f"unknown IMPALA option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "Impala":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return Impala(self, device=device)


# PPO's MLP actor-critic over tensors, which the reference's IMPALA, APPO,
# PG and A2C each spell out again.
mlp_forward = get_model("mlp").torch_forward


def vtrace(values, boot_v, rewards, dones, rhos, *, gamma: float,
           clip_rho: float, clip_c: float):
    """V-trace targets and policy-gradient advantages (Espeholt et al.
    2018, eq. 1), both detached as the reference's stop_gradient leaves
    them: vs_t = V(x_t) + sum_k gamma^k c_[t..] delta_k V. The reference's
    reverse lax.scan is a reversed loop over the fragment here."""
    with torch.no_grad():
        values, boot_v, rhos = values.detach(), boot_v.detach(), rhos.detach()
        clipped_rho = torch.clamp(rhos, max=clip_rho)
        clipped_c = torch.clamp(rhos, max=clip_c)
        next_values = torch.cat([values[1:], boot_v[None]]) * (1 - dones)
        deltas = clipped_rho * (rewards + gamma * next_values - values)
        carry = (gamma * (1 - dones)) * clipped_c
        acc = torch.zeros((), dtype=values.dtype, device=values.device)
        advs = [None] * len(deltas)
        for t in range(len(deltas) - 1, -1, -1):
            acc = deltas[t] + carry[t] * acc
            advs[t] = acc
        vs = values + torch.stack(advs)
        next_vs = torch.cat([vs[1:], boot_v[None]]) * (1 - dones)
        pg_adv = clipped_rho * (rewards + gamma * next_vs - values)
    return vs, pg_adv


def make_impala_loss(*, gamma: float, vf_coeff: float, entropy_coeff: float,
                     clip_rho: float, clip_c: float):
    """The V-trace actor-critic loss as a free function, shared by the
    learner in the driver and the LearnerGroup's learner actors (same
    factoring as make_ppo_loss; reference: impala/impala_learner builds
    one loss both local and remote learners run)."""

    def loss_fn(params, batch):
        logits, values = mlp_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        _, boot_v = mlp_forward(params, batch["bootstrap_obs"][None, :])
        rhos = torch.exp(logp - batch["behavior_logp"])
        vs, pg_adv = vtrace(values, boot_v[0], batch["rewards"],
                            batch["dones"], rhos, gamma=gamma,
                            clip_rho=clip_rho, clip_c=clip_c)
        pi_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_rho": rhos.detach().mean()}

    return loss_fn


class Impala:
    """Algorithm driver. Sampling stays in flight across train() calls —
    the learner never waits for ALL workers, only for the next ready
    fragments (the async gap V-trace corrects). The learner runs in the
    driver on `device` (None: the card, raising without one), or with
    num_learners > 1 on a LearnerGroup."""

    def __init__(self, config: ImpalaConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        params = init_policy_params(
            self.obs_size, self.num_actions, config.hidden_size, config.seed)
        self.learner = None
        self._learner_group = None
        self.params = None          # the gang's params, between updates
        if config.num_learners > 1:
            if config.num_fragments_per_iter % config.num_learners:
                # A partial cohort would be silently discarded at the end
                # of every train() — with num_learners > fragments the
                # params would NEVER update.
                raise ValueError(
                    f"num_fragments_per_iter={config.num_fragments_per_iter}"
                    f" must be a multiple of num_learners="
                    f"{config.num_learners}")
            from ray_tpu_torch.rllib.learner_group import LearnerGroup

            self._learner_group = LearnerGroup(
                num_learners=config.num_learners, model="mlp",
                obs_size=self.obs_size, num_actions=self.num_actions,
                hidden=config.hidden_size, lr=config.lr,
                vf_coeff=config.vf_coeff,
                entropy_coeff=config.entropy_coeff, seed=config.seed,
                algo="impala",
                algo_kwargs={"gamma": config.gamma,
                             "clip_rho": config.vtrace_clip_rho,
                             "clip_c": config.vtrace_clip_c},
                device=device)
            self.params = params
        else:
            self.learner = self._make_learner(params, device)
        self.workers = [ImpalaRolloutWorker.remote(config.env, i)
                        for i in range(config.num_rollout_workers)]
        self._inflight: dict = {}   # ref -> worker
        self.iteration = 0
        self.total_steps = 0

    def _make_learner(self, params: dict, device) -> TorchLearner:
        cfg = self.config
        return TorchLearner(params, make_impala_loss(
            gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
            entropy_coeff=cfg.entropy_coeff,
            clip_rho=cfg.vtrace_clip_rho, clip_c=cfg.vtrace_clip_c),
            cfg.lr, device)

    def _host_params(self):
        return self.learner.get_params() if self.learner is not None \
            else self.params

    def _launch(self, worker):
        ref = worker.sample.remote(self._host_params(),
                                   self.config.rollout_fragment_length)
        self._inflight[ref] = worker

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        if self._learner_group is not None:
            self.params = self._learner_group.get_params()
        # Keep every worker busy; collect only the fragments that are ready
        # (workers that aren't done keep running — async by construction).
        for w in self.workers:
            if w not in self._inflight.values():
                self._launch(w)
        episode_returns, last_aux, consumed = [], {}, 0
        gang_batches: list = []
        while consumed < cfg.num_fragments_per_iter:
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=600)
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref)
            self._launch(worker)  # immediately resample with fresh params
            episode_returns += batch.pop("episode_returns")
            if self._learner_group is not None:
                # Whole fragments accumulate until every learner has one,
                # then ONE synchronized allreduced step consumes them
                # (V-trace sequences cannot be row-split across learners).
                gang_batches.append(batch)
                if len(gang_batches) == self._learner_group.num_learners:
                    last_aux = self._learner_group.update_shards(gang_batches)
                    gang_batches = []
                    self.params = self._learner_group.get_params()
            else:
                _loss, last_aux = self.learner.update(batch)
            consumed += 1
            self.total_steps += cfg.rollout_fragment_length
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "timesteps_total": self.total_steps,
            "iter_time_s": round(time.time() - t0, 3),
            **{k: float(v) for k, v in last_aux.items()},
        }

    def stop(self):
        # Drain in-flight samples before killing (avoids error spam).
        for ref in list(self._inflight):
            try:
                ray_tpu_torch.get(ref, timeout=30)
            except Exception:
                pass
        self._inflight.clear()
        if self._learner_group is not None:
            self._learner_group.shutdown()
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self._host_params()

    def compute_single_action(self, obs) -> int:
        logits, _ = numpy_forward(self.get_policy_params(), obs[None, :])
        return int(np.argmax(logits[0]))
