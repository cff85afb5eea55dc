"""SimpleQ and Ape-X DQN: the two ends of the Q-learning family. Port of
ray_tpu/rllib/simple_q.py.

Parity: reference rllib/algorithms/simple_q/ (vanilla Q-learning —
uniform replay, no double-Q, periodic hard target sync) and
rllib/algorithms/apex_dqn/ (Ape-X — MANY rollout workers with a
per-worker epsilon ladder feeding a shared prioritized replay buffer
asynchronously; the learner consumes batches as they arrive instead of
lock-stepping with sampling, through ray_tpu_torch.wait).

Both reuse the DQN machinery (models, rollout workers, the learner on
the card); what differs is the replay/synchronization topology — which
in this runtime is exactly the actor topology, so each variant is a
short driver.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner, huber
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer


@dataclass
class SimpleQConfig(DQNConfig):
    """Vanilla Q-learning (the reference's relationship is mirrored:
    there DQN extends SimpleQ; here SimpleQ restricts DQN)."""

    double_q: bool = False
    num_sgd_iter: int = 8

    def build(self, device=None) -> "SimpleQ":  # type: ignore[override]
        return SimpleQ(self, device=device)


class SimpleQ(DQN):
    """DQN driver with the vanilla loss (no double-Q selection)."""


@dataclass
class ApexDQNConfig(DQNConfig):
    """Ape-X: async sampling + prioritized replay (reference:
    apex_dqn.py; the epsilon ladder is per-worker and constant,
    eps_i = base ** (1 + i/(n-1) * alpha) — exploration diversity comes
    from the ladder, not a schedule)."""

    num_rollout_workers: int = 4
    buffer_capacity: int = 100_000
    per_alpha: float = 0.6
    per_beta: float = 0.4
    epsilon_base: float = 0.4
    epsilon_alpha: float = 7.0
    # learner sgd steps per arriving rollout batch
    sgd_steps_per_batch: int = 8
    batches_per_iter: int = 8

    def build(self, device=None) -> "ApexDQN":  # type: ignore[override]
        return ApexDQN(self, device=device)


class ApexLearner(DQNLearner):
    """Ape-X's update: the IS-weighted Huber loss of the double-Q TD
    error, which it also returns (aux "td_error": the new priorities)."""

    def _loss(self, params, batch):
        td = self.td_error(params, batch, double_q=True)
        return (batch["weights"] * huber(td)).mean(), {"td_error": td}


class ApexDQN(DQN):
    def __init__(self, config: ApexDQNConfig, device=None):
        super().__init__(config, device=device)
        n = max(1, config.num_rollout_workers)
        self._epsilons = [
            config.epsilon_base ** (1 + i / max(1, n - 1) *
                                    config.epsilon_alpha)
            for i in range(n)]
        self._inflight: dict = {}

    def _make_learner(self, device):
        return ApexLearner(self.config, self.obs_size, self.num_actions,
                           device=device)

    def _make_buffer(self):
        # Prioritized buffer replaces the uniform one.
        cfg = self.config
        return PrioritizedReplayBuffer(
            cfg.buffer_capacity, self.obs_size, cfg.seed,
            alpha=cfg.per_alpha, beta=cfg.per_beta)

    def _launch(self, i: int, host_params):
        fut = self.workers[i].sample.remote(
            host_params, self.config.rollout_fragment_length,
            self._epsilons[i])
        self._inflight[fut] = i

    def _sgd_step(self, sample: dict) -> dict:
        batch = {k: v for k, v in sample.items() if k != "indices"}
        loss, aux = self.learner.update(batch)
        return {"loss": float(loss), "td_error": aux["td_error"].cpu().numpy()}

    def train(self) -> dict:
        cfg: ApexDQNConfig = self.config  # type: ignore[assignment]
        t0 = time.time()
        host_params = self.learner.get_params()
        for i in range(len(self.workers)):
            if i not in self._inflight.values():
                self._launch(i, host_params)

        episode_returns: list = []
        losses: list = []
        consumed = 0
        while consumed < cfg.batches_per_iter:
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=600)
            fut = ready[0]
            i = self._inflight.pop(fut)
            batch = ray_tpu_torch.get(fut, timeout=60)
            episode_returns.extend(batch.pop("episode_returns", []))
            self.buffer.add_batch(batch)
            self.total_steps += len(batch["obs"])
            consumed += 1
            # Relaunch immediately with fresh weights: sampling never
            # blocks on learning (the Ape-X point).
            host_params = self.learner.get_params()
            self._launch(i, host_params)
            if self.buffer.size >= max(cfg.train_batch_size,
                                       cfg.learning_starts):
                for _ in range(cfg.sgd_steps_per_batch):
                    sample = self.buffer.sample(cfg.train_batch_size)
                    out = self._sgd_step(sample)
                    losses.append(out["loss"])
                    self.buffer.update_priorities(
                        sample["indices"], np.abs(out["td_error"]))
        self.iteration += 1
        self._sync_if_due()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else 0.0,
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": cfg.batches_per_iter
            * cfg.rollout_fragment_length,
            "timesteps_total": self.total_steps,
            "mean_loss": float(np.mean(losses)) if losses else 0.0,
            "iter_time_s": round(time.time() - t0, 3),
        }
